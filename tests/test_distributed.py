"""Multi-host bring-up: 2 jax.distributed CPU processes counting disjoint
read slices into one global ShardedCountStore (BASELINE.md scaling row).

Each subprocess owns 4 virtual CPU devices; the 8-shard mesh spans both.
The spectrum from the distributed run must equal the single-process one.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
coord, pid = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, {repo!r})
from kmer_hasher_tpu.parallel.distributed import init_distributed, host_read_slice
info = init_distributed(coord, num_processes=2, process_id=pid)
assert info["process_count"] == 2, info
assert info["global_devices"] == 8, info

import numpy as np
from jax.sharding import Mesh
from kmer_hasher_tpu.parallel.sharded import ShardedCountStore
from kmer_hasher_tpu.io import read_fastx
from kmer_hasher_tpu.ops import encode as enc

k = 11
recs = read_fastx({fq!r}, 64)
sl = host_read_slice(len(recs))  # this process's slice of the input
mine = recs[sl]
D_local = len(jax.local_devices())
mesh = Mesh(np.asarray(jax.devices()), ("shards",))
store = ShardedCountStore(k, mesh, counts_n=1)

# encode this host's reads into D_local rows
L = 256
seq = np.full((D_local, 32 * L), ord("N"), np.uint8)
row = np.zeros(D_local, np.int64)
for i, (_n, s, _q) in enumerate(mine):
    d = i % D_local
    s = s[:L]
    seq[d, row[d]:row[d] + len(s)] = np.frombuffer(s, np.uint8)
    row[d] += len(s) + 1  # N separator between reads
hi, lo, valid = enc.encode_stream(seq, k, np.full(D_local, 32 * L, np.int64),
                                  canonical=True,
                                  drop_trailing_exact_k=False)
store.add_batch(np.asarray(hi), np.asarray(lo), np.asarray(valid))
spec = store.spectrum(50)
if pid == 0:
    print("SPECTRUM " + json.dumps(spec.tolist()))
print("WORKER_OK", pid)
"""


def _run_two_workers(tmp_path, body: str, name: str = "worker.py",
                     timeout: int = 240):
    """Launch 2 jax.distributed CPU worker subprocesses running ``body``
    (already .format()-ed) and return process 0's stdout lines. Every
    worker must print WORKER_OK and exit 0."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coord = f"localhost:{port}"
    script = tmp_path / name
    script.write_text(body)
    env = {**os.environ,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu"}
    procs = [
        subprocess.Popen([sys.executable, str(script), coord, str(i)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         env=env)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed workers timed out")
        outs.append((p.returncode, out.decode(), err.decode()))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{out}\n{err[-2000:]}"
        assert "WORKER_OK" in out
    return outs[0][1].splitlines()


def _line_json(lines, tag: str):
    return json.loads(next(ln for ln in lines
                           if ln.startswith(tag + " ")).split(" ", 1)[1])


def test_two_process_distributed_counting(ref, tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lines = _run_two_workers(
        tmp_path, WORKER.format(repo=repo, fq=str(ref / "test.fastq.gz")))
    dist_spec = np.asarray(_line_json(lines, "SPECTRUM"))

    # single-process reference: same reads, same row layout, one process
    import jax
    from jax.sharding import Mesh

    from kmer_hasher_tpu.io import read_fastx
    from kmer_hasher_tpu.ops import encode as enc
    from kmer_hasher_tpu.parallel.sharded import ShardedCountStore

    k = 11
    recs = read_fastx(str(ref / "test.fastq.gz"), 64)
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("shards",))
    store = ShardedCountStore(k, mesh, counts_n=1)
    L = 256
    # reproduce the workers' per-process layout: 2 processes x 4 rows
    seq = np.full((8, 32 * L), ord("N"), np.uint8)
    row = np.zeros(8, np.int64)
    halves = [recs[:32], recs[32:]]
    for p, half in enumerate(halves):
        for i, (_n, s, _q) in enumerate(half):
            d = p * 4 + i % 4
            s = s[:L]
            seq[d, row[d]:row[d] + len(s)] = np.frombuffer(s, np.uint8)
            row[d] += len(s) + 1
    hi, lo, valid = enc.encode_stream(seq, k, np.full(8, 32 * L, np.int64),
                                      canonical=True,
                                      drop_trailing_exact_k=False)
    store.add_batch(np.asarray(hi), np.asarray(lo), np.asarray(valid))
    np.testing.assert_array_equal(dist_spec, store.spectrum(50))


HIGH_LEVEL_WORKER = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
coord, pid = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, {repo!r})
from kmer_hasher_tpu.parallel.distributed import init_distributed
init_distributed(coord, num_processes=2, process_id=pid)

import numpy as np
from jax.sharding import Mesh
from kmer_hasher_tpu.counting import count_kmers_fq_sh_rp

mesh = Mesh(np.asarray(jax.devices()), ("shards",))
store = count_kmers_fq_sh_rp({fq!r}, 11, min_q=20, max_reads=64,
                             mesh=mesh)
spec = store.spectrum(50)  # collective: every process participates
# multi-process checkpoint round-trip: save (process 0 writes), restore on
# the same mesh, spectra must match bitwise
import tempfile, os
from kmer_hasher_tpu.utils import checkpoint as ckpt
path = os.path.join(tempfile.gettempdir(), "kmh_dist_ckpt_test.npz")
ckpt.save_count_store(store, path)
from jax.experimental import multihost_utils
multihost_utils.sync_global_devices("ckpt_written")  # 0 wrote the file
restored = ckpt.load_count_store(path, mesh=mesh)
rspec = restored.spectrum(50)
assert (rspec == spec).all(), "checkpoint round-trip spectrum mismatch"
if pid == 0:
    os.unlink(path)
    print("SPECTRUM " + json.dumps(spec.tolist()))
    print("TOTAL " + json.dumps(store.total_added.tolist()))
print("WORKER_OK", pid)
"""


INDEX_WORKER = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
coord, pid = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, {repo!r})
from kmer_hasher_tpu.parallel.distributed import init_distributed
init_distributed(coord, num_processes=2, process_id=pid)

import numpy as np
from jax.sharding import Mesh
from kmer_hasher_tpu.io import read_fastx
from kmer_hasher_tpu.parallel.sharded import ShardedKmerIndex

seq = read_fastx({fa!r})[0][1][:4000]
mesh = Mesh(np.asarray(jax.devices()), ("shards",))
idx = ShardedKmerIndex(seq, 8, mesh)
tabs = idx.tables(1 | 2 | 8)
hits = idx.seq_kmer_pos(seq[1000:1200], 8)
if pid == 0:
    print("TABLES " + json.dumps({{
        "total": idx.total_kmers,
        "n_kmers": idx.n_kmers,
        "kmer_head": tabs["kmer"][:5],
        "pos": np.asarray(tabs["pos"]).tolist(),
        "count": np.asarray(tabs["count"]).tolist(),
        "hits": np.asarray(hits).tolist(),
    }}))
print("WORKER_OK", pid)
"""


def test_two_process_index_build(ref, tmp_path):
    """ShardedKmerIndex on a 2-process mesh: build, range-partitioned
    tables, and cross-sequence query all equal the single-process run."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lines = _run_two_workers(tmp_path, INDEX_WORKER.format(
        repo=repo, fa=str(ref / "test.fa")),
                             name="worker_idx.py")
    dist = _line_json(lines, "TABLES")

    import jax
    from jax.sharding import Mesh

    from kmer_hasher_tpu.io import read_fastx
    from kmer_hasher_tpu.parallel.sharded import ShardedKmerIndex

    seq = read_fastx(str(ref / "test.fa"))[0][1][:4000]
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("shards",))
    idx = ShardedKmerIndex(seq, 8, mesh)
    tabs = idx.tables(1 | 2 | 8)
    assert dist["total"] == idx.total_kmers
    assert dist["n_kmers"] == idx.n_kmers
    assert dist["kmer_head"] == tabs["kmer"][:5]
    np.testing.assert_array_equal(np.asarray(dist["pos"]), tabs["pos"])
    np.testing.assert_array_equal(np.asarray(dist["count"]), tabs["count"])
    np.testing.assert_array_equal(np.asarray(dist["hits"]),
                                  idx.seq_kmer_pos(seq[1000:1200], 8))


def test_two_process_high_level_counting(ref, tmp_path):
    """count_kmers_fq_sh_rp(mesh=) on a 2-process mesh: each process feeds
    its row slice of every batch (per-host input sharding), results equal
    the single-process run byte-for-byte."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lines = _run_two_workers(tmp_path, HIGH_LEVEL_WORKER.format(
        repo=repo, fq=str(ref / "test.fastq.gz")),
                             name="worker_hl.py")
    dist_spec = np.asarray(_line_json(lines, "SPECTRUM"))
    dist_total = _line_json(lines, "TOTAL")

    import jax
    from jax.sharding import Mesh

    from kmer_hasher_tpu.counting import count_kmers_fq_sh_rp

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("shards",))
    single = count_kmers_fq_sh_rp(str(ref / "test.fastq.gz"), 11,
                                  min_q=20, max_reads=64, mesh=mesh)
    np.testing.assert_array_equal(dist_spec, single.spectrum(50))
    assert dist_total == single.total_added.tolist()


def store_digest(store) -> str:
    """sha256 over the folded store's live (key, count) rows — the
    bitwise identity of a ShardedCountStore's contents."""
    import hashlib

    from kmer_hasher_tpu.parallel.sharded import _host_read

    store._fold()
    uh, ul, cn = (_host_read(store.u_hi), _host_read(store.u_lo),
                  _host_read(store.cnt))
    h = hashlib.sha256()
    for d in range(uh.shape[0]):
        n = int(store._n_unique[d])
        h.update(uh[d, :n].tobytes())
        h.update(ul[d, :n].tobytes())
        h.update(cn[d, :n].tobytes())
    return h.hexdigest()


def write_varlen_fastq(path, seed: int = 7, n_reads: int = 64) -> None:
    """64 variable-length reads whose per-half max lengths straddle a
    16-length bucket: rows 0-31 are 30-45 bp, rows 32-63 are 60-90 bp —
    process 0's slice maxes in the 48 bucket, process 1's in the 96
    bucket, so any static derived AFTER the per-process slice (the round-3
    n_win bug, counting.py) traces differently-shaped collectives."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n_reads):
            ln = (int(rng.integers(30, 46)) if i < n_reads // 2
                  else int(rng.integers(60, 91)))
            seq = "".join("ACGT"[c] for c in rng.integers(0, 4, ln))
            f.write(f"@r{i}\n{seq}\n+\n{'I' * ln}\n")


VARLEN_WORKER = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
coord, pid = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, {repo!r})
from kmer_hasher_tpu.parallel.distributed import init_distributed
init_distributed(coord, num_processes=2, process_id=pid)

import numpy as np
from jax.sharding import Mesh
from kmer_hasher_tpu.counting import count_kmers_fq_sh_rp
sys.path.insert(0, {testdir!r})
from test_distributed import store_digest

mesh = Mesh(np.asarray(jax.devices()), ("shards",))
store = count_kmers_fq_sh_rp({fq!r}, 11, min_q=20, mesh=mesh)
spec = store.spectrum(50)
digest = store_digest(store)  # collective (allgather): EVERY process calls
# TRUE input slicing: this process must have parsed only ~1/2 of the
# corpus bytes (the lockstep fallback parses all of them on every host)
from kmer_hasher_tpu.io import native
total_seq = {total_seq}
parsed = native.STATS["bytes_parsed"]
assert 0.2 * total_seq <= parsed <= 0.8 * total_seq, (parsed, total_seq)
if pid == 0:
    print("SPECTRUM " + json.dumps(spec.tolist()))
    print("TOTAL " + json.dumps(store.total_added.tolist()))
    print("DIGEST " + json.dumps(digest))
print("WORKER_OK", pid)
"""


MULTILINE_WORKER = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
coord, pid = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, {repo!r})
from kmer_hasher_tpu.parallel.distributed import init_distributed
init_distributed(coord, num_processes=2, process_id=pid)

import numpy as np
from jax.sharding import Mesh
from kmer_hasher_tpu.counting import count_kmers_fq_sh_rp
sys.path.insert(0, {testdir!r})
from test_distributed import store_digest

mesh = Mesh(np.asarray(jax.devices()), ("shards",))
store = count_kmers_fq_sh_rp({fq!r}, 11, min_q=20, mesh=mesh)
digest = store_digest(store)
total = store.total_added.tolist()
if pid == 0:
    print("DIGEST " + json.dumps(digest))
    print("TOTAL " + json.dumps(total))
print("WORKER_OK", pid)
"""


def test_two_process_multiline_fastq_falls_back(tmp_path):
    """Multi-line FASTQ defeats byte-range boundary re-sync: the sliced
    path must NOT activate (is_fourline_fastq gate) and the lockstep
    fallback must count every read — bitwise equal to single-process."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    testdir = os.path.dirname(os.path.abspath(__file__))
    fq = str(tmp_path / "multiline.fastq")
    rng = np.random.default_rng(3)
    with open(fq, "w") as f:
        for i in range(48):
            ln = int(rng.integers(30, 60))
            seq = "".join("ACGT"[c] for c in rng.integers(0, 4, ln))
            half = ln // 2  # seq and qual both span two lines
            f.write(f"@m{i}\n{seq[:half]}\n{seq[half:]}\n+\n"
                    f"{'I' * half}\n{'I' * (ln - half)}\n")
    from kmer_hasher_tpu.io.fastx import is_fourline_fastq

    assert not is_fourline_fastq(fq)
    lines = _run_two_workers(
        tmp_path,
        MULTILINE_WORKER.format(repo=repo, testdir=testdir, fq=fq),
        name="worker_multiline.py")
    dist_digest = _line_json(lines, "DIGEST")
    dist_total = _line_json(lines, "TOTAL")

    import jax
    from jax.sharding import Mesh

    from kmer_hasher_tpu.counting import count_kmers_fq_sh_rp

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("shards",))
    single = count_kmers_fq_sh_rp(fq, 11, min_q=20, mesh=mesh)
    assert dist_total == single.total_added.tolist()
    assert dist_digest == store_digest(single)


FILELIST_WORKER = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
coord, pid = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, {repo!r})
from kmer_hasher_tpu.parallel.distributed import init_distributed
init_distributed(coord, num_processes=2, process_id=pid)

import numpy as np
from jax.sharding import Mesh
from kmer_hasher_tpu.counting import count_kmers_fq_sh_rp
sys.path.insert(0, {testdir!r})
from test_distributed import store_digest

mesh = Mesh(np.asarray(jax.devices()), ("shards",))
store = count_kmers_fq_sh_rp([{fq1!r}, {fq2!r}], 11, min_q=20, mesh=mesh)
digest = store_digest(store)  # collective: every process calls
# FILE PARTITIONING: this process must have parsed only its OWN file
# (~1/2 of the corpus bytes), not both
from kmer_hasher_tpu.io import native
total_seq = {total_seq}
parsed = native.STATS["bytes_parsed"]
assert 0.2 * total_seq <= parsed <= 0.8 * total_seq, (parsed, total_seq)
if pid == 0:
    print("DIGEST " + json.dumps(digest))
    print("TOTAL " + json.dumps(store.total_added.tolist()))
print("WORKER_OK", pid)
"""


def test_two_process_file_list_partitioning(tmp_path):
    """count_kmers_fq_sh_rp with a FILE LIST on a 2-process mesh: the two
    files are partitioned across the hosts (each parses only its own —
    the gzip-capable complement of byte-range slicing, ROADMAP §4c.5),
    and the folded store equals the single-process run over the same list
    bitwise."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    testdir = os.path.dirname(os.path.abspath(__file__))
    fq1 = str(tmp_path / "part_a.fastq")
    fq2 = str(tmp_path / "part_b.fastq")
    write_varlen_fastq(fq1, seed=11)
    write_varlen_fastq(fq2, seed=23)
    from kmer_hasher_tpu.io import read_fastx

    total_seq = sum(len(s) for p in (fq1, fq2)
                    for (_n, s, _q) in read_fastx(p))
    lines = _run_two_workers(
        tmp_path,
        FILELIST_WORKER.format(repo=repo, testdir=testdir, fq1=fq1,
                               fq2=fq2, total_seq=total_seq),
        name="worker_filelist.py")
    dist_digest = _line_json(lines, "DIGEST")
    dist_total = _line_json(lines, "TOTAL")

    import jax
    from jax.sharding import Mesh

    from kmer_hasher_tpu.counting import count_kmers_fq_sh_rp

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("shards",))
    single = count_kmers_fq_sh_rp([fq1, fq2], 11, min_q=20, mesh=mesh)
    assert dist_total == single.total_added.tolist()
    assert dist_digest == store_digest(single)


def test_file_list_sequential_equivalence(tmp_path):
    """A file list without a mesh accumulates every file into one store,
    equal to incremental per-file calls (src/kmer_hash.c:833-841); cursor
    options are rejected for lists."""
    from kmer_hasher_tpu.counting import count_kmers_fq_sh_rp

    fq1 = str(tmp_path / "seq_a.fastq")
    fq2 = str(tmp_path / "seq_b.fastq")
    write_varlen_fastq(fq1, seed=5, n_reads=32)
    write_varlen_fastq(fq2, seed=9, n_reads=32)
    inc = count_kmers_fq_sh_rp(fq1, 11, min_q=20)
    inc = count_kmers_fq_sh_rp(fq2, 11, min_q=20, store=inc)
    lst = count_kmers_fq_sh_rp([fq1, fq2], 11, min_q=20)
    np.testing.assert_array_equal(inc.spectrum(50), lst.spectrum(50))
    assert inc.total_added.tolist() == lst.total_added.tolist()
    with pytest.raises(ValueError, match="file list"):
        count_kmers_fq_sh_rp([fq1, fq2], 11, max_reads=10)
    with pytest.raises(ValueError, match="empty"):
        count_kmers_fq_sh_rp([], 11)


def test_two_process_varlen_counting(tmp_path):
    """Variable-length reads split unevenly across the two process slices
    (short reads land on process 0, long on process 1): statics (n_win,
    with_q/with_noq) must come from the FULL batch, each process must
    parse only its OWN byte range (~1/2 of the corpus — VERDICT r3
    §2.2-partial), and the folded store must equal the single-process run
    bitwise (VERDICT r3 weak-1)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    testdir = os.path.dirname(os.path.abspath(__file__))
    fq = str(tmp_path / "varlen.fastq")
    write_varlen_fastq(fq)
    from kmer_hasher_tpu.io import read_fastx

    total_seq = sum(len(s) for (_n, s, _q) in read_fastx(fq))
    lines = _run_two_workers(
        tmp_path,
        VARLEN_WORKER.format(repo=repo, testdir=testdir, fq=fq,
                             total_seq=total_seq),
        name="worker_varlen.py")
    dist_spec = np.asarray(_line_json(lines, "SPECTRUM"))
    dist_total = _line_json(lines, "TOTAL")
    dist_digest = _line_json(lines, "DIGEST")

    import jax
    from jax.sharding import Mesh

    from kmer_hasher_tpu.counting import count_kmers_fq_sh_rp

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("shards",))
    single = count_kmers_fq_sh_rp(fq, 11, min_q=20, mesh=mesh)
    np.testing.assert_array_equal(dist_spec, single.spectrum(50))
    assert dist_total == single.total_added.tolist()
    assert dist_digest == store_digest(single)
