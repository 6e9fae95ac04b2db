"""End-to-end tour of kmer_hasher_tpu on seeded test data.

Run:  python examples/demo.py [--cpu] [--data DIR]

Without ``--data`` the seeded test files (kmer_hasher_tpu.synth) are
written to a temporary directory first.

Covers every capability of the original R extension (and the additions):
index + dot-plot tables, streamed pairs, cross-sequence queries,
quality-filtered canonical counting, spectra, depth tracks, save/restore,
and (with >= 2 devices) the sharded multi-chip paths.
"""
import argparse
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true",
                    help="run on an 8-device virtual CPU mesh")
parser.add_argument("--data", default=None,
                    help="directory with test.fa / test_10.fastq / "
                         "test.fastq.gz / repeat_40.fq")
args = parser.parse_args()
if args.data is None:
    import tempfile

    from kmer_hasher_tpu.synth import write_test_data

    args.data = tempfile.mkdtemp(prefix="kmh_demo_")
    write_test_data(args.data)

if args.cpu:
    os.environ.setdefault(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=8"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
else:
    import jax

import numpy as np

from kmer_hasher_tpu.api import (
    count_kmers,
    count_kmers_fq_sh_rp,
    kmer_pairs,
    kmer_pos,
    kmer_spectrum,
    kmer_spectrum_n,
    make_kmer_hash,
    seq_kmer_depth,
    seq_kmer_pos,
)
from kmer_hasher_tpu.io import read_fastx
from kmer_hasher_tpu.utils import checkpoint as ckpt
from kmer_hasher_tpu.utils.metrics import most_common_kmer

print(f"backend: {jax.default_backend()}, devices: {len(jax.devices())}")

# --- position index + dot-plot tables (make.kmer.hash / kmer.pos) ----------
name, seq_b, _ = read_fastx(f"{args.data}/test.fa")[0]
seq = seq_b.decode()
idx = make_kmer_hash(seq, k=8)
t = kmer_pos(idx, opt_flag=1 | 2 | 8)
print(f"\n[{name}] {len(seq)} bp, k=8: {idx.n_kmers} distinct k-mers, "
      f"{t['pos'].shape[0]} positions, {idx.total_pairs} dot-plot pairs")
print(f"  most frequent: {t['kmer'][int(np.argmax(t['count']))]} "
      f"x{int(t['count'].max())}")

# streamed pair table (the reference OOMs here on big inputs)
n = 0
for chunk in idx.iter_pair_chunks(capacity=1 << 21):
    n += len(chunk)
print(f"  streamed {n} (i,x,y) pair rows in chunks")

# --- cross-sequence query (seq.kmer.pos) -----------------------------------
idx16 = make_kmer_hash(seq, k=16)
query = seq[30000:31000]
m = seq_kmer_pos(idx16, query, k=16)
print(f"\nseq.kmer.pos: {m.shape[0]} (i,j) hits of a 1 kb query at k=16")

# --- two-index pairs (kmer.pairs, crash-free) ------------------------------
p = kmer_pairs(make_kmer_hash(seq[:5000], 12), make_kmer_hash(seq[2500:7500], 12))
print(f"kmer.pairs: {p.shape[0]} cross-index position pairs")

# --- forward-strand multi-source counting (count.kmers) --------------------
st = count_kmers([seq[:10000], seq[10000:20000]], k=11, source=0, source_n=2)
st = count_kmers([seq[20000:30000]], k=11, source=1, source_n=2, store=st)
print(f"\ncount.kmers: {st.n_unique} distinct 11-mers across 2 sources")

# --- flagship quality-filtered canonical counting (count.kmers.fq.sh.rp) ---
store = count_kmers_fq_sh_rp(f"{args.data}/test.fastq.gz", k=21, min_q=20,
                             source_n=2, source=0, report_every=1000)
store = count_kmers_fq_sh_rp(f"{args.data}/repeat_40.fq", k=21, min_q=20,
                             source_n=2, source=1, store=store)
spec = kmer_spectrum(store, max_count=100)
mc = most_common_kmer(store)
print(f"count.kmers.fq.sh.rp: {store.n_unique} distinct canonical 21-mers; "
      f"singletons={int(spec[1])}; most common {mc['kmer']} x{mc['count']}")

# combination spectrum: k-mers present in both sources vs either
both = kmer_spectrum_n(store, 50, comb=[3], comb_inner=[1],
                       source_min=[1, 1])
print(f"kmer.spec.sh.n: {int(both[0].sum())} 21-mers present in BOTH sources")

# --- depth track (seq.kmer.depth.sh) ---------------------------------------
read0 = read_fastx(f"{args.data}/test.fastq.gz")[0][1].decode()
d = seq_kmer_depth(store, read0, k=21)
NA = -(2 ** 31)
print(f"seq.kmer.depth: read 0 depth track, "
      f"{int((d[0] != NA).sum())} valid columns, max depth "
      f"{int(d[0][d[0] != NA].max())}")

# --- exact-C depth semantics + batched index construction (round 3) --------
d_c = seq_kmer_depth(store, read0, k=21, semantics="c")
print(f"seq.kmer.depth semantics='c': byte-exact reference track, "
      f"{int((d_c[0] != NA).sum())} written columns (note the one-column "
      "shift the C code applies)")
from kmer_hasher_tpu.api import make_kmer_hash_many
contigs = [seq[i:i + 3000] for i in range(0, 12000, 3000)]
idxs = make_kmer_hash_many(contigs, k=12)
print(f"make_kmer_hash_many: {len(idxs)} contigs indexed in one batched "
      f"build, {sum(ix.n_kmers for ix in idxs)} distinct 12-mers total")

# --- save / restore --------------------------------------------------------
ckpt.save_count_store(store, "/tmp/kmh_store.npz")
store2 = ckpt.load_count_store("/tmp/kmh_store.npz")
assert np.array_equal(kmer_spectrum(store2, 100), spec)
print("checkpoint round-trip OK")

# --- multi-chip ------------------------------------------------------------
if len(jax.devices()) >= 2:
    from kmer_hasher_tpu.parallel import ShardedKmerIndex, make_mesh

    mesh = make_mesh()
    sidx = ShardedKmerIndex(seq, k=16, mesh=mesh)
    sm = sidx.seq_kmer_pos(query, k=16)
    assert np.array_equal(sm, m), "sharded query must match single-chip"
    print(f"sharded index over {mesh.size} devices: {sidx.total_kmers} "
          "k-mers routed by hash, sharded query identical to single-chip")
else:
    print("(single device: skipping sharded demo — run with --cpu for an "
          "8-device virtual mesh)")

print("\ndemo complete")
