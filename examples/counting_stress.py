"""End-to-end counting stress: synthetic reads -> full pipeline
(parse -> pad -> FSM filter -> canonicalise -> LSM count store).

This is the scenario where the reference sustains ~300k reads/s on 33 Xeon
cores into a large store (test.R:823-838). A store that re-sorts itself on
every flush collapses here; the size-tiered LSM store
(index/count_store.py) is what this script exercises.

Usage: python examples/counting_stress.py [--reads 200000] [--k 21]
       [--read-len 151] [--exact-ll] [--keep FILE]
"""
import argparse
import os
import sys
import tempfile
import time

import numpy as np


def make_reads(path: str, n: int, read_len: int, seed: int = 0,
               binned: bool = False) -> None:
    """Write n synthetic FASTQ reads with uniform bases and mixed
    qualities (phred 2..40, so the likelihood filter does real work).
    ``binned`` uses the NovaSeq RTA3 4-value quality alphabet
    ('#', ',', ':', 'F') instead — triggers the 4-bit dictionary upload
    packing (io.native.iter_fastx_packed)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    if binned:
        bins = np.frombuffer(b"F:,#", np.uint8)  # phred 37/25/11/2
        pick = rng.choice(4, size=(n, read_len), p=[0.88, 0.08, 0.02, 0.02])
        quals = bins[pick]
        seqs = bases[rng.integers(0, 4, size=(n, read_len), dtype=np.uint8)]
        nl = np.full((n, 1), ord("\n"), np.uint8)
        hdr = np.tile(np.frombuffer(b"@r\n", np.uint8), (n, 1))
        plus = np.tile(np.frombuffer(b"+\n", np.uint8), (n, 1))
        rows = np.concatenate([hdr, seqs, nl, plus, quals, nl], axis=1)
        rows.tofile(path)
        return
    # realistic qualities: mostly phred 30-40 with ~2% low-quality bases,
    # so the likelihood filter rejects some windows but not all
    quals = rng.integers(63, 74, size=(n, read_len), dtype=np.uint8)
    low = rng.random((n, read_len)) < 0.02
    quals[low] = rng.integers(35, 53, size=int(low.sum()), dtype=np.uint8)
    seqs = bases[rng.integers(0, 4, size=(n, read_len), dtype=np.uint8)]
    nl = np.full((n, 1), ord("\n"), np.uint8)
    hdr = np.tile(np.frombuffer(b"@r\n", np.uint8), (n, 1))
    plus = np.tile(np.frombuffer(b"+\n", np.uint8), (n, 1))
    rows = np.concatenate([hdr, seqs, nl, plus, quals, nl], axis=1)
    rows.tofile(path)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=200_000)
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--read-len", type=int, default=151)
    ap.add_argument("--min-q", type=int, default=20)
    ap.add_argument("--exact-ll", action="store_true")
    ap.add_argument("--ll-mode", choices=["fast", "exact", "hybrid"],
                    default=None,
                    help="overrides --exact-ll; hybrid = bitwise-exact "
                         "results at ~fast speed")
    ap.add_argument("--keep", default=None,
                    help="reuse/keep the synthetic fastq at this path")
    ap.add_argument("--binned-quals", action="store_true",
                    help="NovaSeq-style 4-value quality alphabet "
                         "(exercises the 4-bit qual dictionary upload)")
    ap.add_argument("--sources", type=int, default=1,
                    help="count the file this many times into sources "
                         "0..n-1 of ONE store (R1/R2 corpus pattern; "
                         "exercises tagged key-only runs)")
    ap.add_argument("--report-every", type=int, default=50_000,
                    help="progress-meter interval; each report folds the "
                         "store to evaluate n_unique, which is real work "
                         "at large store sizes — 0 disables")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    from kmer_hasher_tpu import counting

    suffix = "b" if args.binned_quals else ""
    path = args.keep or os.path.join(tempfile.gettempdir(),
                                     f"stress_{args.reads}{suffix}.fq")
    if not os.path.exists(path):
        t0 = time.perf_counter()
        make_reads(path, args.reads, args.read_len,
                   binned=args.binned_quals)
        print(f"generated {args.reads} reads in "
              f"{time.perf_counter() - t0:.1f}s -> {path}")

    # initialise the device first, so backend start-up does not pollute
    # the pipeline timing
    import jax.numpy as jnp

    t0 = time.perf_counter()
    np.asarray(jnp.zeros(8, jnp.uint32))
    print(f"device ready in {time.perf_counter() - t0:.1f}s", flush=True)

    exact_ll = args.exact_ll
    if args.ll_mode is not None:
        exact_ll = {"fast": False, "exact": True,
                    "hybrid": "hybrid"}[args.ll_mode]
    t0 = time.perf_counter()
    st = counting.count_kmers_fq_sh_rp(
        path, k=args.k, min_q=args.min_q, exact_ll=exact_ll,
        report_every=args.report_every or None,
        source_n=args.sources, source=0,
    )
    for s in range(1, args.sources):
        # R1/R2-style corpus: the same file re-counted into source s of
        # the SAME store (tagged key-only runs merge per source)
        st = counting.count_kmers_fq_sh_rp(
            path, k=args.k, min_q=args.min_q, exact_ll=exact_ll,
            report_every=args.report_every or None,
            source_n=args.sources, source=s, store=st,
        )
    t_pipe = time.perf_counter() - t0  # includes flush; excludes final fold
    n_unique = st.n_unique  # folds + syncs
    dt = time.perf_counter() - t0
    total_reads = args.reads * args.sources
    print(f"pipeline+flush={t_pipe:.1f}s final fold+sync={dt - t_pipe:.1f}s",
          flush=True)
    print(f"reads={total_reads} k={args.k} exact_ll={exact_ll} "
          f"sources={args.sources} "
          f"distinct={n_unique} total={int(st.total_added.sum())} "
          f"wall={dt:.1f}s rate={total_reads / dt:.0f} reads/s")
    if not args.keep:
        os.unlink(path)


if __name__ == "__main__":
    main()
