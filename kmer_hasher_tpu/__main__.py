"""Command-line interface: ``python -m kmer_hasher_tpu <cmd> ...``

The reference is callable only from an R session; this CLI makes the same
capabilities (and the persistence layer) usable standalone:

  index    build a position index from FASTA and save it
  tables   dump kmer/pos/pair.pos/count tables from a saved index
  query    cross-sequence dot-plot hits (seq.kmer.pos)
  count    quality-filtered canonical counting over FASTQ/FASTA files
  spectrum count histogram from a saved store
  depth    per-position depth track of a sequence against a saved store
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _read_first_seq(path: str) -> str:
    from .io import read_fastx

    recs = read_fastx(path)
    if not recs:
        raise SystemExit(f"no sequences in {path}")
    return recs[0][1].decode()


def cmd_index(a):
    from .api import make_kmer_hash
    from .utils import checkpoint as ckpt

    idx = make_kmer_hash(_read_first_seq(a.fasta), a.k)
    ckpt.save_index(idx, a.out)
    print(json.dumps({"k": idx.k, "seq_len": idx.seq_len,
                      "positions": idx.n_valid, "distinct": idx.n_kmers,
                      "pairs": idx.total_pairs, "out": a.out}))


def cmd_tables(a):
    from .utils import checkpoint as ckpt

    idx = ckpt.load_index(a.index)
    t = idx.tables(a.opt_flag, max_pairs=a.max_pairs)
    for name, arr in t.items():
        if arr is None:
            continue
        out = f"{a.out_prefix}.{name.replace('.', '_')}"
        if name == "kmer":
            with open(out + ".txt", "w") as f:
                f.write("\n".join(arr) + "\n")
        else:
            np.save(out + ".npy", arr)
        print(f"wrote {out}", file=sys.stderr)


def cmd_query(a):
    from .index.query import seq_kmer_pos
    from .utils import checkpoint as ckpt

    idx = ckpt.load_index(a.index)
    m = seq_kmer_pos(idx, _read_first_seq(a.fasta), a.k)
    np.save(a.out, m)
    print(json.dumps({"hits": int(m.shape[0]), "out": a.out}))


def _same_file(a: str, b: str) -> bool:
    """Whether two CLI paths name the same input file (the resume cursor
    stores the path string the original run was given, which may differ
    lexically — './f.fq' vs 'f.fq', or a different cwd)."""
    if a == b:
        return True
    try:
        return os.path.samefile(a, b)
    except OSError:
        return os.path.abspath(a) == os.path.abspath(b)


def cmd_count(a):
    from .api import count_kmers_fq_sh_rp
    from .utils import checkpoint as ckpt
    from .utils.metrics import most_common_kmer

    if a.batch_rows:
        os.environ["KMH_BATCH_ROWS"] = str(a.batch_rows)
    if a.no_pack:
        os.environ["KMH_PACK_UPLOAD"] = "0"
    mesh = None
    if a.mesh:
        if a.mesh_slices:
            from .parallel.mesh import make_hierarchical_mesh

            if a.mesh % a.mesh_slices:
                raise SystemExit(
                    f"--mesh {a.mesh} is not divisible by "
                    f"--mesh-slices {a.mesh_slices}")
            mesh = make_hierarchical_mesh(a.mesh_slices,
                                          a.mesh // a.mesh_slices)
        else:
            from .parallel.mesh import make_mesh

            mesh = make_mesh(a.mesh)
    store = None
    progress = None
    if a.resume:
        store = ckpt.load_count_store(a.resume, mesh=mesh)
        progress = ckpt.load_progress(a.resume)
        if progress:
            print(f"resuming after {progress['reads_done']} reads of "
                  f"{progress['path']}", file=sys.stderr)
    if a.partition_files:
        if a.resume or a.checkpoint_every or a.max_reads is not None:
            raise SystemExit("--partition-files excludes --resume/"
                             "--checkpoint-every/--max-reads")
        if a.source is None and a.source_n > 1:
            raise SystemExit("--partition-files counts every file under "
                             "ONE source: give --source explicitly with "
                             "--source-n > 1")
        exact_ll = {"exact": True, "fast": False,
                    "hybrid": "hybrid"}[a.ll_mode]
        store = count_kmers_fq_sh_rp(
            a.files if len(a.files) > 1 else a.files[0], k=a.k,
            min_q=a.min_q, source_n=a.source_n, source=a.source or 0,
            report_every=a.report_every, exact_ll=exact_ll, mesh=mesh)
        ckpt.save_count_store(store, a.out)
        info = {"distinct": int(np.asarray(store.n_unique).sum()),
                "total_added": np.asarray(store.total_added).tolist(),
                "out": a.out}
        if mesh is None:
            info["most_common"] = most_common_kmer(store)
        else:
            info["shards"] = np.asarray(store.n_unique).tolist()
        print(json.dumps(info))
        return
    counted_any = False
    for i, path in enumerate(a.files):
        skip = 0
        if progress:
            if not _same_file(progress.get("path", ""), path):
                continue  # earlier file: already fully counted in the store
            if progress.get("done"):
                progress = None
                continue  # this file is fully counted in the store
            skip = int(progress["reads_done"])
            progress = None
        source = a.source if a.source is not None else min(
            i, a.source_n - 1
        )
        exact_ll = {"exact": True, "fast": False,
                    "hybrid": "hybrid"}[a.ll_mode]
        store = count_kmers_fq_sh_rp(
            path, k=a.k, min_q=a.min_q, source_n=a.source_n, source=source,
            max_reads=a.max_reads, store=store,
            report_every=a.report_every, exact_ll=exact_ll, mesh=mesh,
            skip_reads=skip, checkpoint_every=a.checkpoint_every,
            checkpoint_path=(a.out if a.checkpoint_every else None),
        )
        counted_any = True
    if progress is not None:
        # a non-None cursor after the loop means it matched none of the
        # given files: every input was skipped as "already counted"
        raise SystemExit(
            f"resume cursor points at {progress['path']!r}, which matches "
            f"none of the given input files — refusing to skip everything")
    if not (a.checkpoint_every and counted_any):
        # with --checkpoint-every the counting loop already wrote the final
        # atomic checkpoint (incl. the resume cursor) to OUT
        ckpt.save_count_store(store, a.out)
    info = {"distinct": int(np.asarray(store.n_unique).sum()),
            "total_added": np.asarray(store.total_added).tolist(),
            "out": a.out}
    if mesh is None:
        info["most_common"] = most_common_kmer(store)
    else:
        info["shards"] = np.asarray(store.n_unique).tolist()
    print(json.dumps(info))


def cmd_spectrum(a):
    from .utils import checkpoint as ckpt

    store = ckpt.load_count_store(a.store)
    spec = store.spectrum(a.max_count)
    for count, n in enumerate(spec):
        if n:
            print(f"{count}\t{int(n)}")


def cmd_depth(a):
    from .counting import seq_kmer_depth
    from .utils import checkpoint as ckpt

    store = ckpt.load_count_store(a.store)
    d = seq_kmer_depth(store, _read_first_seq(a.fasta), a.k,
                       semantics=a.semantics)
    np.save(a.out, d)
    print(json.dumps({"shape": list(d.shape), "out": a.out}))


def main(argv=None):
    p = argparse.ArgumentParser(prog="kmer_hasher_tpu",
                                description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("index", help="build + save a position index")
    s.add_argument("fasta")
    s.add_argument("-k", type=int, required=True)
    s.add_argument("-o", "--out", required=True)
    s.set_defaults(fn=cmd_index)

    s = sub.add_parser("tables", help="dump kmer.pos tables")
    s.add_argument("index")
    s.add_argument("--opt-flag", type=int, default=15)
    s.add_argument("--max-pairs", type=int, default=None)
    s.add_argument("-o", "--out-prefix", required=True)
    s.set_defaults(fn=cmd_tables)

    s = sub.add_parser("query", help="seq.kmer.pos dot-plot hits")
    s.add_argument("index")
    s.add_argument("fasta")
    s.add_argument("-k", type=int, required=True)
    s.add_argument("-o", "--out", required=True)
    s.set_defaults(fn=cmd_query)

    s = sub.add_parser("count", help="canonical quality-filtered counting")
    s.add_argument("files", nargs="+")
    s.add_argument("-k", type=int, required=True)
    s.add_argument("--min-q", type=int, default=20)
    s.add_argument("--source-n", type=int, default=1)
    s.add_argument("--source", type=int, default=None,
                   help="fixed source index (default: file order)")
    s.add_argument("--max-reads", type=int, default=None)
    s.add_argument("--ll-mode", choices=["exact", "fast", "hybrid"],
                   default="exact",
                   help="likelihood filter: exact f64 (bit-parity), fast "
                        "f32, or hybrid (bitwise-exact at ~fast speed)")
    s.add_argument("--mesh", type=int, default=None,
                   help="count multi-chip over N devices (sharded store; "
                        "the reference's thread_n, lifted to chips)")
    s.add_argument("--mesh-slices", type=int, default=None,
                   help="with --mesh: treat the N devices as this many "
                        "groups joined by a slower link (hierarchical "
                        "group-first key routing)")
    s.add_argument("--resume", default=None,
                   help="existing store to keep accumulating into; if it "
                        "holds a progress cursor (--checkpoint-every), "
                        "counting resumes mid-file after the last "
                        "checkpointed read")
    s.add_argument("--checkpoint-every", type=int, default=None,
                   help="atomically checkpoint the store + resume cursor "
                        "to OUT every N reads")
    s.add_argument("--report-every", type=int, default=None)
    s.add_argument("--batch-rows", type=int, default=None,
                   help="reads per device batch (default 16384; sets "
                        "KMH_BATCH_ROWS)")
    s.add_argument("--no-pack", action="store_true",
                   help="disable the 2-bit packed seq upload "
                        "(KMH_PACK_UPLOAD=0); results are identical "
                        "either way")
    s.add_argument("--partition-files", action="store_true",
                   help="count all FILES in one call under a single "
                        "source; on a multi-process mesh the files are "
                        "partitioned across hosts so each parses only "
                        "its own (gzip-capable input scaling). Excludes "
                        "--resume/--checkpoint-every/--max-reads and "
                        "per-file source assignment")
    s.add_argument("-o", "--out", required=True)
    s.set_defaults(fn=cmd_count)

    s = sub.add_parser("spectrum", help="count histogram of a saved store")
    s.add_argument("store")
    s.add_argument("--max-count", type=int, default=10000)
    s.set_defaults(fn=cmd_spectrum)

    s = sub.add_parser("depth", help="per-position depth track")
    s.add_argument("store")
    s.add_argument("fasta")
    s.add_argument("-k", type=int, required=True)
    s.add_argument("-o", "--out", required=True)
    s.add_argument("--semantics", choices=["intent", "c"],
                   default="intent",
                   help="'c' reproduces the reference's depth loop "
                        "byte-for-byte incl. its column shift and "
                        "stale-register windows (PARITY.md)")
    s.set_defaults(fn=cmd_depth)

    a = p.parse_args(argv)
    a.fn(a)


if __name__ == "__main__":
    main()
