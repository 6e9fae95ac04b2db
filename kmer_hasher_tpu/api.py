"""Public API — mirrors the reference's R surface (kmer_hash.R:5-96) with
typed arguments instead of positional integer vectors.

R name                      -> here
make.kmer.hash(seq,k,sort)  -> make_kmer_hash(seq, k, do_sort=False)
kmer.pos(ptr, opt.flag)     -> kmer_pos(index, opt_flag)
seq.kmer.pos(ptr, seq, k)   -> seq_kmer_pos(index, seq, k)
kmer.pairs(a, b)            -> kmer_pairs(a, b)
count.kmers(seq, params)    -> count_kmers(seqs, k, source, source_n, store)
count.kmers.fq(file, p)     -> count_kmers_fq(file, ...)      [kmer-tree mode]
count.kmers.fq.sh(file, p)  -> count_kmers_fq_sh(file, ...)
count.kmers.fq.sh.rp(...)   -> count_kmers_fq_sh_rp(file, ...)  [flagship]
seq.kmer.depth.sh(ptr,s,k)  -> seq_kmer_depth(store, seq, k)
kmer.spec.kt/sh(ptr, max)   -> kmer_spectrum(store, max_count)
kmer.spec.sh.n(...)         -> kmer_spectrum_n(store, max_count, comb, ...)
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .counting import (
    count_kmers,
    count_kmers_fq,
    count_kmers_fq_sh,
    count_kmers_fq_sh_rp,
    seq_kmer_depth,
)
from .index import KmerIndex
from .index.count_store import CountStore
from .index.query import (iter_kmer_pairs_chunks, iter_seq_kmer_pos_chunks,
                          kmer_pairs, seq_kmer_pos)

__all__ = [
    "KmerIndex",
    "CountStore",
    "make_kmer_hash",
    "make_kmer_hash_many",
    "kmer_pos",
    "seq_kmer_pos",
    "iter_seq_kmer_pos_chunks",
    "kmer_pairs",
    "iter_kmer_pairs_chunks",
    "count_kmers",
    "count_kmers_fq",
    "count_kmers_fq_sh",
    "count_kmers_fq_sh_rp",
    "seq_kmer_depth",
    "kmer_spectrum",
    "kmer_spectrum_n",
]


def make_kmer_hash(seq, k: int, do_sort: bool = False) -> KmerIndex:
    """Build a k-mer position index (``make.kmer.hash``,
    src/kmer_hash.c:506-540). ``do_sort`` accepted for parity; positions are
    always sorted here."""
    return KmerIndex(seq, k, do_sort=do_sort)


def make_kmer_hash_many(seqs, k: int) -> "list[KmerIndex]":
    """Build indexes for many sequences with one batched device program
    per length bucket (an extension: the reference loops make.kmer.hash
    per sequence; see KmerIndex.build_many)."""
    return KmerIndex.build_many(seqs, k)


def kmer_pos(index: KmerIndex, opt_flag: int,
             max_pairs: Optional[int] = None) -> Dict:
    """Extract kmer/pos/pair.pos/count tables (``kmer.pos``,
    src/kmer_hash.c:1054-1147). Set ``max_pairs`` to guard against pair
    blow-ups, or use ``index.iter_pair_chunks()`` to stream."""
    return index.tables(opt_flag, max_pairs=max_pairs)


def kmer_spectrum(store: CountStore, max_count: int) -> np.ndarray:
    """``kmer.spec.kt`` / ``kmer.spec.sh`` (src/kmer_hash.c:975-1008):
    counts histogram clamped into the last bin; kmer_tree-mode stores
    include the zero cells of allocated prefix blocks."""
    return store.spectrum(max_count)


def kmer_spectrum_n(store: CountStore, max_count: int, comb, comb_inner,
                    source_min) -> np.ndarray:
    """``kmer.spec.sh.n`` (src/kmer_hash.c:1010-1038)."""
    return store.spectrum_n(max_count, comb, comb_inner, source_min)
