"""The k-mer position index — sorted-array replacement for the reference's
``khash_ptr`` (src/kmer_pos.h:33-48).

Build: position-parallel encode -> lexicographic sort of (kmer, pos) ->
segment grouping. Everything downstream (tables, counts, dot-plot pairs,
cross-sequence queries) is pure array work over the sorted index.

Emission-order policy: the reference iterates khash buckets, an
implementation artifact (src/kmer_hash.c:1096); this index emits
sorted-by-(kmer, pos) order, which is deterministic, and table parity with
the C output is defined as equality under canonical re-sort (SURVEY.md §7).
Within a k-mer, positions ascend — identical to the reference's insertion
order. 1-based positions throughout (src/kmer_pos.c:84).

The n(n-1)/2 pair table streams in fixed-capacity chunks instead of being
materialised, removing the reference's documented OOM/leak failure mode
(README.md:80-89).
"""
from __future__ import annotations

import functools
from typing import Dict, Iterator, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import encode as enc
from ..ops import expand as exp
from ..ops import sort as srt

I32 = jnp.int32
I64 = jnp.int64
MAX_K = 32
_NUC = np.frombuffer(b"ACTG", dtype=np.uint8)  # decode table, kmer_hash.c:21


@functools.partial(jax.jit, static_argnames=("k", "drop_trailing_exact_k"))
def build_index_arrays(
    ascii_u8: jax.Array, k: int, true_len, drop_trailing_exact_k: bool = True
):
    """The flagship build step: encode + sort + group, one fused jit.

    Returns (s_hi, s_lo, s_pos, n_valid, starts, seg_ids) over the full
    (static) window axis; the live prefix has length n_valid.
    ``s_pos`` is the 1-based window start. Replaces ``seq_to_hash``
    (src/kmer_pos.c:66-98).
    """
    hi, lo, valid = enc.encode_stream(
        ascii_u8, k, true_len, canonical=False,
        drop_trailing_exact_k=drop_trailing_exact_k,
    )
    L = hi.shape[-1]
    pos = jnp.broadcast_to(jnp.arange(1, L + 1, dtype=I32), hi.shape)
    s_hi, s_lo, s_pos = srt.sort_windows(hi, lo, pos, valid, k)
    n_valid = valid.sum(axis=-1).astype(I32)
    live = jnp.arange(L, dtype=I32) < n_valid[..., None]
    starts = srt.segment_starts(s_hi, s_lo, live)
    seg_ids = srt.segment_ids(starts)
    return s_hi, s_lo, s_pos, n_valid, starts, seg_ids


@jax.jit
def _group_stats(s_pos, n_valid, starts, seg_ids):
    """counts per segment (dense over the window axis), the i column
    (1-based segment rank per element), rank-in-segment, and per-element
    remaining-pair run lengths m_j = count(seg) - 1 - rank."""
    L = s_pos.shape[-1]
    idx = jnp.arange(L, dtype=I32)
    live = idx < n_valid
    counts = (
        jnp.zeros(L, I32)
        .at[jnp.where(live, seg_ids, L - 1)]
        .add(live.astype(I32), mode="drop")
    )
    seg_start_idx = jax.lax.cummax(jnp.where(starts, idx, -1))
    rank = idx - seg_start_idx
    i_col = seg_ids + 1
    seg_count = counts[jnp.clip(seg_ids, 0)]
    m = jnp.where(live, seg_count - 1 - rank, 0)
    cum_m = jnp.cumsum(m.astype(I64))
    return counts, i_col, rank, m, cum_m


@functools.partial(jax.jit, static_argnames=("capacity",))
def _pair_chunk(s_pos, i_col, m, cum_m, n_valid, start: jax.Array, capacity: int):
    """Emit pair rows [capacity, 3] = (i, x, y) for global pair indices
    [start, start+capacity); rows past the total are masked False.

    Row-major within each segment — for element j (rank r, segment size n)
    the run covers pairs (x=pos[j], y=pos[j+1+t]) for t < n-1-r, which
    concatenated over ascending j reproduces the reference's nested j<k
    loop order (src/kmer_hash.c:1113-1121) under canonical key order.
    """
    g = start + jnp.arange(capacity, dtype=I64)
    j = srt.expand_rank_i64(cum_m, g, n_valid)
    run_start = cum_m[j] - m[j].astype(I64)
    t = (g - run_start).astype(I32)
    x = s_pos[j]
    y = s_pos[jnp.clip(j + 1 + t, 0, s_pos.shape[0] - 1)]
    rows = jnp.stack([i_col[j], x, y], axis=1)
    total = cum_m[jnp.maximum(n_valid - 1, 0)]
    ok = g < total
    return rows, ok


@jax.jit
def _unique_compact(s_hi, s_lo, starts, seg_ids):
    """Scatter each segment's key to its rank: dense unique-key arrays
    (live prefix = n_unique)."""
    L = s_hi.shape[-1]
    tgt = jnp.where(starts, seg_ids, L - 1)
    u_hi = jnp.zeros(L, jnp.uint32).at[tgt].set(s_hi, mode="drop")
    u_lo = jnp.zeros(L, jnp.uint32).at[tgt].set(s_lo, mode="drop")
    n_unique = starts.sum().astype(I32)
    return u_hi, u_lo, n_unique


@functools.partial(jax.jit, static_argnames=("k",))
def _decode_kmers(u_hi: jax.Array, u_lo: jax.Array, k: int) -> jax.Array:
    """Packed keys -> [n, k] base indices 0..3 (decode per kmer_hash.c:123-133)."""
    cols = []
    for j in range(k):  # character j comes from bit offset 2*(k-1-j)
        shift = 2 * (k - 1 - j)
        if shift >= 32:
            c = (u_hi >> (shift - 32)) & 3
        else:
            c = (u_lo >> shift) & 3
        cols.append(c)
    return jnp.stack(cols, axis=1).astype(jnp.uint8)


class KmerIndex:
    """Position index over a single sequence (API analogue of
    ``make.kmer.hash``, src/kmer_hash.c:506-540).

    Validation matches the reference: 1 <= k <= 32, len(seq) strictly > k.
    ``do_sort`` is accepted for API parity and ignored — positions are
    always emitted sorted (the reference notes its sort is a no-op too,
    README.md:57-61).
    """

    def __init__(self, seq, k: int, do_sort: bool = False):
        if not 1 <= k <= MAX_K:
            raise ValueError("k must be a positive integer less than 1+MAX_K")
        if isinstance(seq, str):
            seq = np.frombuffer(seq.encode(), dtype=np.uint8)
        elif isinstance(seq, (bytes, bytearray)):
            seq = np.frombuffer(bytes(seq), dtype=np.uint8)
        seq = np.asarray(seq, dtype=np.uint8)
        if seq.ndim != 1:
            raise ValueError("seq must be a single sequence")
        if seq.shape[0] <= k:
            raise ValueError("the length of the sequence must be at least k")
        self.k = int(k)
        self.seq_len = int(seq.shape[0])
        # bucket the padded length to a power of two so XLA compilations are
        # reused across sequence lengths ('N' padding never forms windows)
        L_pad = 1 << max(6, (self.seq_len - 1).bit_length())
        if L_pad != self.seq_len:
            seq = np.concatenate(
                [seq, np.full(L_pad - self.seq_len, ord("N"), np.uint8)]
            )
        (self.s_hi, self.s_lo, self.s_pos, n_valid, self.starts,
         self.seg_ids) = build_index_arrays(jnp.asarray(seq), k, self.seq_len)
        self.n_valid = int(n_valid)
        (self._counts_dense, self.i_col, self.rank, self.m,
         self.cum_m) = _group_stats(self.s_pos, n_valid, self.starts,
                                    self.seg_ids)
        self._n_unique: Optional[int] = None
        self._u: Optional[Tuple[jax.Array, jax.Array]] = None

    @classmethod
    def build_many(cls, seqs, k: int) -> "List[KmerIndex]":
        """Build indexes for MANY sequences with ONE batched device
        program (contigs, transcripts, amplicons — the reference loops
        make.kmer.hash per sequence, src/kmer_hash.c:506-540).

        The batched [B, L] row sort serves MANY SHORT rows; buckets with
        long rows or too few rows route to individual 1-D builds (the
        flat-sort path). The crossover (rows longer than 2^16 or fewer
        than 4) is not yet measured on the H100. Sequences bucket by padded
        length; each short bucket is one build_index_arrays call.
        Returns one KmerIndex per input, in input order, each
        indistinguishable from an individually-built one."""
        if not 1 <= k <= MAX_K:
            raise ValueError("k must be a positive integer less than 1+MAX_K")
        arrs = []
        for seq in seqs:
            if isinstance(seq, str):
                seq = np.frombuffer(seq.encode(), dtype=np.uint8)
            elif isinstance(seq, (bytes, bytearray)):
                seq = np.frombuffer(bytes(seq), dtype=np.uint8)
            seq = np.asarray(seq, dtype=np.uint8)
            if seq.ndim != 1:
                raise ValueError("each seq must be a single sequence")
            if seq.shape[0] <= k:
                raise ValueError(
                    "the length of the sequence must be at least k")
            arrs.append(seq)
        by_bucket: Dict[int, List[int]] = {}
        for i, a in enumerate(arrs):
            L_pad = 1 << max(6, (int(a.shape[0]) - 1).bit_length())
            by_bucket.setdefault(L_pad, []).append(i)
        out: List[Optional[KmerIndex]] = [None] * len(arrs)
        for L_pad, idxs in sorted(by_bucket.items()):
            if L_pad > (1 << 16) or len(idxs) < 4:
                # long rows / tiny batches take the flat 1-D path
                for i in idxs:
                    out[i] = cls(arrs[i], k)
                continue
            mat = np.full((len(idxs), L_pad), ord("N"), np.uint8)
            lens = np.empty(len(idxs), np.int64)
            for r, i in enumerate(idxs):
                mat[r, : arrs[i].shape[0]] = arrs[i]
                lens[r] = arrs[i].shape[0]
            s_hi, s_lo, s_pos, n_valid, starts, seg_ids = (
                build_index_arrays(jnp.asarray(mat), k, lens))
            n_valid_h = np.asarray(n_valid)
            for r, i in enumerate(idxs):
                ix = cls.__new__(cls)
                ix.k = int(k)
                ix.seq_len = int(arrs[i].shape[0])
                ix.s_hi, ix.s_lo, ix.s_pos = s_hi[r], s_lo[r], s_pos[r]
                ix.starts, ix.seg_ids = starts[r], seg_ids[r]
                ix.n_valid = int(n_valid_h[r])
                (ix._counts_dense, ix.i_col, ix.rank, ix.m,
                 ix.cum_m) = _group_stats(ix.s_pos, n_valid_h[r],
                                          ix.starts, ix.seg_ids)
                ix._n_unique = None
                ix._u = None
                out[i] = ix
        return out  # type: ignore[return-value]

    # -- derived quantities -------------------------------------------------
    @property
    def n_kmers(self) -> int:
        """Distinct k-mer count (khash_ptr.kmer_count analogue)."""
        return self.unique_keys()[2]

    def unique_keys(self):
        if self._u is None:
            u_hi, u_lo, n_unique = _unique_compact(
                self.s_hi, self.s_lo, self.starts, self.seg_ids
            )
            self._u = (u_hi, u_lo)
            self._n_unique = int(n_unique)
        return self._u[0], self._u[1], self._n_unique

    @property
    def total_pairs(self) -> int:
        if self.n_valid == 0:
            return 0
        return int(self.cum_m[self.n_valid - 1])

    # -- kmer.pos table family (src/kmer_hash.c:1054-1147) ------------------
    def kmer_strings(self) -> List[str]:
        u_hi, u_lo, n_unique = self.unique_keys()
        mat = np.asarray(_decode_kmers(u_hi, u_lo, self.k))[:n_unique]
        chars = _NUC[mat]
        return [bytes(row).decode("ascii") for row in chars]

    def counts(self) -> np.ndarray:
        _, _, n_unique = self.unique_keys()
        return np.asarray(self._counts_dense)[:n_unique]

    def pos_table(self) -> np.ndarray:
        """[n_valid, 2] int32 (i, pos): i = 1-based kmer rank in canonical
        order, pos = 1-based window start."""
        i = np.asarray(self.i_col)[: self.n_valid]
        p = np.asarray(self.s_pos)[: self.n_valid]
        return np.stack([i, p], axis=1)

    def iter_pair_chunks(
        self, capacity: int = 1 << 20
    ) -> Iterator[np.ndarray]:
        """Stream the (i, x, y) pair table in fixed-size chunks — the
        documented fix for the reference's pair-table blow-up
        (README.md:80-89)."""
        total = self.total_pairs
        capacity = srt.clamp_chunk_capacity(capacity, total)
        if exp.use_plan(total, self.s_pos.shape[0], capacity):
            plan = exp.ExpansionPlan(self.m, (self.i_col, self.s_pos),
                                     capacity)
            total_d = jnp.asarray(total, I64)
            start = 0
            while start < total:
                rows, ok = exp.pair_chunk_planned(
                    self.s_pos, plan.cum, plan.run_start, plan.w,
                    plan.cols[0], plan.cols[1], total_d,
                    jnp.asarray(start, I64), capacity,
                )
                n_ok = int(np.asarray(ok).sum())
                yield np.asarray(rows)[:n_ok]
                start += capacity
            return
        start = 0
        while start < total:
            rows, ok = _pair_chunk(
                self.s_pos, self.i_col, self.m, self.cum_m,
                jnp.asarray(self.n_valid, I32), jnp.asarray(start, I64),
                capacity,
            )
            n_ok = int(np.asarray(ok).sum())
            yield np.asarray(rows)[:n_ok]
            start += capacity

    def pair_table(self, max_pairs: Optional[int] = None) -> np.ndarray:
        total = self.total_pairs
        if max_pairs is not None and total > max_pairs:
            raise MemoryError(
                f"pair table has {total} rows > max_pairs={max_pairs}; "
                "use iter_pair_chunks() to stream"
            )
        if total == 0:
            return np.zeros((0, 3), np.int32)
        return np.concatenate(list(self.iter_pair_chunks()), axis=0)

    def tables(self, opt_flag: int, max_pairs: Optional[int] = None) -> Dict:
        """The ``kmer.pos`` entry (opt_flag bits 1=kmer 2=pos 4=pair.pos
        8=count, src/kmer_hash.c:17)."""
        out = {"kmer": None, "pos": None, "pair.pos": None, "count": None}
        if opt_flag & 1:
            out["kmer"] = self.kmer_strings()
        if opt_flag & 2:
            out["pos"] = self.pos_table()
        if opt_flag & 4:
            out["pair.pos"] = self.pair_table(max_pairs)
        if opt_flag & 8:
            out["count"] = self.counts()
        return out

    # -- queries ------------------------------------------------------------
    def lookup_range(self, q_hi, q_lo):
        """Per-query (lb, ub) ranges into the sorted position array."""
        nv = jnp.asarray(self.n_valid, I32)
        lb, ub = srt.lookup_bounds(self.s_hi, self.s_lo, nv, q_hi, q_lo)
        return lb, ub
