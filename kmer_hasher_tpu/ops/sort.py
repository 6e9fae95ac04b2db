"""Sort-based segmented grouping — the data-parallel replacement for khash.

The reference's hot loop is one open-addressing hash probe + growable-vector
push per base (src/kmer_pos.c:36-50, khash.h:230-360): pointer chasing that
cannot vectorise. Here the index is a *sorted* (kmer, pos) array: grouping,
counting, membership and range queries all become data-parallel primitives
(lexicographic sort, segment boundary flags, prefix sums, binary search)
that XLA maps onto the device. The khash prefix/suffix split survives only as
the multi-chip routing key (see kmer_hasher_tpu.parallel).

Keys are (hi, lo) uint32 pairs, unsigned-lexicographic. All shapes static:
invalid entries carry a leading 1 sort key so they sink to the tail, and a
separate ``n_valid`` scalar bounds the live prefix.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

I32 = jnp.int32

# Network stages fused per pass over device memory in
# bitonic_merge_lanes (KMH_MERGE_DEPTH overrides; the legacy
# KMH_MERGE_QUAD/KMH_MERGE_OCT toggles map onto depths 4/5 when set to 0).
# Read once at import: it selects traced program structure, so runtime
# flips would desync cached jits.
import os as _os  # noqa: E402

_MERGE_QUAD = _os.environ.get("KMH_MERGE_QUAD", "1") == "1"
_MERGE_OCT = _os.environ.get("KMH_MERGE_OCT", "1") == "1"
_MERGE_DEPTH = int(_os.environ.get(
    "KMH_MERGE_DEPTH",
    "7" if _MERGE_OCT and _MERGE_QUAD else
    ("5" if _MERGE_OCT else ("4" if _MERGE_QUAD else "2"))))
# row-sort tail: once the network's stride falls below 2^_MERGE_TAIL the
# remaining stages finish as one batched lax.sort over rows of that size
# (KMH_MERGE_TAIL overrides).
_MERGE_TAIL = int(_os.environ.get("KMH_MERGE_TAIL", "11"))


@functools.partial(jax.jit, static_argnames=("k",))
def sort_windows(
    hi: jax.Array, lo: jax.Array, pos: jax.Array, valid: jax.Array, k: int
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Sort windows by (validity, kmer, position): valid entries first,
    keys ascending, positions ascending within a key — the reference's
    insertion order (positions are pushed in stream order,
    src/kmer_pos.c:84). Returns (s_hi, s_lo, s_pos).

    For k <= 31 the 2k-bit kmer fits a single uint64 with all-ones left as
    an invalid sentinel, and a stable single-key sort preserves the
    position-ascending input order — the cheapest XLA sort form. k == 32
    occupies all 64 bits, so it takes a two-key path with the invalid flag
    packed beside ``hi`` and the position beside ``lo``.
    """
    u64 = jnp.uint64
    if k <= 16:
        # the 2k-bit kmer fits the high u32, the position the low u32: one
        # packed u64 array, no payload, no stability requirement (keys are
        # unique because positions are). Cheapest possible sort form —
        # 8 B/elem through the comparator network instead of 12. A valid
        # entry can never collide with the all-ones sentinel: that would
        # need pos == 0xFFFFFFFF, but positions are < 2^31.
        key = (lo.astype(u64) << jnp.uint64(32)) | pos.astype(
            jnp.uint32).astype(u64)
        key = jnp.where(valid, key, jnp.uint64(0xFFFFFFFFFFFFFFFF))
        key_s = jax.lax.sort(key, dimension=-1, is_stable=False)
        s_lo = (key_s >> jnp.uint64(32)).astype(jnp.uint32)
        s_pos = (key_s.astype(jnp.uint32) & jnp.uint32(0x7FFFFFFF)).astype(
            pos.dtype)
        return jnp.zeros_like(s_lo), s_lo, s_pos
    if k <= 31:
        key = (hi.astype(u64) << jnp.uint64(32)) | lo.astype(u64)
        key = jnp.where(valid, key, jnp.uint64(0xFFFFFFFFFFFFFFFF))
        key_s, pos_s = jax.lax.sort(
            (key, pos), dimension=-1, is_stable=True, num_keys=1
        )
        s_hi = (key_s >> jnp.uint64(32)).astype(jnp.uint32)
        s_lo = key_s.astype(jnp.uint32)
        return s_hi, s_lo, pos_s
    # k == 32: the kmer needs all 64 bits, so invalid entries share the
    # all-ones sentinel with genuine all-G kmers; a u32 second key
    # (invalid flag above the 31-bit position) breaks that tie. But a
    # real all-G 32-mer needs 32 consecutive Gs — absent from virtually
    # every input — and with no real all-ones key the single-key stable
    # sort is already correct and moves one key instead of two. Branch on
    # a cheap reduction.
    key = (hi.astype(u64) << jnp.uint64(32)) | lo.astype(u64)
    k1 = jnp.where(valid, key, jnp.uint64(0xFFFFFFFFFFFFFFFF))
    k2 = ((~valid).astype(jnp.uint32) << 31) | pos.astype(jnp.uint32)
    has_all_g = (valid & (key == jnp.uint64(0xFFFFFFFFFFFFFFFF))).any()

    def fast_1key(k1, k2):
        return jax.lax.sort((k1, k2), dimension=-1, is_stable=True,
                            num_keys=1)

    def safe_2key(k1, k2):
        return jax.lax.sort((k1, k2), dimension=-1, num_keys=2)

    k1_s, k2_s = jax.lax.cond(has_all_g, safe_2key, fast_1key, k1, k2)
    s_hi = (k1_s >> jnp.uint64(32)).astype(jnp.uint32)
    s_lo = k1_s.astype(jnp.uint32)
    s_pos = (k2_s & jnp.uint32(0x7FFFFFFF)).astype(I32)
    return s_hi, s_lo, s_pos


def bitonic_merge_lanes(lanes, n_keys: int, log_tail: "int | None" = None):
    """Sort a bitonic sequence carried in parallel u32 lanes.
    ``lanes[:n_keys]`` compare lexicographically; the rest follow as
    payload (key-equal rows may land in either order — every caller is
    payload-order-independent within a key segment). M must be a power
    of two.

    Stages with stride >= 2^log_tail are static-stride compare-exchange
    passes (pure reshapes + selects). Once stride < 2^log_tail every
    remaining exchange lies within a 2^log_tail-element block, and fully
    sorting each (bitonic) block is a valid completion of the network —
    done as ONE batched lax.sort over the [M/2^log_tail, 2^log_tail] row
    view."""

    def cxl(x, y):
        """Compare-exchange two lane lists: returns (mins, maxs)."""
        if n_keys == 1:
            le = x[0] <= y[0]
        elif n_keys == 2:
            le = (x[0] < y[0]) | ((x[0] == y[0]) & (x[1] <= y[1]))
        else:
            eq01 = (x[0] == y[0]) & (x[1] == y[1])
            le = ((x[0] < y[0])
                  | ((x[0] == y[0]) & (x[1] < y[1]))
                  | (eq01 & (x[2] <= y[2])))
        return ([jnp.where(le, xa, ya) for xa, ya in zip(x, y)],
                [jnp.where(le, ya, xa) for xa, ya in zip(x, y)])

    def fused_pass(lanes, stride, n_stages, M):
        """One HBM pass doing ``n_stages`` consecutive network stages
        (strides stride, stride/2, .., stride >> (n_stages-1)): all the
        exchanges live within a (2^n_stages · s)-element block, so a
        [.., 2^n_stages, s] view runs them on registers between one read
        and one write of every lane."""
        s = stride >> (n_stages - 1)
        W = 1 << n_stages
        v = [a.reshape(-1, W, s) for a in lanes]
        r = [[a[:, i] for a in v] for i in range(W)]
        half = W >> 1
        while half:
            for i in range(W):
                if i % (2 * half) < half:
                    r[i], r[i + half] = cxl(r[i], r[i + half])
            half >>= 1
        return [
            jnp.stack([r[i][j] for i in range(W)], axis=1).reshape(M)
            for j in range(len(lanes))
        ]

    M = lanes[0].shape[0]
    if log_tail is None:
        log_tail = _MERGE_TAIL
    Lt = min(M, 1 << log_tail)
    stride = M // 2
    while stride >= Lt:
        n = 1
        while n < _MERGE_DEPTH and (stride >> n) >= Lt:
            n += 1
        lanes = fused_pass(lanes, stride, n, M)
        stride >>= n
    if stride >= 1:
        rows = [a.reshape(M // Lt, Lt) for a in lanes]
        out = jax.lax.sort(tuple(rows), dimension=-1, num_keys=n_keys,
                           is_stable=False)
        lanes = [a.reshape(M) for a in out]
    return lanes


@jax.jit
def segment_starts(hi: jax.Array, lo: jax.Array, valid: jax.Array) -> jax.Array:
    """True at the first element of each distinct-key run (valid entries
    only; the invalid tail is all False)."""
    first = jnp.zeros(hi.shape, bool).at[..., 0].set(True)
    prev_hi = jnp.roll(hi, 1, axis=-1)
    prev_lo = jnp.roll(lo, 1, axis=-1)
    changed = (hi != prev_hi) | (lo != prev_lo)
    return (first | changed) & valid


@jax.jit
def segment_ids(starts: jax.Array) -> jax.Array:
    """0-based segment id per element (meaningless in the invalid tail)."""
    return jnp.cumsum(starts.astype(I32), axis=-1) - 1


@functools.partial(jax.jit, static_argnames=("side",))
def searchsorted2(
    s_hi: jax.Array, s_lo: jax.Array, n_valid, q_hi: jax.Array,
    q_lo: jax.Array, side: str = "left",
) -> jax.Array:
    """Vectorised binary search over the sorted (hi, lo) pairs.

    Returns, per query, the left/right insertion point within the live
    prefix ``[0, n_valid)``. ~log2(N) gather+compare rounds, all queries in
    parallel — this replaces ``kh_get`` point lookups (khash.h:230-243).
    """
    n = s_hi.shape[0]
    # derive the init carry from BOTH operands so its "varying" status under
    # shard_map matches the loop body's (constants are unvarying; the body
    # mixes in the per-shard s_hi/s_lo)
    lo_b = ((q_hi | s_hi[0]) & jnp.uint32(0)).astype(I32)
    hi_b = lo_b + jnp.asarray(n_valid, I32)
    iters = max(1, (n + 1).bit_length())

    def body(_, state):
        lo_i, hi_i = state
        active = lo_i < hi_i
        mid = (lo_i + hi_i) // 2
        mh = s_hi[mid]
        ml = s_lo[mid]
        if side == "left":
            go_right = (mh < q_hi) | ((mh == q_hi) & (ml < q_lo))
        else:
            go_right = (mh < q_hi) | ((mh == q_hi) & (ml <= q_lo))
        lo_i = jnp.where(active & go_right, mid + 1, lo_i)
        hi_i = jnp.where(active & ~go_right, mid, hi_i)
        return lo_i, hi_i

    lo_b, _ = jax.lax.fori_loop(0, iters, body, (lo_b, hi_b))
    return lo_b


@jax.jit
def lookup_bounds_merge(s_hi, s_lo, n_valid, q_hi, q_lo):
    """(lb, ub) insertion bounds for ALL queries via a sorted merge-join —
    no gathers. The binary search costs ~2·log2(T) dependent gathers per
    query; here both sides are sorted (the table by construction, the
    queries by one payload sort), so ONE bitonic merge + prefix scans
    produce every bound:

    * lb(q) = table keys < q  = table-row count in segments before q's,
    * ub(q) = table keys <= q = total live - table rows in later segments,

    both position-independent within a key segment (no tie lane needed).
    Dead table rows are re-keyed all-ones so they sort last; ub clamps to
    n_valid (only the k=32 all-G query can share their segment). Results
    return in original query order via a u32 index sort."""
    T = s_hi.shape[0]
    Q = q_hi.shape[0]
    ALL = jnp.uint64(0xFFFFFFFFFFFFFFFF)
    tkey = (s_hi.astype(jnp.uint64) << jnp.uint64(32)) | s_lo.astype(
        jnp.uint64)
    tkey = jnp.where(jnp.arange(T, dtype=I32) < jnp.asarray(n_valid, I32),
                     tkey, ALL)
    qkey = (q_hi.astype(jnp.uint64) << jnp.uint64(32)) | q_lo.astype(
        jnp.uint64)
    qk_s, qi_s = jax.lax.sort(
        (qkey, jnp.arange(Q, dtype=jnp.uint32)), num_keys=1,
        is_stable=False,
    )
    SENT = jnp.uint32(0xFFFFFFFF)  # qidx sentinel marking table/pad rows
    M = T + Q
    P = 1 << max(1, int(M - 1).bit_length())
    pad = P - M

    def lane(t_vals, q_vals_rev, fill):
        parts = [t_vals]
        if pad:
            parts.append(jnp.full(pad, fill, t_vals.dtype))
        parts.append(q_vals_rev)
        return jnp.concatenate(parts)

    lanes = bitonic_merge_lanes(
        [lane((tkey >> jnp.uint64(32)).astype(jnp.uint32),
              (qk_s[::-1] >> jnp.uint64(32)).astype(jnp.uint32),
              jnp.uint32(0xFFFFFFFF)),
         lane(tkey.astype(jnp.uint32), qk_s[::-1].astype(jnp.uint32),
              jnp.uint32(0xFFFFFFFF)),
         lane(jnp.full(T, SENT), qi_s[::-1], SENT)],
        n_keys=2,
    )
    hi_m, lo_m, qi_m = lanes
    key_m = (hi_m.astype(jnp.uint64) << jnp.uint64(32)) | lo_m.astype(
        jnp.uint64)
    is_t = (qi_m == SENT).astype(I32)
    c_t = jnp.cumsum(is_t)  # inclusive table-row count (incl. dead/pad)
    starts = jnp.zeros(P, bool).at[0].set(True) | (key_m != jnp.roll(key_m,
                                                                     1))
    # forward fill: table rows strictly before my segment (c_t at the
    # row before my segment start) — non-decreasing, so a plain cummax
    # of the start values fills every row of the segment
    lb_fill = jax.lax.cummax(jnp.where(starts, c_t - is_t, -1))
    # backward fill of "table rows strictly after my segment", by the
    # same construction on the reversed array
    r_is_t = is_t[::-1]
    r_key = key_m[::-1]
    r_starts = jnp.zeros(P, bool).at[0].set(True) | (r_key != jnp.roll(
        r_key, 1))
    r_c = jnp.cumsum(r_is_t)
    t_after = jax.lax.cummax(jnp.where(r_starts, r_c - r_is_t, -1))[::-1]
    total_t = c_t[-1]
    nv = jnp.asarray(n_valid, I32)
    lb_q = jnp.minimum(lb_fill, nv).astype(jnp.uint32)
    ub_q = jnp.minimum(total_t - t_after, nv).astype(jnp.uint32)
    # back to original query order: query rows sort to the front by index
    out = jax.lax.sort((qi_m, lb_q, ub_q), num_keys=1, is_stable=False)
    return out[1][:Q].astype(I32), out[2][:Q].astype(I32)


def lookup_bounds(s_hi, s_lo, n_valid, q_hi, q_lo):
    """(lb, ub) bounds for a query batch against the sorted live prefix.

    Strategy is chosen from STATIC shapes: large query batches take the
    gather-free merge-join (lookup_bounds_merge); small ones the binary
    search (two searchsorted2 calls — a merge would drag the whole table
    through HBM for a handful of lookups)."""
    if int(q_hi.shape[0]) * 16 >= int(s_hi.shape[0]):
        return lookup_bounds_merge(s_hi, s_lo, n_valid, q_hi, q_lo)
    lb = searchsorted2(s_hi, s_lo, n_valid, q_hi, q_lo, "left")
    ub = searchsorted2(s_hi, s_lo, n_valid, q_hi, q_lo, "right")
    return lb, ub


@jax.jit
def expand_rank_merge_i64(sorted_vals, n_valid, g):
    """searchsorted-right over a sorted non-negative int64 array for a
    SORTED query vector ``g`` (the chunked-expansion index map), via the
    same gather-free bitonic merge-join as lookup_bounds_merge: w(g) =
    count of table values <= g = (table rows in segments before g's) +
    (table rows in g's segment), position-independent within a segment.
    Table rows past ``n_valid`` re-key to u64 max so they never count."""
    T = sorted_vals.shape[0]
    Q = g.shape[0]
    ALL = jnp.uint64(0xFFFFFFFFFFFFFFFF)
    tv = jnp.where(jnp.arange(T, dtype=I32) < jnp.asarray(n_valid, I32),
                   sorted_vals.astype(jnp.uint64), ALL)
    qv = g.astype(jnp.uint64)
    SENT = jnp.uint32(0xFFFFFFFF)
    M = T + Q
    P = 1 << max(1, int(M - 1).bit_length())
    pad = P - M

    def lane(t_vals, q_vals_rev, fill):
        parts = [t_vals]
        if pad:
            parts.append(jnp.full(pad, fill, t_vals.dtype))
        parts.append(q_vals_rev)
        return jnp.concatenate(parts)

    hi_m, lo_m, qi_m = bitonic_merge_lanes(
        [lane((tv >> jnp.uint64(32)).astype(jnp.uint32),
              (qv[::-1] >> jnp.uint64(32)).astype(jnp.uint32),
              jnp.uint32(0xFFFFFFFF)),
         lane(tv.astype(jnp.uint32), qv[::-1].astype(jnp.uint32),
              jnp.uint32(0xFFFFFFFF)),
         lane(jnp.full(T, SENT), jnp.arange(Q, dtype=jnp.uint32)[::-1],
              SENT)],
        n_keys=2,
    )
    key_m = (hi_m.astype(jnp.uint64) << jnp.uint64(32)) | lo_m.astype(
        jnp.uint64)
    is_t = (qi_m == SENT).astype(I32)
    c_t = jnp.cumsum(is_t)
    # table rows <= my key: total minus table rows in segments after mine
    r_key = key_m[::-1]
    r_is_t = is_t[::-1]
    r_starts = jnp.zeros(P, bool).at[0].set(True) | (r_key != jnp.roll(
        r_key, 1))
    r_c = jnp.cumsum(r_is_t)
    t_after = jax.lax.cummax(jnp.where(r_starts, r_c - r_is_t, -1))[::-1]
    w = jnp.minimum(c_t[-1] - t_after, jnp.asarray(n_valid, I32)).astype(
        jnp.uint32)
    out = jax.lax.sort((qi_m, w), num_keys=1, is_stable=False)
    return out[1][:Q].astype(I32)


def clamp_chunk_capacity(capacity: int, total: int,
                         floor: int = 1 << 10) -> int:
    """Clamp a drain-chunk capacity to the pow2 ceiling of the known row
    total: small outputs then compile (and run) small chunk programs —
    the expansion network scales with capacity — while large drains keep
    the requested chunk size. Pow2 bucketing bounds compiled variants."""
    if total <= floor:
        return min(capacity, floor)
    return min(capacity, 1 << int(total - 1).bit_length())


def expand_rank_i64(sorted_vals, g, n_valid):
    """searchsorted-right for the chunk expansions: merge-join for large
    chunks (g is already sorted — no pre/back query sort beyond the index
    restore), binary search for small ones. Static-shape dispatch."""
    if int(g.shape[0]) * 16 >= int(sorted_vals.shape[0]):
        return expand_rank_merge_i64(sorted_vals, n_valid, g)
    return searchsorted_i64(sorted_vals, g, n_valid, side="right")


@functools.partial(jax.jit, static_argnames=("side",))
def searchsorted_i64(sorted_vals: jax.Array, q: jax.Array, n_valid,
                     side: str = "right") -> jax.Array:
    """Binary search over a sorted int64 array (used for cumulative-offset
    -> source-element mapping in chunked expansions)."""
    n = sorted_vals.shape[0]
    lo_b = ((q | sorted_vals[0]) & jnp.asarray(0, q.dtype)).astype(I32)
    hi_b = lo_b + jnp.asarray(n_valid, I32)
    iters = max(1, (n + 1).bit_length())

    def body(_, state):
        lo_i, hi_i = state
        active = lo_i < hi_i
        mid = (lo_i + hi_i) // 2
        mv = sorted_vals[mid]
        go_right = (mv < q) if side == "left" else (mv <= q)
        lo_i = jnp.where(active & go_right, mid + 1, lo_i)
        hi_i = jnp.where(active & ~go_right, mid, hi_i)
        return lo_i, hi_i

    lo_b, _ = jax.lax.fori_loop(0, iters, body, (lo_b, hi_b))
    return lo_b
