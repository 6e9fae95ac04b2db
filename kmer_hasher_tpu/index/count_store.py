"""Multi-source k-mer count store — sorted-array replacement for the
reference's counting backends (``kmer_tree`` src/kmer_tree.c, ``suffix_hash``
/ ``suffix_hash_n`` src/suffix_hash.c).

The reference keeps 2-level prefix->khash structures mutated one k-mer at a
time. Here counts live in **size-tiered sorted runs** (a proper LSM):

* a deferred batch becomes a *run* — sort + segment-reduce of the batch
  only (never the whole store);
* two runs of equal capacity merge pairwise (binomial-heap style), so each
  observation participates in O(log(N/B)) merges total — the economics of
  incremental ``kh_put`` (src/suffix_hash.c:66-97) at sorted-array speed;
* reads fold all runs into one compact sorted table (cached until the next
  add).

Two run representations exist, selected by ``KMH_BITONIC_MERGE`` (default
on):

* **sorted shadow runs** (default): every run is sorted by key ascending
  with dead padding (all-ones key, zero counts) at the tail; duplicate
  keys may appear as adjacent *shadow* rows whose counts sum to the true
  count. Because both merge inputs are sorted, a tier merge is a single
  gather-free **bitonic merge** — concat(A, sentinel pad, reverse(B)) is
  bitonic, so log2(P) static-stride compare-exchange stages sort it
  (~log2(P) fused passes over device memory) instead of a full
  ``lax.sort`` re-sort. Consolidation (segment-summing the
  shadows) happens once, at fold time.
* **consolidated runs** (``KMH_BITONIC_MERGE=0``): unique live keys per
  run, interior dead rows allowed (unsorted); every merge is a full
  re-sort + neighbour-absorb.

Everything between adds is device-resident with **no host syncs**: run
shapes are static per tier, validity is carried in the sort keys (dead rows
key as all-ones with a tie-break flag), and ``n_unique`` / ``total_added``
sync only when actually read.

Count semantics match ``suffix_hash_n`` (src/suffix_hash.c:180-281): up to
``counts_n`` per-source uint32 counters per k-mer. The ``kmer_tree`` mode
difference is observable only in spectra: its dense blocks contribute their
zero cells (src/kmer_tree.c:85-99), modelled here by prefix-block
accounting, not dense allocation.
"""
from __future__ import annotations

import functools
import os
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import sort as srt

I32 = jnp.int32
I64 = jnp.int64
U32 = jnp.uint32


def _fold_budget_bytes() -> int:
    """Device working budget for the spill rejoin: past this, the fold
    goes key-range-partitioned (out-of-core) instead of one-shot. The
    default 3 GB bounds a one-shot rejoin's ~3x merge workspace beside the
    growing final table (not yet tuned for the H100, ROADMAP S7);
    KMH_FOLD_BUDGET_BYTES sets it (tests force it tiny to exercise the
    ranged path)."""
    import os

    return int(os.environ.get("KMH_FOLD_BUDGET_BYTES", str(3 << 30)))


def _next_pow2(n: int) -> int:
    return 1 << max(6, int(n - 1).bit_length()) if n > 1 else 64


# ---------------------------------------------------------------------------
# LSM runs: sorted (key, counts) tables with dead rows keyed all-ones.
# A "run" is (hi, lo, cnt[C]) where live rows have unique true keys and dead
# rows are (0xFFFFFFFF, 0xFFFFFFFF, 0...). A real all-G k=32 kmer shares the
# all-ones *key* but never has an all-zero count row, so the tie-break flag
# (dead=1) in the two-key sort keeps live rows first deterministically.
# Inside the stores, tier-list entries carry a 4th element: a host-side
# source TAG (int) for key-only unit runs whose one-hot count column is
# derived rather than stored, or None for count-carrying runs.
# ---------------------------------------------------------------------------

_DEAD = jnp.uint32(0xFFFFFFFF)


def lsm_compact(runs: list, cap_of, merge_two) -> list:
    """Size-tiered LSM compaction policy, shared by CountStore and
    parallel.ShardedCountStore: merge runs of equal capacity pairwise until
    all capacities are distinct (binomial-heap invariant — at most O(log N)
    runs, each observation in O(log(N/B)) merges total). ``cap_of`` reads a
    run's capacity; ``merge_two`` merges two runs into one."""
    while True:
        by_cap: dict = {}
        for i, r in enumerate(runs):
            by_cap.setdefault(cap_of(r), []).append(i)
        pair = next((v for v in by_cap.values() if len(v) >= 2), None)
        if pair is None:
            return runs
        i, j = pair[0], pair[1]
        merged = merge_two(runs[i], runs[j])
        runs = [r for t, r in enumerate(runs) if t not in (i, j)]
        runs.append(merged)


@functools.partial(jax.jit, static_argnames=("k",))
def _build_run_direct_consolidated(hi, lo, valid, onehot, k: int):
    """Fresh batch -> run, gather-free: one single-key sort, segment
    counts scatter-added onto each segment's first row, dead rows keyed
    all-ones. For k < 32 a valid key can never equal the all-ones
    sentinel (bits above 2k are zero), so the sort carries NO payload and
    validity is re-derived from the sorted keys — the ROADMAP §1
    "sort narrower data" economics applied to the counting hot loop. At
    k=32 a real all-G kmer shares the sentinel, so the validity rides as
    payload; a mixed all-G/dead group stays live with the correct count
    because liveness in run-form is 'count row sum > 0'."""
    N = hi.shape[0]
    key = (hi.astype(jnp.uint64) << jnp.uint64(32)) | lo.astype(jnp.uint64)
    key = jnp.where(valid, key, jnp.uint64(0xFFFFFFFFFFFFFFFF))
    if 2 * k < 32:  # bare u32 comparator (see _run_sorted)
        k32 = jax.lax.sort(key.astype(U32), dimension=-1, is_stable=False)
        val_s = (k32 != _DEAD).astype(U32)
        key_s = jnp.where(k32 == _DEAD, jnp.uint64(0xFFFFFFFFFFFFFFFF),
                          k32.astype(jnp.uint64))
    elif k < 32:
        key_s = jax.lax.sort(key, dimension=-1, is_stable=False)
        val_s = (key_s != jnp.uint64(0xFFFFFFFFFFFFFFFF)).astype(U32)
    else:
        key_s, val_s = jax.lax.sort(
            (key, valid.astype(U32)), dimension=-1, is_stable=False,
            num_keys=1,
        )
    idx = jnp.arange(N, dtype=I32)
    starts = jnp.zeros(N, bool).at[0].set(True) | (
        key_s != jnp.roll(key_s, 1)
    )
    start_row = jax.lax.cummax(jnp.where(starts, idx, -1))
    seg_count = jnp.zeros(N, U32).at[start_row].add(val_s, mode="drop")
    live = starts & (seg_count > 0)
    run_hi = jnp.where(live, (key_s >> jnp.uint64(32)).astype(U32), _DEAD)
    run_lo = jnp.where(live, key_s.astype(U32), _DEAD)
    run_cnt = (onehot[None, :] * seg_count[:, None]
               * live[:, None].astype(U32))
    n_obs = val_s.sum(dtype=jnp.int64)
    return run_hi, run_lo, run_cnt, n_obs


@jax.jit
def _run_from_merge(u_hi, u_lo, cnt, n_unique):
    """Convert _merge output (compact live prefix) into run form."""
    live = jnp.arange(u_hi.shape[0], dtype=I32) < n_unique
    hi = jnp.where(live, u_hi, _DEAD)
    lo = jnp.where(live, u_lo, _DEAD)
    return hi, lo, cnt * live[:, None].astype(U32)


def _run_sorted(hi, lo, cnt, k):
    """Sorted (key_s [u64], live_s, cnt_s) for a run, sorting as little
    data as possible (ROADMAP §1 "sort narrower data"):

    * k <= 15: the whole key fits 30 bits, so the comparator runs on a
      bare uint32 (half the key bytes); the sentinel 0xFFFFFFFF cannot be
      a valid key.
    * k <= 31: uint64 key, no payload — a valid key cannot equal the
      all-ones sentinel (bits above 2k are zero; at k=16 all-G is
      0x00000000FFFFFFFF, still distinct), so liveness derives from the
      sorted key.
    * k = 32: a real all-G kmer shares the sentinel, so a dead flag rides
      as a second sort key."""
    key = (hi.astype(jnp.uint64) << jnp.uint64(32)) | lo.astype(jnp.uint64)
    C = cnt.shape[1]
    if 2 * k < 32:
        ops = (key.astype(U32),) + tuple(cnt[:, j] for j in range(C))
        s = jax.lax.sort(ops, num_keys=1)
        key_s = s[0].astype(jnp.uint64)
        key_s = jnp.where(key_s == jnp.uint64(0xFFFFFFFF),
                          jnp.uint64(0xFFFFFFFFFFFFFFFF), key_s)
        cnt_s = jnp.stack(s[1:], axis=1)
        live = key_s != jnp.uint64(0xFFFFFFFFFFFFFFFF)
    elif k < 32:
        ops = (key,) + tuple(cnt[:, j] for j in range(C))
        s = jax.lax.sort(ops, num_keys=1)
        key_s = s[0]
        cnt_s = jnp.stack(s[1:], axis=1)
        live = key_s != jnp.uint64(0xFFFFFFFFFFFFFFFF)
    else:
        dead = ((key == jnp.uint64(0xFFFFFFFFFFFFFFFF))
                & (cnt.sum(axis=1) == 0)).astype(U32)
        ops = (key, dead) + tuple(cnt[:, j] for j in range(C))
        s = jax.lax.sort(ops, num_keys=2)
        key_s = s[0]
        cnt_s = jnp.stack(s[2:], axis=1)
        live = s[1] == 0
    return key_s, live, cnt_s


@functools.partial(jax.jit, static_argnames=("k",))
def _merge_runs_resort(a_hi, a_lo, a_cnt, b_hi, b_lo, b_cnt, k: int = 32):
    """Merge two runs (each with unique live keys): concat + sort +
    neighbour-absorb. Each true key appears at most twice, so the segment
    sum is one elementwise shifted add — no scatter. Output is run-form but
    unsorted (killed duplicates become interior dead rows); callers either
    merge it again or finalize with _finalize_run."""
    hi = jnp.concatenate([a_hi, b_hi])
    lo = jnp.concatenate([a_lo, b_lo])
    cnt = jnp.concatenate([a_cnt, b_cnt])
    key_s, live, cnt_s = _run_sorted(hi, lo, cnt, k)
    nxt_same = jnp.concatenate([key_s[1:] == key_s[:-1],
                                jnp.zeros(1, bool)])
    prv_same = jnp.concatenate([jnp.zeros(1, bool),
                                key_s[1:] == key_s[:-1]])
    absorb = jnp.where((nxt_same & live)[:, None],
                       jnp.concatenate([cnt_s[1:], cnt_s[:1] * 0]), 0)
    keep = live & ~prv_same
    out_cnt = jnp.where(keep[:, None], cnt_s + absorb, 0)
    out_hi = jnp.where(keep, (key_s >> jnp.uint64(32)).astype(U32), _DEAD)
    out_lo = jnp.where(keep, key_s.astype(U32), _DEAD)
    return out_hi, out_lo, out_cnt


@functools.partial(jax.jit, static_argnames=("k",))
def _finalize_run_resort(hi, lo, cnt, k: int = 32):
    """Sort a run into compact form: live rows first in true key order,
    dead tail zeroed. Returns (u_hi, u_lo, cnt, n_unique)."""
    key_s, live, cnt_s = _run_sorted(hi, lo, cnt, k)
    n_unique = live.sum().astype(I32)
    u_hi = jnp.where(live, (key_s >> jnp.uint64(32)).astype(U32), 0)
    u_lo = jnp.where(live, key_s.astype(U32), 0)
    return u_hi, u_lo, cnt_s * live[:, None].astype(U32), n_unique


# ---------------------------------------------------------------------------
# Sorted-shadow-run representation (KMH_BITONIC_MERGE, the default): runs
# stay sorted so tier merges are gather-free bitonic merges instead of full
# re-sorts. See the module docstring for the invariant.
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("k",))
def _build_run_direct_sorted(hi, lo, valid, onehot, k: int):
    """Fresh batch -> SORTED run with duplicate shadows: one key sort,
    per-row counts = validity one-hot (consolidation deferred to fold
    time), dead rows keyed all-ones sort to the tail. Cheaper than the
    consolidated build (no segment scatter-add), and the output sortedness
    is what lets tier merges be bitonic. Same narrow-comparator ladder as
    _run_sorted: bare u32 for 2k<32, payload-free u64 for k<32, (key,
    valid) at k=32 where a real all-G kmer shares the all-ones key."""
    key = (hi.astype(jnp.uint64) << jnp.uint64(32)) | lo.astype(jnp.uint64)
    key = jnp.where(valid, key, jnp.uint64(0xFFFFFFFFFFFFFFFF))
    if 2 * k < 32:
        k32 = jax.lax.sort(key.astype(U32), dimension=-1, is_stable=False)
        val_s = (k32 != _DEAD).astype(U32)
        run_hi = jnp.where(k32 == _DEAD, _DEAD, jnp.uint32(0))
        run_lo = k32
    elif k < 32:
        key_s = jax.lax.sort(key, dimension=-1, is_stable=False)
        val_s = (key_s != jnp.uint64(0xFFFFFFFFFFFFFFFF)).astype(U32)
        run_hi = (key_s >> jnp.uint64(32)).astype(U32)
        run_lo = key_s.astype(U32)
    else:
        # k=32: a real all-G kmer shares the all-ones key with dead rows;
        # sort (key, dead) so live rows precede dead within equal keys —
        # the extended order the bitonic merge preserves and its output
        # trim relies on (dead rows are the only ones safe to cut)
        key_s, dead_s = jax.lax.sort(
            (key, (~valid).astype(U32)), dimension=-1, is_stable=False,
            num_keys=2,
        )
        val_s = jnp.uint32(1) - dead_s
        run_hi = (key_s >> jnp.uint64(32)).astype(U32)
        run_lo = key_s.astype(U32)
    run_cnt = onehot[None, :] * val_s[:, None]
    n_obs = val_s.sum(dtype=jnp.int64)
    return run_hi, run_lo, run_cnt, n_obs


from ..ops.sort import bitonic_merge_lanes as _bitonic_merge_lanes  # noqa: E501  (shared with the query merge-join)


@functools.partial(jax.jit, static_argnames=("k",))
def _merge_runs_bitonic(a_hi, a_lo, a_cnt, b_hi, b_lo, b_cnt, k: int = 32):
    """Merge two SORTED shadow-runs without re-sorting: concat(A, sentinel
    pad, reverse(B)) is bitonic (ascending, peak, descending), so log2(P)
    compare-exchange stages sort it (several stages fused per pass over
    device memory) instead of a full lax.sort re-sort.
    Works for any input lengths: the all-ones pad rows behave exactly like
    dead padding and sort past the trimmed output. Output: sorted run of
    length Na+Nb; duplicate keys remain adjacent shadow rows (consolidated
    at _finalize_run). Replaces the khash incremental-insert economics
    (src/suffix_hash.c:66-97) on the tier-merge hot path."""
    Na, Nb = a_hi.shape[0], b_hi.shape[0]
    M = Na + Nb
    P = 1 << max(1, int(M - 1).bit_length())
    pad = P - M
    C = a_cnt.shape[1]

    def lane(a, b_rev, fill):
        parts = [a]
        if pad:
            parts.append(jnp.full(pad, fill, a.dtype))
        parts.append(b_rev)
        return jnp.concatenate(parts)

    cnt_lanes = [lane(a_cnt[:, j], b_cnt[::-1, j], jnp.uint32(0))
                 for j in range(C)]
    if 2 * k < 32:
        # hi is derivable (0 for live, all-ones for dead) — 1 key lane
        lanes = [lane(a_lo, b_lo[::-1], _DEAD)] + cnt_lanes
        lanes = _bitonic_merge_lanes(lanes, 1)
        out_lo = lanes[0][:M]
        out_hi = jnp.where(out_lo == _DEAD, _DEAD, jnp.uint32(0))
        out_cnt = jnp.stack([c[:M] for c in lanes[1:]], axis=1)
    elif k < 32:
        lanes = [lane(a_hi, b_hi[::-1], _DEAD),
                 lane(a_lo, b_lo[::-1], _DEAD)] + cnt_lanes
        lanes = _bitonic_merge_lanes(lanes, 2)
        out_hi = lanes[0][:M]
        out_lo = lanes[1][:M]
        out_cnt = jnp.stack([c[:M] for c in lanes[2:]], axis=1)
    else:
        # k=32: a dead flag rides as a third key lane so live all-G rows
        # (all-ones key, count>0) sort before dead rows and survive the
        # output trim (the only rows the trim may cut are dead)
        a_dead = (a_cnt.astype(jnp.int64).sum(axis=1) == 0).astype(U32)
        b_dead = (b_cnt.astype(jnp.int64).sum(axis=1) == 0).astype(U32)
        lanes = [lane(a_hi, b_hi[::-1], _DEAD),
                 lane(a_lo, b_lo[::-1], _DEAD),
                 lane(a_dead, b_dead[::-1], jnp.uint32(1))] + cnt_lanes
        lanes = _bitonic_merge_lanes(lanes, 3)
        out_hi = lanes[0][:M]
        out_lo = lanes[1][:M]
        out_cnt = jnp.stack([c[:M] for c in lanes[3:]], axis=1)
    return out_hi, out_lo, out_cnt


@functools.partial(jax.jit, static_argnames=("k",))
def _finalize_run_sorted(hi, lo, cnt, k: int = 32):
    """Finalize a SORTED shadow-run: consolidate duplicates (segment
    scatter-add onto each key's first row — the one scatter pass of the
    whole LSM path, paid once per fold), then compact live rows to the
    front. Liveness = segment count-sum > 0, which uniformly handles dead
    padding and, at k=32, a real all-G kmer sharing the all-ones key with
    the padding. Returns (u_hi, u_lo, cnt, n_unique)."""
    N = hi.shape[0]
    C = cnt.shape[1]
    key = (hi.astype(jnp.uint64) << jnp.uint64(32)) | lo.astype(jnp.uint64)
    idx = jnp.arange(N, dtype=I32)
    starts = jnp.zeros(N, bool).at[0].set(True) | (key != jnp.roll(key, 1))
    start_row = jax.lax.cummax(jnp.where(starts, idx, -1))
    seg_cnt = jnp.zeros_like(cnt).at[start_row].add(cnt, mode="drop")
    live = starts & (seg_cnt.astype(jnp.int64).sum(axis=1) > 0)
    key_c = jnp.where(live, key, jnp.uint64(0xFFFFFFFFFFFFFFFF))
    cnt_c = seg_cnt * live[:, None].astype(U32)
    if 2 * k < 32:
        ops = (key_c.astype(U32),) + tuple(cnt_c[:, j] for j in range(C))
        s = jax.lax.sort(ops, num_keys=1)
        hi_s = jnp.zeros(N, U32)
        lo_s = s[0]
        cnt_s = jnp.stack(s[1:], axis=1)
    elif k < 32:
        ops = (key_c,) + tuple(cnt_c[:, j] for j in range(C))
        s = jax.lax.sort(ops, num_keys=1)
        hi_s = (s[0] >> jnp.uint64(32)).astype(U32)
        lo_s = s[0].astype(U32)
        cnt_s = jnp.stack(s[1:], axis=1)
    else:
        deadf = (~live).astype(U32)
        ops = (key_c, deadf) + tuple(cnt_c[:, j] for j in range(C))
        s = jax.lax.sort(ops, num_keys=2)
        hi_s = (s[0] >> jnp.uint64(32)).astype(U32)
        lo_s = s[0].astype(U32)
        cnt_s = jnp.stack(s[2:], axis=1)
    n_unique = live.sum().astype(I32)
    live_s = jnp.arange(N, dtype=I32) < n_unique
    u_hi = jnp.where(live_s, hi_s, 0)
    u_lo = jnp.where(live_s, lo_s, 0)
    return u_hi, u_lo, cnt_s * live_s[:, None].astype(U32), n_unique


# ---------------------------------------------------------------------------
# Key-only unit runs (KMH_KEYONLY_MERGE, default on): for single-source
# stores (counts_n == 1) at k < 32, a sorted shadow-run's count column is
# fully derivable from its keys — every live row is exactly one observation
# (count 1) and dead rows key as all-ones, which no valid k<32 key can
# equal. Such runs carry NO count array (cnt is None), so tier merges move
# one u32 lane at 2k<32 / two at k<32 instead of two/three — a 1.5-2x HBM
# -traffic cut on the counting hot path. k = 32 is excluded (a live all-G
# kmer aliases the sentinel). Counts materialise at fold/spill time.
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("k",))
def _build_run_keys(hi, lo, valid, k: int):
    """Fresh batch -> SORTED key-only unit run: like
    _build_run_direct_sorted but without materialising the count column.
    Only valid for k < 32 (liveness derivable from the sentinel)."""
    key = (hi.astype(jnp.uint64) << jnp.uint64(32)) | lo.astype(jnp.uint64)
    key = jnp.where(valid, key, jnp.uint64(0xFFFFFFFFFFFFFFFF))
    if 2 * k < 32:
        k32 = jax.lax.sort(key.astype(U32), dimension=-1, is_stable=False)
        run_hi = jnp.where(k32 == _DEAD, _DEAD, jnp.uint32(0))
        run_lo = k32
        n_obs = (k32 != _DEAD).sum(dtype=jnp.int64)
    else:
        key_s = jax.lax.sort(key, dimension=-1, is_stable=False)
        run_hi = (key_s >> jnp.uint64(32)).astype(U32)
        run_lo = key_s.astype(U32)
        n_obs = (key_s != jnp.uint64(0xFFFFFFFFFFFFFFFF)).sum(
            dtype=jnp.int64)
    return run_hi, run_lo, n_obs


@functools.partial(jax.jit, static_argnames=("k",))
def _merge_runs_keyonly(a_hi, a_lo, b_hi, b_lo, k: int):
    """Bitonic merge of two key-only unit runs: the count lanes of
    _merge_runs_bitonic simply don't exist, so each stage moves only the
    key lane(s)."""
    Na, Nb = a_hi.shape[0], b_hi.shape[0]
    M = Na + Nb
    P = 1 << max(1, int(M - 1).bit_length())
    pad = P - M

    def lane(a, b_rev):
        parts = [a]
        if pad:
            parts.append(jnp.full(pad, _DEAD, a.dtype))
        parts.append(b_rev)
        return jnp.concatenate(parts)

    if 2 * k < 32:
        lanes = _bitonic_merge_lanes([lane(a_lo, b_lo[::-1])], 1)
        out_lo = lanes[0][:M]
        out_hi = jnp.where(out_lo == _DEAD, _DEAD, jnp.uint32(0))
    else:
        lanes = _bitonic_merge_lanes(
            [lane(a_hi, b_hi[::-1]), lane(a_lo, b_lo[::-1])], 2)
        out_hi = lanes[0][:M]
        out_lo = lanes[1][:M]
    return out_hi, out_lo


@jax.jit
def _unit_run_cnt(hi, lo):
    """Materialise the derived count column of a key-only unit run
    (k < 32): 1 for live rows, 0 for the all-ones dead sentinel."""
    live = ~((hi == _DEAD) & (lo == _DEAD))
    return live[:, None].astype(U32)


@functools.partial(jax.jit, static_argnames=("counts_n", "source"))
def _unit_run_cnt_onehot(hi, lo, counts_n: int, source: int):
    """Materialise the [N, counts_n] one-hot count rows of a key-only
    unit run tagged with ``source`` (k < 32)."""
    live = ~((hi == _DEAD) & (lo == _DEAD))
    onehot = jnp.zeros(counts_n, U32).at[source].set(1)
    return onehot[None, :] * live[:, None].astype(U32)


@functools.partial(jax.jit,
                   static_argnames=("k", "counts_n", "source"))
def _finalize_run_keys(hi, lo, k: int, counts_n: int = 1, source: int = 0):
    """Finalize a key-only unit run WITHOUT the scatter pass: every live
    row counts exactly 1, so a key's consolidated count is its run length
    — (next segment start) - (my start), computable with a reverse cummin
    scan instead of a scatter-add. k < 32 only. Counts land in column ``source`` of the
    [N, counts_n] output. Returns (u_hi, u_lo, cnt, n_unique)."""
    N = hi.shape[0]
    key = (hi.astype(jnp.uint64) << jnp.uint64(32)) | lo.astype(jnp.uint64)
    idx = jnp.arange(N, dtype=I32)
    starts = jnp.zeros(N, bool).at[0].set(True) | (key != jnp.roll(key, 1))
    start_idx = jnp.where(starts, idx, N)
    # nxt[i] = smallest start index >= i; nxt_after[i] = smallest > i
    nxt = jax.lax.cummin(start_idx[::-1])[::-1]
    nxt_after = jnp.concatenate([nxt[1:], jnp.full(1, N, I32)])
    live = starts & (key != jnp.uint64(0xFFFFFFFFFFFFFFFF))
    cnt_row = jnp.where(live, (nxt_after - idx).astype(U32), 0)
    key_c = jnp.where(live, key, jnp.uint64(0xFFFFFFFFFFFFFFFF))
    if 2 * k < 32:
        lo_s, cnt_s = jax.lax.sort((key_c.astype(U32), cnt_row), num_keys=1)
        hi_s = jnp.zeros(N, U32)
    else:
        key_s, cnt_s = jax.lax.sort((key_c, cnt_row), num_keys=1)
        hi_s = (key_s >> jnp.uint64(32)).astype(U32)
        lo_s = key_s.astype(U32)
    n_unique = live.sum().astype(I32)
    live_s = jnp.arange(N, dtype=I32) < n_unique
    u_hi = jnp.where(live_s, hi_s, 0)
    u_lo = jnp.where(live_s, lo_s, 0)
    col = cnt_s * live_s.astype(U32)
    if counts_n == 1:
        cnt_out = col[:, None]
    else:
        onehot = jnp.zeros(counts_n, U32).at[source].set(1)
        cnt_out = onehot[None, :] * col[:, None]
    return u_hi, u_lo, cnt_out, n_unique


_KEYONLY_MERGE = os.environ.get("KMH_KEYONLY_MERGE", "1") != "0"


# KMH_BITONIC_MERGE=0 reverts to the consolidated-run (full re-sort per
# merge) representation. The three functions form a coherent set — the run
# invariant differs — so they switch together.
_BITONIC_MERGE = os.environ.get("KMH_BITONIC_MERGE", "1") != "0"
if _BITONIC_MERGE:
    _build_run_direct = _build_run_direct_sorted
    _merge_runs = _merge_runs_bitonic
    _finalize_run = _finalize_run_sorted
else:
    _build_run_direct = _build_run_direct_consolidated
    _merge_runs = _merge_runs_resort
    _finalize_run = _finalize_run_resort

# Live-prefix run trimming (KMH_TRIM_RUNS=0 disables): a sorted shadow run
# keys every dead window (failed quality / N / padding) all-ones, so its
# live rows are a contiguous prefix of length n_obs. Real quality tracks
# can kill most windows, yet the dead tail would ride every tier merge at
# full capacity. add_run therefore defers each run by
# one call, overlaps an async host copy of its live count with the next
# batch's compute, and slices the run to the pow-2 bucket of its live rows
# before it enters the tiers (_merge_runs_bitonic takes any input
# lengths). Requires the sorted-run invariant, so bitonic mode only.
# KMH_TRIM_GROUP batches share one stacked live-count readback (a scalar
# read is a pipeline barrier); runs wait untrimmed in device memory until
# their group flushes, counted against spill_bytes. The group size is not
# yet tuned for the H100 (ROADMAP S2).
_TRIM_RUNS = os.environ.get("KMH_TRIM_RUNS", "1") != "0"
_TRIM_GROUP = max(1, int(os.environ.get("KMH_TRIM_GROUP", "16")))


@jax.jit
def _distinct_count_sorted(hi, lo, cnt):
    """Distinct live keys of a SORTED shadow run: segment starts whose
    segment isn't dead — one scan, no consolidation, no sort. ``cnt`` may
    be None (key-only run: live = key != all-ones sentinel, k < 32).
    With cnt, a start row is live if its segment's count sum > 0; shadows
    are adjacent, so the segment sum telescopes via the same reverse
    -cummin bound used by _finalize_run_keys — but per-row count sums
    already distinguish dead rows here because dead/pad rows are all-zero
    and every segment with any live shadow has a nonzero row somewhere;
    we count segments that contain at least one nonzero row."""
    key = (hi.astype(jnp.uint64) << jnp.uint64(32)) | lo.astype(jnp.uint64)
    N = hi.shape[0]
    starts = jnp.zeros(N, bool).at[0].set(True) | (key != jnp.roll(key, 1))
    if cnt is None:
        live = key != jnp.uint64(0xFFFFFFFFFFFFFFFF)
        return (starts & live).sum().astype(I32)
    # segment id per row; a segment is live if any of its rows has count
    nz = cnt.astype(jnp.int64).sum(axis=1) > 0
    seg = jnp.cumsum(starts.astype(I32)) - 1
    # max over segment of nz, evaluated at start rows: cummax of nz
    # within segments = compare seg ids
    run_nz = jax.lax.associative_scan(
        lambda a, b: (b[0], jnp.where(a[0] == b[0], a[1] | b[1], b[1])),
        (seg, nz),
    )[1]
    # run_nz[i] = any nz among rows of i's segment up to i; a segment is
    # live iff run_nz at its LAST row. Last rows are starts shifted left.
    last = jnp.concatenate([starts[1:], jnp.ones(1, bool)])
    return (last & run_nz).sum().astype(I32)


@jax.jit
def _distinct_prefixes(u_hi, u_lo, n_unique, suffix_bits):
    """Number of distinct prefixes (kmer >> suffix_bits) among the sorted
    unique keys — the reference's allocated-block count."""
    key = (u_hi.astype(jnp.uint64) << jnp.uint64(32)) | u_lo.astype(jnp.uint64)
    pref = key >> suffix_bits.astype(jnp.uint64)
    live = jnp.arange(u_hi.shape[0], dtype=I32) < n_unique
    first = jnp.zeros(u_hi.shape, bool).at[0].set(True)
    changed = pref != jnp.roll(pref, 1)
    return ((first | changed) & live).sum().astype(I32)


def _use_sort_spectrum() -> bool:
    """Sort-based histogram (default): a 1-key u32 sort + bin-boundary
    binary searches instead of a scatter-add histogram.
    KMH_SORT_SPECTRUM=0 reverts to the scatter form (which one the H100
    prefers is unmeasured, ROADMAP D4). Read by CALLERS and
    passed as a static arg so toggling the env var mid-process takes
    effect (an env read inside the jit would freeze at first trace)."""
    import os

    return os.environ.get("KMH_SORT_SPECTRUM", "1") != "0"


@functools.partial(jax.jit, static_argnames=("max_count", "include_zeros",
                                             "sort_based"))
def _spectrum(cnt0, live, n_alloc_blocks, suffix_bits, n_unique,
              max_count: int, include_zeros: bool,
              sort_based: bool = True):
    if sort_based:
        # histogram by sorting the clamped count column and differencing
        # bin boundaries: counts of value v = searchsorted(v+1) -
        # searchsorted(v) over the sorted column. B+2 binary searches of
        # log N gathers each — negligible next to the sort.
        c = jnp.minimum(cnt0.astype(U32), np.uint32(max_count))
        c = jnp.where(live, c, np.uint32(max_count + 1))
        c_sorted = jax.lax.sort(c, dimension=-1, is_stable=False)
        bins = jnp.arange(max_count + 3, dtype=U32)
        idx = jnp.searchsorted(c_sorted, bins, side="left")
        spec = (idx[1:] - idx[:-1]).astype(jnp.float64)[: max_count + 1]
    else:
        c = jnp.minimum(cnt0.astype(I64), max_count)
        c = jnp.where(live, c, max_count + 1)  # park dead rows off-range
        spec = jnp.zeros(max_count + 2, jnp.float64).at[c].add(1.0)
        spec = spec[: max_count + 1]
    if include_zeros:
        total_cells = n_alloc_blocks.astype(I64) << suffix_bits.astype(I64)
        spec = spec.at[0].add((total_cells - n_unique).astype(jnp.float64))
    return spec


@functools.partial(jax.jit, static_argnames=("max_count", "comb_n"))
def _spectrum_nc(cnt, live, max_count: int, comb, comb_inner, source_min,
                 comb_n: int):
    """Combinatorial multi-source spectrum (sh_count_spectrum_nc,
    src/suffix_hash.c:335-425)."""
    C = cnt.shape[1]
    flags = ((cnt >= source_min[None, :].astype(U32)).astype(I32)
             * (1 << jnp.arange(C, dtype=I32))[None, :]).sum(axis=1)
    cl = jnp.minimum(cnt.astype(I64), max_count)  # [N, C]
    out = jnp.zeros((comb_n * C, max_count + 2), jnp.float64)
    for jj in range(comb_n):
        sel = jnp.where(
            comb_inner[jj] == 1,
            flags == comb[jj],
            (flags & comb[jj]) > 0,
        ) & live
        for s in range(C):
            col = jnp.where(sel, cl[:, s], max_count + 1)
            out = out.at[jj * C + s].add(
                jnp.zeros(max_count + 2, jnp.float64).at[col].add(1.0)
            )
    return out[:, : max_count + 1]


@jax.jit
def _lookup_counts(u_hi, u_lo, cnt, n_unique, q_hi, q_lo):
    lb, ub = srt.lookup_bounds(u_hi, u_lo, n_unique, q_hi, q_lo)
    lb_c = jnp.clip(lb, 0, u_hi.shape[0] - 1)
    found = ub > lb  # the key is present iff its range is non-empty
    rows = jnp.where(found[:, None], cnt[lb_c], 0)
    return rows.astype(I32)


class CountStore:
    """Sorted multi-source count table (``suffix_hash_n`` analogue).

    mode: 'sh' (suffix_hash / suffix_hash_n semantics — spectra over present
    k-mers), 'ktree' (kmer_tree — spectra include the zero cells of
    allocated prefix blocks), or 'khash' (the in-memory ``count.kmers``
    store — no prefix structure).
    """

    def __init__(self, k: int, counts_n: int = 1, prefix_bits: int = 0,
                 suffix_bits: Optional[int] = None, mode: str = "sh",
                 max_size_bytes: Optional[int] = None,
                 budget_semantics: str = "error",
                 spill_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None):
        if not 1 <= k <= 32:
            raise ValueError("k must be in 1..32")
        if counts_n < 1:
            raise ValueError("counts_n must be >= 1")
        if mode not in ("sh", "ktree", "khash"):
            raise ValueError(f"unknown mode {mode!r}")
        self.k = int(k)
        self.counts_n = int(counts_n)
        self.prefix_bits = int(prefix_bits)
        if suffix_bits is None:
            # derive with the reference's clamp (src/suffix_hash.c:19-21,
            # kmer_reader.c:86-95): suffix <= 32, prefix absorbs the rest
            sb = min(2 * k - self.prefix_bits, 32)
            self.suffix_bits = sb
            self.prefix_bits = 2 * k - sb
        else:
            self.suffix_bits = int(suffix_bits)
        # suffix_hash caps (src/suffix_hash.h:14-16); a negative suffix
        # would corrupt ktree spectra / block accounting downstream
        if not 0 <= self.prefix_bits <= 36:
            raise ValueError("prefix_bits must be in 0..36")
        if not 0 <= self.suffix_bits <= 32:
            raise ValueError(
                "suffix_bits must be in 0..32 (got "
                f"{self.suffix_bits}; clamp prefix_bits for small k)"
            )
        self.mode = mode
        self.max_size_bytes = max_size_bytes
        # budget_semantics (ktree only): 'error' raises MemoryError at the
        # first fold whose dense footprint exceeds max_size_bytes (PARITY
        # dev 7, strictly noisier than the C); 'drop' reproduces the
        # reference's behaviour (src/kmer_tree.c:51-76): the first
        # max_size // (4 * 2^suffix_bits) distinct prefixes to appear get
        # dense blocks and k-mers of every later prefix are silently
        # dropped (still counted nowhere, like add_kmer's -2 return).
        if budget_semantics not in ("error", "drop"):
            raise ValueError(f"unknown budget_semantics {budget_semantics!r}")
        if budget_semantics == "drop" and (mode != "ktree"
                                           or max_size_bytes is None):
            raise ValueError("budget_semantics='drop' requires mode='ktree' "
                             "and max_size_bytes")
        self.budget_semantics = budget_semantics
        self._admitted = None  # sorted uint64 prefixes with blocks (drop)
        self._admit_frozen = False
        cap = 64
        self.u_hi = jnp.zeros(cap, U32)
        self.u_lo = jnp.zeros(cap, U32)
        self.cnt = jnp.zeros((cap, counts_n), U32)
        self._n_unique = 0
        self._total_added_dev = jnp.zeros(counts_n, I64)
        self._pending = []
        self._pending_n = 0
        self._runs = []  # size-tiered sorted runs, smallest-capacity last
        self._deferred = []  # (run, live-count) pairs awaiting their trim
        # build a run once this much is pending (elements, pre-dedup)
        self.run_build_size = 1 << 16
        # -- host/disk spill (ROADMAP §3): when device-resident run bytes
        # exceed spill_bytes, the largest runs move off-device (host RAM, or
        # .npy files under spill_dir) and rejoin one at a time at fold time,
        # so the sum of run capacities may exceed HBM as long as the final
        # folded table and any single merge still fit.
        self.spill_bytes = spill_bytes
        self.spill_dir = spill_dir
        self._spilled = []  # list of ('mem', (hi, lo, cnt) np) | ('file', path)
        self._spilled_rows = 0  # total off-device rows (budget accounting)
        self._spill_seq = 0

    @property
    def capacity(self) -> int:
        return int(self.u_hi.shape[0])

    @property
    def keyonly_runs(self) -> bool:
        """True when this store's tier runs may omit the count column
        (key-only unit runs): k < 32 (liveness derivable from the
        all-ones sentinel), sorted-shadow representation. Multi-source
        stores tag each unit run with its source host-side; merges stay
        key-only within a source (the reference's corpus pattern — one
        source per input file) and one-hot counts materialise only when
        sources actually meet in a merge or fold."""
        return _KEYONLY_MERGE and _BITONIC_MERGE and self.k < 32

    @property
    def n_unique(self) -> int:
        """Distinct k-mers; folds pending runs (syncs) when dirty."""
        self.flush()
        return self._n_unique

    @n_unique.setter
    def n_unique(self, v: int) -> None:  # checkpoint restore
        self._n_unique = int(v)

    def peek_n_unique(self) -> int:
        """Exact distinct-key count WITHOUT compaction: merge the tier
        runs into one staged sorted run and scan it (one pass) instead of
        the fold's consolidate + compact sort. The staged run stays in the
        tier list, so no work is thrown away. Progress meters use this —
        at 10^8-key scale the fold's compaction sort is seconds per
        report. A folded base table (e.g. after a checkpoint, which
        folds) joins the count as one more sorted run — its live prefix
        is sorted and unique like any consolidated run — so progress
        reads stay fold-free for the store's whole life. Falls back to a
        full flush only when the sorted-run invariant doesn't hold
        (KMH_BITONIC_MERGE=0) or runs were spilled off-device."""
        if (not _BITONIC_MERGE) or self._spilled:
            self.flush()
            return self._n_unique
        self._build_runs()
        if not self._runs:
            return self._n_unique
        if self._n_unique == 0 and len({r[3] for r in self._runs}) == 1:
            # uniform kind: merges preserve it, so the staged run is kept
            while len(self._runs) > 1:
                self._runs.sort(key=lambda r: int(r[0].shape[0]),
                                reverse=True)
                b = self._runs.pop()
                a = self._runs.pop()
                self._runs.append(self._pad_run_pow2(self._merge_two(a, b)))
            hi, lo, cnt = self._runs[0][:3]
            return int(_distinct_count_sorted(hi, lo, cnt))
        # base table present and/or mixed kinds: count over COPIES,
        # leaving the tier state and the folded base untouched
        if self.k < 32:
            # distinct counting only needs keys (live <=> key != sentinel)
            runs = [(r[0], r[1]) for r in self._runs]
            if self._n_unique > 0:
                b_hi, b_lo, _c = _run_from_merge(
                    self.u_hi, self.u_lo, self.cnt,
                    jnp.asarray(self._n_unique, I32))
                runs.append((b_hi, b_lo))
            while len(runs) > 1:
                runs.sort(key=lambda r: int(r[0].shape[0]), reverse=True)
                b = runs.pop()
                a = runs.pop()
                oh, ol = _merge_runs_keyonly(a[0], a[1], b[0], b[1],
                                             k=self.k)
                oh, ol, _c = self._pad_run_pow2((oh, ol, None))
                runs.append((oh, ol))
            return int(_distinct_count_sorted(runs[0][0], runs[0][1],
                                              None))
        # k == 32: a real all-G key shares the all-ones sentinel, so the
        # count lanes must ride to distinguish it from dead rows
        runs = [self._materialize(r)[:3] for r in self._runs]
        if self._n_unique > 0:
            runs.append(_run_from_merge(self.u_hi, self.u_lo, self.cnt,
                                        jnp.asarray(self._n_unique, I32)))
        while len(runs) > 1:
            runs.sort(key=lambda r: int(r[0].shape[0]), reverse=True)
            b = runs.pop()
            a = runs.pop()
            out = _merge_runs(a[0], a[1], a[2], b[0], b[1], b[2], k=self.k)
            runs.append(self._pad_run_pow2(out))
        return int(_distinct_count_sorted(*runs[0]))

    @property
    def total_added(self) -> np.ndarray:
        return np.asarray(self._total_added_dev)

    @total_added.setter
    def total_added(self, v) -> None:  # checkpoint restore
        self._total_added_dev = jnp.asarray(np.asarray(v, np.int64))

    def add_kmers(self, hi, lo, valid, source: int = 0,
                  defer: bool = False) -> "CountStore":
        """Merge a batch of observed k-mers (device arrays, any shape;
        flattened) into the store. ``valid`` masks real observations.

        With ``defer=True`` the batch is queued; queued work becomes a
        sorted *run* once ``run_build_size`` elements accumulate, and runs
        of equal capacity merge pairwise (size-tiered LSM) — each element
        sees O(log(N/B)) merges instead of a whole-store re-sort per batch.
        No host-device sync happens on this path; any query/flush folds the
        runs first. Eager adds are deferred adds followed by a flush.
        """
        if not 0 <= source < self.counts_n:
            raise ValueError("source out of range")
        hi = jnp.ravel(hi)
        lo = jnp.ravel(lo)
        valid = jnp.ravel(valid)
        if self.budget_semantics == "drop":
            # raw streams carry true in-array stream order, so admission
            # here is fully faithful to the C's per-kmer allocation walk
            keys = ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
                    | np.asarray(lo).astype(np.uint64))
            v_h = np.asarray(valid).astype(bool)
            pref = keys >> np.uint64(self.suffix_bits)
            self._admit_prefixes(pref[v_h])
            valid = jnp.asarray(v_h & np.isin(pref, self._admitted))
        self._total_added_dev = self._total_added_dev.at[source].add(
            valid.sum(dtype=I64)
        )
        self._pending.append((hi, lo, valid, source))
        self._pending_n += int(hi.shape[0])
        if not defer:
            self.flush()
        elif self._pending_n >= self.run_build_size:
            self._build_runs()
        return self

    # -- ktree 'drop' budget semantics (src/kmer_tree.c:51-76) --------------
    @property
    def _budget_blocks(self) -> int:
        return int(self.max_size_bytes) // (4 << self.suffix_bits)

    def _admit_prefixes(self, pref_stream: np.ndarray) -> None:
        """Admit new prefixes, in first-occurrence order of
        ``pref_stream``, until the block budget fills — after which the
        admitted set is frozen forever (the reference can never allocate
        another block once current + block > max_size)."""
        if self._admitted is None:
            self._admitted = np.empty(0, np.uint64)
        if self._admit_frozen:
            return
        uniq, first = np.unique(pref_stream, return_index=True)
        fresh = ~np.isin(uniq, self._admitted)
        new, first = uniq[fresh], first[fresh]
        if not new.size:
            return
        new = new[np.argsort(first, kind="stable")]
        space = self._budget_blocks - self._admitted.size
        if new.size > space:
            self._admit_frozen = True
        self._admitted = np.union1d(self._admitted,
                                    new[:max(0, space)])

    def _budget_filter_run(self, hi, lo, cnt, n_obs, source):
        """Drop-mode filter for a sorted run: admit this run's prefixes
        (in KEY order — the documented within-batch deviation, PARITY
        dev 7) and strip rows of unadmitted prefixes, preserving run form
        (sorted live keys, all-ones dead tail). Host-side: this is a
        fidelity mode, not a throughput path."""
        keys = ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
                | np.asarray(lo).astype(np.uint64))
        if cnt is not None:
            cnt_h = np.asarray(cnt)
            live = cnt_h.sum(axis=1) > 0
        else:
            cnt_h = None
            live = keys != np.uint64(0xFFFFFFFFFFFFFFFF)
        pref = keys >> np.uint64(self.suffix_bits)
        self._admit_prefixes(pref[live])
        drop = live & ~np.isin(pref, self._admitted)
        if not drop.any():
            return hi, lo, cnt, n_obs
        keep = live & ~drop
        nk = int(keep.sum())
        out_keys = np.full(keys.shape[0], 0xFFFFFFFFFFFFFFFF, np.uint64)
        out_keys[:nk] = keys[keep]
        o_hi = jnp.asarray((out_keys >> np.uint64(32)).astype(np.uint32))
        o_lo = jnp.asarray(out_keys.astype(np.uint32))
        if cnt_h is not None:
            out_cnt = np.zeros_like(cnt_h)
            out_cnt[:nk] = cnt_h[keep]
            o_cnt = jnp.asarray(out_cnt)
            dropped = cnt_h[drop].sum(axis=0).astype(np.int64)
        else:
            o_cnt = None
            dropped = np.zeros(self.counts_n, np.int64)
            dropped[source] = int(drop.sum())
        return o_hi, o_lo, o_cnt, n_obs - jnp.asarray(dropped)

    def add_run(self, hi, lo, cnt, n_obs, source: int = 0) -> "CountStore":
        """Append a prebuilt sorted run (run-form arrays: unique live keys,
        dead rows keyed all-ones with zero counts) and re-balance tiers.
        ``n_obs`` is the [counts_n] device vector of observations folded
        into the run — accounted into total_added. This is the zero-eager
        -dispatch fast path: callers fuse FSM + canonicalise + run build
        into one jit and hand the result straight to the store. ``cnt``
        may be None for a key-only unit run of ``source`` (see
        ``keyonly_runs``)."""
        if cnt is None and not self.keyonly_runs:
            raise ValueError("key-only runs not supported by this store")
        if not 0 <= source < self.counts_n:
            raise ValueError("source out of range")
        if self.budget_semantics == "drop":
            hi, lo, cnt, n_obs = self._budget_filter_run(
                hi, lo, cnt, n_obs, source)
        self._total_added_dev = self._total_added_dev + n_obs.astype(I64)
        run = (hi, lo, cnt, source if cnt is None else None)
        if self._trim_runs():
            # defer up to KMH_TRIM_GROUP runs, then read all their live
            # counts in ONE stacked transfer: a device->host scalar read
            # is a pipeline barrier, paid once per group, not per batch
            live = jnp.asarray(n_obs).sum()
            try:
                live.copy_to_host_async()
            except AttributeError:  # non-committed/array-like inputs
                pass
            self._deferred.append((run, live))
            if len(self._deferred) >= _TRIM_GROUP or (
                    self.spill_bytes is not None
                    and self._device_run_bytes() > self.spill_bytes):
                # flush early under a spill budget: deferred runs occupy
                # HBM at full (untrimmed) capacity, and _spill_if_needed
                # only sees runs that have been tiered in
                self._flush_deferred()
        else:
            self._runs.append(run)
            self._compact_tiers()
        return self

    def _trim_runs(self) -> bool:
        """Live-prefix trimming needs the sorted-run invariant (dead rows
        at the tail) and an untouched live prefix — the budget 'drop'
        filter rewrites rows in place, so it opts out."""
        return (_TRIM_RUNS and _BITONIC_MERGE
                and self.budget_semantics != "drop")

    def _flush_deferred(self) -> None:
        """Resolve the deferred runs: one stacked readback of their live
        counts, slice each to the pow-2 bucket that holds its live
        prefix, and tier them in."""
        d = self._deferred
        if not d:
            return
        self._deferred = []
        lives = np.asarray(jnp.stack([live for _r, live in d]))
        for (run, _l), n in zip(d, lives):
            cap = int(run[0].shape[0])
            new = _next_pow2(max(int(n), 1 << 6))
            if new < cap:
                hi, lo, cnt = run[0][:new], run[1][:new], run[2]
                if cnt is not None:
                    cnt = cnt[:new]
                run = (hi, lo, cnt, run[3])
            self._runs.append(run)
        self._compact_tiers()

    def _build_runs(self) -> None:
        """Turn pending batches into sorted runs (one per source present)
        and re-balance the tiers."""
        self._flush_deferred()
        if not self._pending:
            return
        by_source: dict = {}
        for hi, lo, valid, source in self._pending:
            by_source.setdefault(source, []).append((hi, lo, valid))
        self._pending = []
        self._pending_n = 0
        for source, batches in sorted(by_source.items()):
            hi = jnp.concatenate([b[0] for b in batches])
            lo = jnp.concatenate([b[1] for b in batches])
            valid = jnp.concatenate([b[2] for b in batches])
            cap_b = _next_pow2(int(hi.shape[0]))
            if cap_b != hi.shape[0]:  # bucket shapes for compile reuse
                pad = cap_b - hi.shape[0]
                hi = jnp.pad(hi, (0, pad))
                lo = jnp.pad(lo, (0, pad))
                valid = jnp.pad(valid, (0, pad))
            if self.keyonly_runs:
                r_hi, r_lo, _n = _build_run_keys(hi, lo, valid, self.k)
                self._runs.append((r_hi, r_lo, None, source))
            else:
                onehot = jnp.zeros(self.counts_n, U32).at[source].set(1)
                r_hi, r_lo, r_cnt, _n = _build_run_direct(
                    hi, lo, valid, onehot, self.k
                )
                self._runs.append((r_hi, r_lo, r_cnt, None))
        self._compact_tiers()

    def _materialize(self, run):
        """Key-only unit run -> cnt-carrying run (one-hot of its tag)."""
        hi, lo, cnt, tag = run
        if cnt is not None:
            return run
        if self.counts_n == 1:
            return (hi, lo, _unit_run_cnt(hi, lo), None)
        return (hi, lo, _unit_run_cnt_onehot(hi, lo, self.counts_n, tag),
                None)

    def _merge_two(self, a, b):
        """Tier-merge two runs, staying key-only when both are unit runs
        of the SAME source (the hot case — the reference's corpus feeds
        one source per file); any other pair materialises counts."""
        if a[3] is not None and a[3] == b[3]:
            oh, ol = _merge_runs_keyonly(a[0], a[1], b[0], b[1], k=self.k)
            return (oh, ol, None, a[3])
        a = self._materialize(a)
        b = self._materialize(b)
        out = _merge_runs(a[0], a[1], a[2], b[0], b[1], b[2], k=self.k)
        return out + (None,)

    @staticmethod
    def _pad_run_pow2(run):
        """Pad a run to power-of-two capacity with dead rows, so merge
        shapes stay in a small (2^a, 2^b) set and XLA programs are reused
        (each fresh shape is a fresh compile)."""
        hi, lo, cnt = run[0], run[1], run[2]
        cap = _next_pow2(int(hi.shape[0]))
        if cap == hi.shape[0]:
            return run
        pad = cap - hi.shape[0]
        hi = jnp.concatenate([hi, jnp.full(pad, _DEAD, U32)])
        lo = jnp.concatenate([lo, jnp.full(pad, _DEAD, U32)])
        if cnt is not None:
            cnt = jnp.pad(cnt, ((0, pad), (0, 0)))
        return (hi, lo, cnt) + run[3:]

    def _compact_tiers(self) -> None:
        # pair by (capacity, kind): key-only runs only pair within their
        # source tag, cnt runs pair with cnt runs
        self._runs = lsm_compact(
            self._runs,
            lambda r: (int(r[0].shape[0]),
                       "cnt" if r[3] is None else r[3]),
            self._merge_two,
        )
        self._spill_if_needed()

    # -- host/disk spill ----------------------------------------------------
    def _device_run_bytes(self) -> int:
        # deferred (not-yet-trimmed) runs occupy HBM too; count them so
        # the spill budget can't be overshot by a whole trim group
        return sum(
            int(r[0].shape[0])
            * (8 + (4 * self.counts_n if r[2] is not None else 0))
            for r in self._runs
        ) + sum(
            int(r[0].shape[0])
            * (8 + (4 * self.counts_n if r[2] is not None else 0))
            for r, _l in self._deferred
        )

    def _spill_one(self) -> None:
        """Move the largest device-resident run off-device. The run is
        compacted first (finalize + trim to pow2) so the off-device copy is
        as small as its unique-key count allows, then stored either as host
        numpy arrays or as an .npz under spill_dir."""
        self._runs.sort(key=lambda r: int(r[0].shape[0]))
        hi, lo, cnt, _tag = self._materialize(self._runs.pop())
        u_hi, u_lo, u_cnt, n_u = _finalize_run(hi, lo, cnt, k=self.k)
        n_u = int(n_u)
        cap = _next_pow2(n_u)
        a_hi = np.asarray(u_hi[:cap]).copy()
        a_lo = np.asarray(u_lo[:cap]).copy()
        a_cnt = np.asarray(u_cnt[:cap]).copy()
        # back to run form: finalize keys dead rows 0; rejoin needs all-ones
        a_hi[n_u:] = 0xFFFFFFFF
        a_lo[n_u:] = 0xFFFFFFFF
        if self.spill_dir is not None:
            os.makedirs(self.spill_dir, exist_ok=True)
            path = os.path.join(
                self.spill_dir, f"kmh_spill_{id(self):x}_{self._spill_seq}.npz"
            )
            np.savez(path, hi=a_hi, lo=a_lo, cnt=a_cnt)
            self._spilled.append(("file", path))
        else:
            self._spilled.append(("mem", (a_hi, a_lo, a_cnt)))
        self._spilled_rows += cap  # row accounting for _ranged_fold_needed
        self._spill_seq += 1

    def _spill_if_needed(self) -> None:
        if self.spill_bytes is None:
            return
        # spilling the LAST run is allowed: flush seeds from spilled runs,
        # and a single over-budget top tier (the common shape late in a
        # full-corpus ingest) must be able to leave the device
        while self._runs and self._device_run_bytes() > self.spill_bytes:
            self._spill_one()

    def _ranged_fold_needed(self, acc_rows: int) -> bool:
        """True when the plain spill rejoin's merge workspace would blow
        the device budget: a single bitonic merge of the accumulator with
        a spilled run peaks at ~3x their combined bytes, past the budget
        of :func:`_fold_budget_bytes` at the reference's full-corpus
        scale (7.7e8 distinct, test.R:491-505)."""
        rows = acc_rows + self._spilled_rows
        return rows * (8 + 4 * self.counts_n) > _fold_budget_bytes()

    def _fold_spilled_ranged(self, acc):
        """Out-of-core fold: key-RANGE-partitioned spill rejoin for
        tables beyond the fold budget (the reference's full-corpus regime
        — 7.7e8 distinct keys is a ~9-12 GB table whose one-shot merge
        workspace is ~3x that).

        ``acc`` is the already-compacted accumulator as HOST arrays
        (packed u64 keys, cnt) or None — the caller must have dropped
        every device reference to it (the whole point is that the device
        never holds the accumulator and the output pieces together). The
        key space splits into ranges sized so each range's merge +
        consolidate runs in a small device footprint; pieces concatenate
        into the final compact table (ranges are disjoint and ascending,
        so the concatenation is globally sorted + unique). Peak device
        bytes ~ final table + 3x one range, instead of ~3x the total.
        Returns (u_hi, u_lo, u_cnt, n_unique)."""
        ALL1 = np.uint64(0xFFFFFFFFFFFFFFFF)
        host_runs = [acc] if acc is not None else []
        spilled, self._spilled = self._spilled, []
        self._spilled_rows = 0
        for tag, payload in spilled:
            if tag == "file":
                with np.load(payload) as z:
                    a_hi, a_lo, a_cnt = z["hi"], z["lo"], z["cnt"]
                os.remove(payload)
            else:
                a_hi, a_lo, a_cnt = payload
            keys = (a_hi.astype(np.uint64) << np.uint64(32)) \
                | a_lo.astype(np.uint64)
            # dead tail: all-ones key with zero counts (a live all-G
            # k=32 key shares the sentinel but keeps its counts)
            dead = (keys == ALL1) & (a_cnt.sum(axis=1) == 0)
            n_live = int(len(keys) - dead.sum())
            if n_live:
                host_runs.append((keys[:n_live], a_cnt[:n_live]))
        if not host_runs:
            z = jnp.zeros(0, U32)
            return z, z, jnp.zeros((0, self.counts_n), U32), 0
        # 2. range splitters from the largest run (evenly spaced ranks)
        total_rows = sum(len(r[0]) for r in host_runs)
        # /8: a range's merge chain + finalize transient runs ~3-4x its
        # bytes, and the accumulated output pieces share the device
        per_range = max(1, _fold_budget_bytes() // 8
                        // (8 + 4 * self.counts_n))
        n_ranges = max(1, -(-total_rows // per_range))
        big = max(host_runs, key=lambda r: len(r[0]))[0]
        spl = [big[min(len(big) - 1, (i * len(big)) // n_ranges)]
               for i in range(1, n_ranges)]
        bounds = [np.uint64(0)] + list(spl) + [ALL1]
        # 3. merge + consolidate one range at a time on device
        pieces = []
        n_total = 0
        for r in range(n_ranges):
            s_lo, s_hi = bounds[r], bounds[r + 1]
            merged = None
            live_rows = 0  # true rows in the chain (dead pad excluded)
            for keys, cnts in host_runs:
                i0 = int(np.searchsorted(keys, s_lo, side="left"))
                i1 = (int(np.searchsorted(keys, s_hi, side="left"))
                      if r + 1 < n_ranges else len(keys))
                if i1 <= i0:
                    continue
                cap = _next_pow2(i1 - i0)
                kh = np.full(cap, 0xFFFFFFFF, np.uint32)
                kl = np.full(cap, 0xFFFFFFFF, np.uint32)
                kc = np.zeros((cap, self.counts_n), np.uint32)
                kh[: i1 - i0] = (keys[i0:i1] >> np.uint64(32)).astype(
                    np.uint32)
                kl[: i1 - i0] = keys[i0:i1].astype(np.uint32)
                kc[: i1 - i0] = cnts[i0:i1]
                dev = (jnp.asarray(kh), jnp.asarray(kl), jnp.asarray(kc))
                live_rows += i1 - i0
                if merged is None:
                    merged = dev
                else:
                    # merge, then TRIM the chain to pow2(live): merge
                    # output is sorted with the dead pad at the tail,
                    # and without the trim the pow2 paddings CASCADE
                    # (cap(cap(a)+cap(b)) ~ 4x live), blowing the
                    # bitonic network (and its HLO temps) up to 2^29+
                    # at full-corpus scale — the j_spill OOM. pow2
                    # shapes keep the (2^a, 2^b) merge-program set
                    # small (each fresh shape is a fresh compile).
                    m = _merge_runs(merged[0], merged[1], merged[2],
                                    *dev, k=self.k)
                    cap_l = _next_pow2(live_rows)
                    if cap_l < m[0].shape[0]:
                        m = (m[0][:cap_l], m[1][:cap_l], m[2][:cap_l])
                    merged = self._pad_run_pow2(m)[:3]
            if merged is None:
                continue
            p_hi, p_lo, p_cnt, p_n = _finalize_run(*merged, k=self.k)
            p_n = int(p_n)
            del merged
            if p_n:
                pieces.append((p_hi[:p_n], p_lo[:p_n], p_cnt[:p_n]))
                n_total += p_n
        if not pieces:
            z = jnp.zeros(0, U32)
            return z, z, jnp.zeros((0, self.counts_n), U32), 0
        return (jnp.concatenate([p[0] for p in pieces]),
                jnp.concatenate([p[1] for p in pieces]),
                jnp.concatenate([p[2] for p in pieces]), n_total)

    def _fold_spilled(self, hi, lo, cnt):
        """Merge spilled runs back into the accumulator one at a time
        (largest resident footprint at any moment: accumulator + one run)."""
        spilled, self._spilled = self._spilled, []
        self._spilled_rows = 0
        for tag, payload in spilled:
            if tag == "file":
                with np.load(payload) as z:
                    a_hi, a_lo, a_cnt = z["hi"], z["lo"], z["cnt"]
                os.remove(payload)
            else:
                a_hi, a_lo, a_cnt = payload
            hi, lo, cnt = _merge_runs(
                hi, lo, cnt,
                jnp.asarray(a_hi), jnp.asarray(a_lo), jnp.asarray(a_cnt),
                k=self.k,
            )
            cap = _next_pow2(int(hi.shape[0]))
            if cap != hi.shape[0]:
                pad = cap - hi.shape[0]
                hi = jnp.concatenate([hi, jnp.full(pad, _DEAD, U32)])
                lo = jnp.concatenate([lo, jnp.full(pad, _DEAD, U32)])
                cnt = jnp.pad(cnt, ((0, pad), (0, 0)))
        return hi, lo, cnt

    def flush(self) -> "CountStore":
        """Fold pending batches and all runs into the compact sorted base
        table (the only point that syncs with the host)."""
        self._build_runs()
        if not self._runs and not self._spilled:
            return self
        if self._n_unique > 0:
            self._runs.append(
                _run_from_merge(self.u_hi, self.u_lo, self.cnt,
                                jnp.asarray(self._n_unique, I32))
                + (None,)
            )
        # beyond-HBM fold: when the rejoin will go out-of-core anyway,
        # do NOT merge the residual device runs into one accumulator
        # first — that pre-merge (concat + finalize at the combined size)
        # is itself a multiple of the total bytes and can exhaust device
        # memory at the full-corpus scale. Spill every run to host individually
        # (each bounded by spill_bytes) and range-fold from host only.
        if (self._spilled and self.spill_bytes is not None
                and self._ranged_fold_needed(
                    sum(int(r[0].shape[0]) for r in self._runs))):
            while self._runs:
                self._spill_one()
            u_hi, u_lo, u_cnt, n_u = self._fold_spilled_ranged(None)
            return self._install_base(u_hi, u_lo, u_cnt, int(n_u))
        # fold smallest-first so intermediate merges stay small; keep the
        # accumulator padded to a power of two so merge shapes stay in a
        # small (2^a, 2^b) set and XLA programs are reused across folds
        self._runs.sort(key=lambda r: int(r[0].shape[0]), reverse=True)
        if not self._runs:  # only spilled runs: seed from the first one
            spilled0 = self._spilled.pop()
            if spilled0[0] == "file":
                with np.load(spilled0[1]) as z:
                    a = (z["hi"], z["lo"], z["cnt"])
                os.remove(spilled0[1])
            else:
                a = spilled0[1]
            self._spilled_rows -= len(a[0])
            self._runs.append(tuple(jnp.asarray(x) for x in a) + (None,))
        run = self._runs.pop()
        while self._runs:
            run = self._pad_run_pow2(
                self._merge_two(run, self._runs.pop()))
        hi, lo, cnt, tag = run
        if cnt is None and not self._spilled:
            # all-key-only single-source fold: scatter-free consolidation
            u_hi, u_lo, u_cnt, n_u = _finalize_run_keys(
                hi, lo, k=self.k, counts_n=self.counts_n, source=tag)
        else:
            if cnt is None:
                _h, _l, cnt, _t = self._materialize(run)
                _h = _l = None
            if self._spilled:
                hi, lo, cnt = self._fold_spilled(hi, lo, cnt)
            u_hi, u_lo, u_cnt, n_u = _finalize_run(hi, lo, cnt,
                                                   k=self.k)
        return self._install_base(u_hi, u_lo, u_cnt, int(n_u))

    def _install_base(self, u_hi, u_lo, u_cnt, n_u: int) -> "CountStore":
        """Common flush tail: trim/pad the compact table to its pow-2
        capacity and make it the base."""
        self._n_unique = n_u
        new_cap = _next_pow2(self._n_unique)
        if new_cap < u_hi.shape[0]:
            u_hi, u_lo, u_cnt = (u_hi[:new_cap], u_lo[:new_cap],
                                 u_cnt[:new_cap])
        elif new_cap > u_hi.shape[0]:
            pad = new_cap - u_hi.shape[0]
            u_hi = jnp.pad(u_hi, (0, pad))
            u_lo = jnp.pad(u_lo, (0, pad))
            u_cnt = jnp.pad(u_cnt, ((0, pad), (0, 0)))
        self.u_hi, self.u_lo, self.cnt = u_hi, u_lo, u_cnt
        self._check_budget()
        return self

    def _check_budget(self):
        """Soft memory budget like kmer_tree's max_size (kmer_tree.c:57-67):
        estimated dense-block footprint must stay under the cap. Deviation
        (PARITY.md): the reference stops allocating new blocks and silently
        drops their k-mers; we raise after the fold that first exceeds."""
        if (self.max_size_bytes is None or self.mode != "ktree"
                or self.budget_semantics == "drop"):
            return  # drop mode enforces the budget by prefix admission
        est = int(self.n_alloc_blocks()) * 4 * (1 << self.suffix_bits)
        if est > self.max_size_bytes:
            raise MemoryError(
                f"kmer_tree budget exceeded: estimated {est} bytes > "
                f"max_size {self.max_size_bytes}"
            )

    def n_alloc_blocks(self) -> int:
        self.flush()
        return int(
            _distinct_prefixes(
                self.u_hi, self.u_lo, jnp.asarray(self.n_unique, I32),
                jnp.asarray(self.suffix_bits, I64),
            )
        )

    # -- queries ------------------------------------------------------------
    def lookup(self, q_hi, q_lo) -> np.ndarray:
        """Per-query count rows [n, counts_n]; zeros for absent k-mers
        (sh_kmer_count_n semantics, src/suffix_hash.c:283-332)."""
        self.flush()
        rows = _lookup_counts(
            self.u_hi, self.u_lo, self.cnt, jnp.asarray(self.n_unique, I32),
            jnp.ravel(q_hi), jnp.ravel(q_lo),
        )
        return np.asarray(rows)

    def counts_dict(self) -> dict:
        """Host export: packed kmer -> count row (tests / small stores)."""
        self.flush()
        u_hi = np.asarray(self.u_hi)[: self.n_unique].astype(np.uint64)
        u_lo = np.asarray(self.u_lo)[: self.n_unique].astype(np.uint64)
        keys = (u_hi << np.uint64(32)) | u_lo
        cnt = np.asarray(self.cnt)[: self.n_unique]
        return {int(kk): cnt[i].tolist() for i, kk in enumerate(keys)}

    # -- spectra ------------------------------------------------------------
    def spectrum(self, max_count: int) -> np.ndarray:
        """kmer.spec.kt / kmer.spec.sh (src/kmer_hash.c:975-1008): histogram
        of source-0 counts, clamped into the last bin."""
        if not 1 <= max_count <= (1 << 30):
            raise ValueError("Unsuitable value of max_count")
        self.flush()
        include_zeros = self.mode == "ktree"
        n_alloc = (jnp.asarray(self.n_alloc_blocks(), I32) if include_zeros
                   else jnp.asarray(0, I32))
        live = jnp.arange(self.capacity, dtype=I32) < self.n_unique
        return np.asarray(
            _spectrum(
                self.cnt[:, 0], live, n_alloc,
                jnp.asarray(self.suffix_bits, I64),
                jnp.asarray(self.n_unique, I64), max_count, include_zeros,
                sort_based=_use_sort_spectrum(),
            )
        )

    def spectrum_n(self, max_count: int, comb: Sequence[int],
                   comb_inner: Sequence[int],
                   source_min: Sequence[int]) -> np.ndarray:
        """kmer.spec.sh.n (src/kmer_hash.c:1010-1038): (comb_n*counts_n) x
        (max_count+1) combination spectra."""
        comb = np.asarray(comb, np.int32)
        comb_inner = np.asarray(comb_inner, np.int32)
        source_min = np.asarray(source_min, np.int64)
        if comb_inner.shape != comb.shape:
            raise ValueError("comb_inner must match comb in length")
        if len(source_min) != self.counts_n:
            raise ValueError("source_min must have counts_n entries")
        if ((comb_inner < 0) | (comb_inner > 1)).any():
            raise ValueError("comb_inner values must be 0 or 1")
        if (comb >= (1 << self.counts_n)).any():
            raise ValueError("comb values must be < 2^counts_n")
        self.flush()
        live = jnp.arange(self.capacity, dtype=I32) < self.n_unique
        return np.asarray(
            _spectrum_nc(
                self.cnt, live, max_count, jnp.asarray(comb),
                jnp.asarray(comb_inner), jnp.asarray(source_min),
                int(len(comb)),
            )
        )
