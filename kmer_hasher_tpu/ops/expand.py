"""Compacted chunk-expansion plans: table-size-independent pair/hit streaming.

The chunked emitters (pair tables, ``seq.kmer.pos`` hits, ``kmer.pairs``
cross-products — src/kmer_hash.c:1054-1147,1151-1203, src/kmer_pos.c:101-136)
map each output row ``g`` in ``[start, start+Q)`` to its source row via
``searchsorted(cum, g)``. The gather-free rank merge (ops/sort.
``expand_rank_merge_i64``) removed the per-row binary-search gathers, but it
still drags all ``T`` table rows through device memory for EVERY chunk, and
~4 payload gathers per output row remain.

A *plan* compacts the producing rows (``count > 0``) once per stream, in
original order, making the compacted cumulative array STRICTLY increasing.
Then consecutive output rows advance the source rank by at most 1, so a
chunk of ``Q`` rows touches at most ``Q`` consecutive compacted rows: each
chunk becomes one scalar bound + a ``Q``-sized ``dynamic_slice`` + a
``2Q``-element merge-join. Per-chunk cost no longer scales with the table,
and multi-chunk drains stop re-paying the full-table merge.

Build cost is one multi-lane ``lax.sort`` over the table (~the cost of ONE
old-style chunk), amortized across the whole drain; callers dispatch to the
plain path when a stream is trivially small (see ``use_plan``).
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from . import sort as srt

I32 = jnp.int32
I64 = jnp.int64
_DEAD = jnp.int64(1) << 62  # sort-key flag: row produces no output
_CUM_SENT = jnp.int64(0x7FFFFFFFFFFFFFFF)  # past-live cum sentinel


def use_plan(total: int, table_rows: int, capacity: int) -> bool:
    """Static dispatch: plan only for genuinely multi-chunk drains — there
    the build sort amortizes and the plain path would re-pay its
    table-sized rank merge for every chunk. Single-chunk drains keep the
    plain single-program path (one full-table merge ≈ one plan sort, but
    half the compiled programs and no extra pass)."""
    del table_rows
    return total > capacity


@functools.partial(jax.jit, static_argnames=("pad", "n_cols"))
def _build_plan(counts: jax.Array, cols: Tuple[jax.Array, ...], pad: int,
                n_cols: int):
    T = counts.shape[0]
    idx = jnp.arange(T, dtype=I64)
    key = jnp.where(counts > 0, idx, idx | _DEAD)
    lanes = jax.lax.sort((key, counts) + tuple(cols), num_keys=1,
                         is_stable=False)
    key_s, c_s = lanes[0], lanes[1]
    live = key_s < _DEAD
    c_live = jnp.where(live, c_s, 0).astype(I64)
    cum = jnp.cumsum(c_live)
    total = cum[-1]
    run_start = cum - c_live
    cum = jnp.where(live, cum, _CUM_SENT)
    w = (key_s & (_DEAD - jnp.int64(1))).astype(I32)

    def padded(a, fill):
        return jnp.concatenate([a, jnp.full(pad, fill, a.dtype)])

    cols_pad = tuple(padded(c, 0) for c in lanes[2:2 + n_cols])
    return (padded(cum, _CUM_SENT), padded(run_start, 0), padded(w, 0),
            cols_pad, total)


class ExpansionPlan:
    """Per-stream compacted expansion state.

    ``counts``: i32[T] output rows produced by each table row (0 allowed;
    rows past the live prefix must already be zeroed by the caller).
    ``cols``: i32[T] payload columns to carry through the compaction (each
    output row reads its source row's value gather-free at ``src``).
    ``pad``: slice slack — at least the drain chunk capacity.
    """

    def __init__(self, counts: jax.Array, cols: Tuple[jax.Array, ...],
                 pad: int):
        (self.cum, self.run_start, self.w, self.cols,
         total) = _build_plan(counts, tuple(cols), pad, len(cols))
        self.total = int(total)
        self.pad = pad


def chunk_src(plan_cum: jax.Array, plan_run_start: jax.Array,
              start: jax.Array, capacity: int):
    """Map output rows ``[start, start+capacity)`` to compacted source rows.

    Returns (src i32[Q] — index into the plan's padded arrays, t i32[Q] —
    rank within the source row's run, g i64[Q]). Trace-time helper for the
    flavor kernels below (not itself jitted).

    The slice size equals ``capacity``: the compacted cum is strictly
    increasing, so at most ``capacity - 1`` values fall in
    ``(start, start + capacity - 1]`` and every selected source row lies in
    ``[r0, r0 + capacity)`` where ``r0 = searchsorted_right(cum, start)``.
    """
    Tp = plan_cum.shape[0]
    r0 = srt.searchsorted_i64(plan_cum, jnp.reshape(start, (1,)), Tp,
                              side="right")[0]
    sl = jax.lax.dynamic_slice(plan_cum, (r0,), (capacity,))
    g = start + jnp.arange(capacity, dtype=I64)
    rr = srt.expand_rank_merge_i64(sl, capacity, g)
    src = r0.astype(I32) + rr
    t = (g - plan_run_start[src]).astype(I32)
    return src, t, g


@functools.partial(jax.jit, static_argnames=("k", "capacity"))
def hit_chunk_planned(s_pos, plan_cum, plan_rs, plan_w, plan_lb, total,
                      k: int, start, capacity: int):
    """Planned form of query._hit_chunk: (i, j) hit rows for seq.kmer.pos
    (i = w + k, the 1-based query position of the window's last base)."""
    src, t, g = chunk_src(plan_cum, plan_rs, start, capacity)
    i_col = (plan_w[src] + k).astype(I32)
    j_col = s_pos[jnp.clip(plan_lb[src] + t, 0, s_pos.shape[0] - 1)]
    ok = g < total
    return jnp.stack([i_col, j_col], axis=1), ok


@functools.partial(jax.jit, static_argnames=("capacity",))
def pair_hit_chunk_planned(b_pos, plan_cum, plan_rs, plan_x, plan_lb, total,
                           start, capacity: int):
    """Planned form of query._pair_hit_chunk: (a_pos, b_pos) rows for
    kmer.pairs (plan_x carries a_pos at the source window)."""
    src, t, g = chunk_src(plan_cum, plan_rs, start, capacity)
    rows = jnp.stack(
        [plan_x[src],
         b_pos[jnp.clip(plan_lb[src] + t, 0, b_pos.shape[0] - 1)]], axis=1
    )
    ok = g < total
    return rows, ok


@functools.partial(jax.jit, static_argnames=("capacity",))
def pair_chunk_planned(s_pos, plan_cum, plan_rs, plan_w, plan_i, plan_x,
                       total, start, capacity: int):
    """Planned form of position_index._pair_chunk: (i, x, y) pair-table
    rows (x carried in the plan; y = s_pos[j + 1 + t] stays the one true
    data gather)."""
    src, t, g = chunk_src(plan_cum, plan_rs, start, capacity)
    j = plan_w[src]
    y = s_pos[jnp.clip(j + 1 + t, 0, s_pos.shape[0] - 1)]
    rows = jnp.stack([plan_i[src], plan_x[src], y], axis=1)
    ok = g < total
    return rows, ok
