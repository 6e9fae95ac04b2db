"""Streaming k-mer iterators as batched finite-state scans.

The reference's FASTQ counting paths walk each read with a stateful iterator
whose accept/reject decisions depend on data-dependent restarts
(src/kmer_util.c:95-161 for the quality-likelihood iterator;
src/kmer_hash.c:296-332 for the per-base-threshold loops). Those recurrences
cannot be window-parallelised without changing semantics, so here they run
as a ``lax.scan`` over base positions whose tiny per-read state is
vectorised across the whole read batch — each scan step is elementwise
work over thousands of reads at once. ``ops.pallas_scan`` runs the float32
likelihood FSM as one GPU kernel with the state in registers.

Two FSMs:

* :func:`ll_scan` — the flagship reader-pool filter: a window is accepted
  iff its running log-likelihood beats ``min_ll``. Reproduces bit-for-bit
  (float64) the reference's two quirks: the (k+1)-th base's ll polluting
  the window sum during builds (the assignment inside the while condition,
  src/kmer_util.c:104), and the rolling update subtracting the previous
  *new* base rather than the base leaving the window, telescoping the sum
  to ``ll(first k-1 of last build) + ll(newest)`` (src/kmer_util.c:150).
  N is not checked on this path (src/kmer_util.c:104-108).

* :func:`threshold_scan` — per-base quality gates with the reference's
  init/roll asymmetry: window build requires ``qual >= min_q``
  (src/kmer_util.c:42) while rolling requires strictly ``qual > min_q``
  (src/kmer_hash.c:317), N always breaks; a window completed by a fresh
  build at the exact end of the read is suppressed (``if(!seq[i]) break``
  before the add, src/kmer_hash.c:309-313).

Both emit, per position p: (accepted, fwd_hi, fwd_lo, rc_hi, rc_lo) for the
window ending at p (1-based end = p+1). The RC register is kept
bottom-aligned (new complement base inserted at bit 2k-2), equivalent to
the reference's top-aligned register after its ``>> (64-2k)`` extraction.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..qll import Q_TO_LL

U32 = jnp.uint32
F64 = jnp.float64

_LN10_OVER_10 = 0.23025850929940458

# The reference's low-quality sentinel: Q_TO_LL['!' and below] = log(DBL_MIN)
# (src/Q_to_log_likelihood.h:8). The fast path uses the same value so the
# sentinel contributes zero table-vs-analytic delta.
_LL_SENTINEL = float(Q_TO_LL[33])

# the backend's own analytic_ll_f32 over all 256 quality bytes, cached
# per backend — see ll_table_f32()
_LL_TABLE = None


def ll_table_f32():
    """``analytic_ll_f32`` over every quality byte (float32 [256] numpy),
    evaluated BY THE ACTIVE BACKEND — the terms the fast paths compute.

    Every f32 quantity the hybrid bound relies on is derived from this one
    measurement: the per-term deltas (:func:`_delta_max`,
    :func:`_rel_bound`), the analytic threshold (:func:`fast_min_ll`), and
    the table the FSM kernel indexes (ops.pallas_scan). Measuring the
    backend's own arithmetic matters: f32 exp/log1p round differently than
    an f64-evaluated-then-cast proxy, which understates the true delta
    ~3.6x. The first call may happen mid-trace (ll_scan is jitted and also
    runs inside shard_map programs), so it escapes to a real eager
    evaluation: a concrete measurement, never a tracer or a value XLA
    constant-folded on the host."""
    global _LL_TABLE
    import numpy as np

    backend = jax.default_backend()
    if _LL_TABLE is None or _LL_TABLE[0] != backend:
        with jax.ensure_compile_time_eval():
            t = np.asarray(analytic_ll_f32(jnp.arange(256, dtype=jnp.uint8)))
        _LL_TABLE = (backend, t.astype(np.float32))
    return _LL_TABLE[1]


def _host_and_device_terms():
    """(host-numpy f32, backend f32) analytic terms for q = 34..255 as f64
    arrays: the two evaluations every per-term bound must cover."""
    import numpy as np

    qf = np.arange(34, 256, dtype=np.float32) - np.float32(33.0)
    host = np.log1p(-np.exp(qf * np.float32(-_LN10_OVER_10)))
    return host.astype(np.float64), ll_table_f32()[34:].astype(np.float64)


# max |table_f64[q] - analytic_f32(q)| over all non-sentinel q — the
# per-term component of the hybrid-mode error bound. Cached per backend.
_DELTA_MAX = None


def _delta_max() -> float:
    """Per-term error bound between the exact path's f64 table terms and
    the fast path's f32 analytic terms: the worst of the host-numpy and
    the backend's own evaluation (:func:`ll_table_f32`), with a 2x +
    2^-22 safety margin. Sentinel q (phred <= 0) is excluded: the fast
    path emits the identical constant there (see _LL_SENTINEL).
    """
    global _DELTA_MAX
    import numpy as np

    backend = jax.default_backend()
    if _DELTA_MAX is None or _DELTA_MAX[0] != backend:
        table = np.asarray(Q_TO_LL)[34:]
        host, dev = _host_and_device_terms()
        d = max(float(np.max(np.abs(table - host))),
                float(np.max(np.abs(table - dev))))
        _DELTA_MAX = (backend, 2.0 * d + 2.0 ** -22)
    return _DELTA_MAX[1]


# relative per-term error bound (and its absolute floor), cached per
# backend — see _rel_bound()
_REL_BOUND = None
_ABS0 = 2.0 ** -39


def _rel_bound() -> float:
    """RELATIVE error bound between the exact path's f64 table terms and
    the fast path's f32 analytic terms: |t[q] - T[q]| <= _rel_bound()*|t[q]|
    + _ABS0 for every non-sentinel q (sentinel terms are the identical
    -708.0 constant in both paths, zero error).

    The hybrid flag predicate scales its per-term error with the term's own
    magnitude (all ll terms are negative, so a partial sum's total term
    error is bounded by rel*|sum|): an absolute worst-case delta (the old
    (k+1)*_delta_max() bound) is dominated by the large-|ll| low-q entries
    and over-flags high-quality reads by ~3 orders of magnitude — measured
    flag rates on NovaSeq-binned qualities were ~92% against <0.1% with the
    relative bound. Measured like _delta_max: host-numpy f32 and the active
    backend's own analytic_ll_f32, 2x margin + 2^-21, _ABS0 floor for the
    table's exact-0.0 tail entries (R's table rounds ll to 0 for q >~ 160;
    the analytic value there is ~-1e-17, far below the floor)."""
    global _REL_BOUND
    import numpy as np

    backend = jax.default_backend()
    if _REL_BOUND is None or _REL_BOUND[0] != backend:
        table = np.asarray(Q_TO_LL)[34:]
        host, dev = _host_and_device_terms()
        rel = 0.0
        for t in (host, dev):
            d = np.maximum(np.abs(table - t) - _ABS0 / 2, 0.0)
            den = np.maximum(np.maximum(np.abs(table), np.abs(t)), 1e-30)
            rel = max(rel, float(np.max(d / den)))
        # Soundness of the eq_t exemptions (ll_scan / pallas_scan): a
        # bitwise-equal f32 term (llv == min_ll) is exempted from flagging
        # on the grounds that the exact path then also sees equal table
        # values. That requires the f32 analytic map to be INJECTIVE
        # wherever the table is: distinct table values -> distinct f32
        # values (and monotone, so non-adjacent values cannot collide
        # either). Checked here, at the one place the bound is derived,
        # so a future table or backend change that collapses two q values
        # into one f32 value fails loudly instead of silently unflagging
        # a genuinely divergent comparison. (The tracked rel/_ABS0 bounds
        # are deliberately NOT the yardstick: _ABS0 = 2^-39 is a generous
        # flagging floor that exceeds the table's own gaps near its
        # ~1e-11 tail, while the actual analytic f32 error there is
        # relative, ~1e-18.)
        for name, t32 in (("host", host), (backend, dev)):
            d32 = np.diff(t32)
            if (d32 < 0.0).any():
                i = int(np.argmax(d32 < 0.0))
                raise AssertionError(
                    "analytic_ll_f32 (%s) not monotone at q=%d — the "
                    "q == min_q bitwise-equality exemptions are no "
                    "longer sound" % (name, 34 + i)
                )
            collide = (np.diff(table) != 0.0) & (d32 == 0.0)
            if collide.any():
                i = int(np.argmax(collide))
                raise AssertionError(
                    "analytic_ll_f32 (%s) collides distinct Q_TO_LL "
                    "entries at q=%d/%d — the q == min_q bitwise"
                    "-equality exemptions are no longer sound"
                    % (name, 34 + i, 35 + i)
                )
        _REL_BOUND = (backend, 2.0 * rel + 2.0 ** -21)
    return _REL_BOUND[1]


def fast_min_ll(min_q_char: int) -> float:
    """The fast path's comparison threshold for ``min_q``: the active
    backend's own ``analytic_ll_f32`` output for that quality character
    (:func:`ll_table_f32`).

    The exact path compares table values against the table value of
    min_q_char, so a base with q == min_q compares EQUAL (never accepted
    by the strict inequalities, src/kmer_util.c:104,116,153). Using the
    f32 *cast* of the table value as the fast threshold breaks that
    determinism — the analytic term differs from the cast by ~1 ulp, so
    every q == min_q base is genuinely borderline and the hybrid flag
    must fire (measured: ~98% of reads flagged on uniform-quality data at
    min_q=20). With the analytic value as the threshold the q == min_q
    comparison is bitwise equal -> same decision as exact, deterministically
    (no other q can collide: table gaps exceed f32 resolution everywhere
    outside the flushed-to-0.0 tail, where the values are exactly equal
    anyway)."""
    return float(ll_table_f32()[int(min_q_char)])


def analytic_ll_f32(qual_u8: jax.Array) -> jax.Array:
    """Float32 log-likelihood computed arithmetically:
    log1p(-10**(-(q-33)/10)), with the table's log(DBL_MIN) sentinel for
    phred <= 0 — the formula behind the Q_TO_LL table (qll.py), evaluated
    instead of gathered. Used by the "fast" and "hybrid" precision
    paths."""
    q = qual_u8.astype(jnp.float32) - 33.0
    raw = jnp.log1p(-jnp.exp(q * jnp.float32(-_LN10_OVER_10)))
    return jnp.where(q <= 0, jnp.float32(_LL_SENTINEL), raw)


def _roll_regs(state_regs, c: jax.Array, k: int):
    """One rolling step of the forward and (bottom-aligned) RC registers."""
    fhi, flo, rhi, rlo = state_regs
    cc = c ^ U32(2)  # complement: (code+2)%4 == code^2
    if k <= 16:
        flo = ((flo << 2) | c) & U32((1 << (2 * k)) - 1 if k < 16 else 0xFFFFFFFF)
        fhi = jnp.zeros_like(fhi)
        rlo = (rlo >> 2) | (cc << (2 * k - 2))
        if k < 16:
            rlo &= U32((1 << (2 * k)) - 1)
        rhi = jnp.zeros_like(rhi)
    else:
        hi_mask = U32((1 << (2 * (k - 16))) - 1) if k < 32 else U32(0xFFFFFFFF)
        fhi = ((fhi << 2) | (flo >> 30)) & hi_mask
        flo = (flo << 2) | c
        rlo = (rlo >> 2) | ((rhi & 3) << 30)
        rhi = ((rhi >> 2) | (cc << (2 * k - 34))) & hi_mask
    return fhi, flo, rhi, rlo


def _zero_regs(shape):
    z = jnp.zeros(shape, U32)
    return z, z, z, z


@functools.partial(
    jax.jit, static_argnames=("k", "precision", "unroll", "return_flags",
                              "min_q_char")
)
def ll_scan(
    ascii_u8: jax.Array, qual_u8: jax.Array, lengths: jax.Array, k: int,
    min_ll: jax.Array, precision: str = "exact", unroll: int = 4,
    return_flags: bool = False, min_q_char: int | None = None,
) -> Tuple[jax.Array, ...]:
    """Quality-likelihood iterator over a padded read batch.

    ascii_u8/qual_u8: [B, L]; lengths: [B]. Returns (accept[B, L],
    fhi, flo, rhi, rlo each [B, L]) where column p describes the window
    ending at position p. Reads with length <= k emit nothing (the caller
    loop skips them, src/kmer_reader.c:54-55).

    precision: "exact" gathers the embedded Q_TO_LL table and accumulates
    in float64, reproducing the C double arithmetic bit-for-bit. "fast"
    computes the log-likelihoods arithmetically in float32; accept/reject
    decisions can differ from the reference only when a window sum sits
    within float32 rounding of the threshold.

    return_flags (fast mode): additionally return a per-read bool flag [B]
    that is True whenever *any* comparison the FSM made for that read fell
    within a conservative f32 error bound of ``min_ll``. Unflagged reads
    are guaranteed to take the same FSM path as the exact float64 scan
    (induction on the first comparison that could flip), so re-running only
    flagged reads exactly reproduces exact output bit-for-bit (the hybrid
    path, counting.py).

    The bound is tracked, not statically estimated: the scan carries two
    extra f32 lanes ``aerr``/``eerr`` bounding |acc_f32 - acc_f64| and
    |emitC_f32 - emitC_f64| under the same-control-flow induction. Every
    f32 add/sub in the value path adds ``eps32 * |rounded result|`` to the
    matching error lane; every table term entering a value adds its
    per-term error ``_rel_bound()*|term| + _ABS0`` (a *relative* bound —
    ll terms all share a sign, so term errors compose with the sum's own
    magnitude instead of the table-wide worst case). A comparison value v
    flags the read iff ``|v - min_ll| <= err(v) + eps32*|min_ll| + _ABS0``.
    Versus the earlier static bound ``(k+1)*delta_max +
    (2k+8)*eps32*(|v|+|a|+2|min_ll|+4)`` this is ~3 orders of magnitude
    tighter on high-quality reads (NovaSeq-binned qualities at min_q=20
    flagged ~92% of reads under the static bound — 2*ll(q23) sits 1.1e-6
    from ll(q20) — and <0.1% under the tracked bound). Soundness is fuzzed
    by tests/test_hybrid.py: every fast-vs-exact decision flip must occur
    on a flagged read.
    """
    B, L = ascii_u8.shape
    fdt = F64 if precision == "exact" else jnp.float32
    codes = (ascii_u8.astype(U32) >> 1) & 3
    if precision == "exact":
        ll = jnp.asarray(Q_TO_LL)[qual_u8.astype(jnp.int32)]
    else:
        ll = analytic_ll_f32(qual_u8)
    min_ll = min_ll.astype(fdt)
    if precision != "exact" and min_q_char is not None:
        # the backend-analytic threshold: q == min_q terms compare EQUAL,
        # deterministically matching the exact path (see fast_min_ll)
        min_ll = jnp.asarray(fast_min_ll(min_q_char), fdt)
    if return_flags:
        f32 = jnp.float32
        eps = f32(2.0 ** -24)
        rel = f32(_rel_bound())
        abs0 = f32(_ABS0)
        # threshold error vs the exact path's f64 table value: the analytic
        # threshold carries the per-term bound, a cast threshold only the
        # cast rounding
        m32 = min_ll.astype(f32)
        if min_q_char is not None:
            merr = rel * jnp.abs(m32) + abs0
        else:
            merr = eps * jnp.abs(m32) + abs0

        def term_err(llv):
            # per-term error |analytic_f32[q] - table_f64[q]|
            return rel * jnp.abs(llv) + abs0

        def near(val, err):
            # the exact-f64 comparison could land on the other side of the
            # threshold: |val - min_ll| within val's tracked error bound
            # plus the threshold's own error
            return jnp.abs(val - min_ll) <= err + merr
    # pollution term: ll of the base after the window, 0 past the read end
    ll_next = jnp.concatenate([ll[:, 1:], jnp.zeros((B, 1), fdt)], axis=1)
    ll_next = jnp.where(
        (jnp.arange(L) + 1)[None, :] < lengths[:, None], ll_next, 0.0
    )
    in_read = jnp.arange(L)[None, :] < lengths[:, None]
    row_on = (lengths > k)[:, None] & in_read

    def step(state, xs):
        if return_flags:
            rolling, j, regs, acc, emitC, border, aerr, eerr = state
        else:
            rolling, j, regs, acc, emitC, border = state
        c, llv, llnext, on = xs

        # --- rolling mode (kmer_iterator_next, src/kmer_util.c:145-161) ---
        v = emitC + llv
        roll_ok = rolling & ~(v < min_ll)
        roll_fail = rolling & (v < min_ll)  # consume base, restart at p+1

        # --- building mode (kmer_iterator_begin, src/kmer_util.c:95-128) --
        building = ~rolling
        bv = acc + llv
        ok1 = building & (bv > min_ll)
        # failure resets the attempt and retries this base fresh
        ok2 = building & ~ok1 & (llv > min_ll)
        b_ok = ok1 | ok2
        if return_flags:
            # aerr/eerr bound |acc_f32 - acc_f64| / |emitC_f32 - emitC_f64|
            # under the induction hypothesis that every comparison so far
            # agreed with the exact path (the first comparison that could
            # disagree flags the read, after which the bounds are moot —
            # border is sticky)
            te = term_err(llv)
            verr = eerr + te + eps * jnp.abs(v)
            bverr = aerr + te + eps * jnp.abs(bv)
            # q == min_q exemptions: a term bitwise-equal to the threshold
            # decides FALSE in both paths — strict compares of equal f32
            # values, and equality implies q == min_q hence equal f64
            # table values (table gaps exceed every error bound outside
            # the flushed-0.0 tail, where the values are equal anyway);
            # acc == 0.0 certifies bv == llv bitwise (same-sign terms
            # cannot round a nonempty f32 sum to zero)
            eq_t = llv == min_ll
            border = border | (
                on & ((rolling & near(v, verr))
                      | (building
                         & ((near(bv, bverr) & ~((acc == 0.0) & eq_t))
                            | (~ok1 & near(llv, te) & ~eq_t))))
            )
        j_base = jnp.where(ok1, j, 0)
        acc_base = jnp.where(ok1, acc, 0.0)

        take = (roll_ok | b_ok) & on
        src_regs = tuple(
            jnp.where(ok1 | roll_ok, r, z)
            for r, z in zip(regs, _zero_regs(j.shape))
        )
        new_regs = _roll_regs(src_regs, c, k)
        regs = tuple(
            jnp.where(take, nr, r) for nr, r in zip(new_regs, regs)
        )

        j_new = jnp.where(b_ok, j_base + 1, jnp.where(building, 0, j))
        acc_new = jnp.where(b_ok, acc_base + llv, jnp.where(building, 0.0, acc))
        completed = building & b_ok & (j_new == k) & on
        emit = (completed | (roll_ok & rolling)) & on

        rolling_new = jnp.where(
            on, (rolling & ~roll_fail) | completed, rolling
        )
        j_new = jnp.where(on, jnp.where(roll_fail, 0, j_new), j)
        acc_new = jnp.where(on, jnp.where(roll_fail, 0.0, acc_new), acc)
        emitC_new = jnp.where(
            completed, acc_new - llv + llnext, jnp.where(roll_fail, 0.0, emitC)
        )
        out = (emit,) + regs
        if not return_flags:
            return (rolling_new, j_new, regs, acc_new, emitC_new, border), out
        # error-lane updates mirror the value updates op for op: each f32
        # add/sub contributes eps*|rounded result| (intermediates of the
        # emitC 3-term expression bounded by |acc_new| + |llv|), each term
        # re-entry contributes its term_err again
        aerr_base = jnp.where(ok1, aerr, 0.0)
        aerr_new = jnp.where(
            b_ok, aerr_base + te + eps * jnp.abs(acc_base + llv),
            jnp.where(building, 0.0, aerr),
        )
        aerr_new = jnp.where(on, jnp.where(roll_fail, 0.0, aerr_new), aerr)
        ecand = acc_new - llv + llnext
        ecand_err = (aerr_new + te + term_err(llnext)
                     + eps * (jnp.abs(acc_new) + jnp.abs(llv)
                              + jnp.abs(ecand)))
        eerr_new = jnp.where(completed, ecand_err,
                             jnp.where(roll_fail, 0.0, eerr))
        return (rolling_new, j_new, regs, acc_new, emitC_new, border,
                aerr_new, eerr_new), out

    # input-derived zeros: under shard_map the scan body mixes in per-shard
    # (varying) data, so the init carry must carry the same varying status
    # or lax.scan rejects the carry types (same trick as sort.searchsorted2)
    z = lengths.astype(jnp.int32) & 0
    init = (
        z != 0, z, tuple(g + z.astype(U32) for g in _zero_regs(B)),
        z.astype(fdt), z.astype(fdt), z != 0,
    )
    if return_flags:
        init = init + (z.astype(jnp.float32), z.astype(jnp.float32))
    xs = (
        codes.T, ll.T, ll_next.T, row_on.T,
    )
    # unrolling amortises the per-step loop overhead of this tiny body
    carry, outs = jax.lax.scan(step, init, xs, unroll=unroll)
    emit, fhi, flo, rhi, rlo = (o.T for o in outs)
    if return_flags:
        return emit, fhi, flo, rhi, rlo, carry[5]
    return emit, fhi, flo, rhi, rlo


@functools.partial(jax.jit, static_argnames=("k", "has_qual"))
def threshold_scan(
    ascii_u8: jax.Array, qual_u8: jax.Array, lengths: jax.Array, k: int,
    min_q: jax.Array, has_qual: bool = True,
) -> Tuple[jax.Array, ...]:
    """Per-base-threshold iterator (seq_to_counts_kt / seq_to_counts_sh,
    src/kmer_hash.c:257-332) over a padded read batch.

    Build gate: not-N and qual >= min_q; roll gate: not-N and qual > min_q.
    A window completed by a build at the exact end of the read is dropped.
    """
    B, L = ascii_u8.shape
    codes = (ascii_u8.astype(U32) >> 1) & 3
    is_n = (ascii_u8 | jnp.uint8(0x20)) == jnp.uint8(ord("n"))
    if has_qual:
        q = qual_u8.astype(jnp.int32)
        build_gate = ~is_n & (q >= min_q)
        roll_gate = ~is_n & (q > min_q)
    else:
        build_gate = ~is_n
        roll_gate = ~is_n
    pos_idx = jnp.arange(L)[None, :]
    in_read = pos_idx < lengths[:, None]
    row_on = (lengths > k)[:, None] & in_read
    last_pos = (lengths - 1)[:, None] == pos_idx  # exact end of read

    def step(state, xs):
        rolling, j, regs = state
        c, bg, rg, on, at_end = xs

        roll_ok = rolling & rg
        # on roll failure the base is REPROCESSED as a fresh build start
        # (the outer while re-enters init_kmer_qual_2 at i,
        #  src/kmer_hash.c:306-308)
        building = ~rolling | (rolling & ~rg)
        b_ok = building & bg
        j_base = jnp.where(~rolling, j, 0)  # fresh attempt after roll fail

        take = (roll_ok | b_ok) & on
        src_regs = tuple(
            jnp.where((b_ok & (j_base > 0)) | roll_ok, r, z)
            for r, z in zip(regs, _zero_regs(j.shape))
        )
        new_regs = _roll_regs(src_regs, c, k)
        regs = tuple(jnp.where(take, nr, r) for nr, r in zip(new_regs, regs))

        j_new = jnp.where(b_ok, j_base + 1, 0)
        completed = b_ok & (j_new == k) & on
        # suppression: build completing on the read's last base is dropped,
        # but the FSM still enters rolling (moot — the read is over)
        emit = ((completed & ~at_end) | roll_ok) & on
        rolling_new = jnp.where(on, roll_ok | completed, rolling)
        j_new = jnp.where(on, jnp.where(rolling_new, 0, j_new), j)
        out = (emit,) + regs
        return (rolling_new, j_new, regs), out

    # input-derived zeros: keep the init carry's shard_map varying status
    # equal to the body's (see ll_scan / sort.searchsorted2)
    z = lengths.astype(jnp.int32) & 0
    init = (z != 0, z, tuple(g + z.astype(U32) for g in _zero_regs(B)))
    xs = (codes.T, build_gate.T, roll_gate.T, row_on.T, last_pos.T)
    _, outs = jax.lax.scan(step, init, xs, unroll=4)
    emit, fhi, flo, rhi, rlo = (o.T for o in outs)
    return emit, fhi, flo, rhi, rlo
