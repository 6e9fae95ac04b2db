"""Pallas kernel (Triton route) for the quality-likelihood FSM in float32.

``ops.scan_iter.ll_scan`` runs the per-read iterator as a ``lax.scan``
over base positions: each step is a handful of tiny elementwise ops on
[B]-shaped operands, and XLA lowers the scan to a device loop whose every
iteration launches kernels and round-trips the whole FSM state through
device memory. Here one program owns a block of reads, one read per lane,
and walks the positions in an in-kernel loop with the state in registers:
device memory sees each input byte once and each output word once.

Inputs are read in the [L, B] layout (position-major), so neighbouring
lanes read neighbouring bytes of one position row. The log-likelihood
terms come from a 256-entry float32 table of ``analytic_ll_f32`` evaluated
by the backend itself (:func:`scan_iter.ll_table_f32`), the same values the
hybrid error bound was derived from, so results are bit-identical to
``ll_scan(..., precision="fast")`` (and its flags with
``return_flags=True``), which the tests assert.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .scan_iter import _ABS0, _rel_bound, fast_min_ll, ll_table_f32

U32 = jnp.uint32
F32 = jnp.float32
I32 = jnp.int32
BLOCK = 128  # reads per program: one read per thread at 4 warps
_NUM_WARPS = 4


def _fsm_step(state, c, llv, llnext, on, *, k, min_ll_v, err_consts=None):
    """One FSM transition over a block of reads; returns (state', emit).
    Mirrors ops.scan_iter.ll_scan's step op for op, in float32.

    ``err_consts`` (hybrid mode) = (rel, abs0, merr) floats: the tracked
    f32 error-bound flag machinery of ``ll_scan(return_flags=True)`` —
    the state carries two extra error lanes aerr/eerr, and a comparison
    flags the read when it falls within its tracked error bound of min_ll
    (with the q == min_q bitwise-equality exemptions; see ll_scan)."""
    if err_consts is not None:
        (rolling, j, fhi, flo, rhi, rlo, acc, emitC, border,
         aerr, eerr) = state
    else:
        rolling, j, fhi, flo, rhi, rlo, acc, emitC = state
    shp = c.shape
    zf = jnp.zeros(shp, F32)
    zu = jnp.zeros(shp, U32)
    zi = jnp.zeros(shp, I32)
    if k <= 16:
        lo_mask = U32((1 << (2 * k)) - 1 if k < 16 else 0xFFFFFFFF)
    else:
        hi_mask = U32((1 << (2 * (k - 16))) - 1) if k < 32 else U32(0xFFFFFFFF)

    v = emitC + llv
    roll_ok = rolling & ~(v < min_ll_v)
    roll_fail = rolling & (v < min_ll_v)

    building = ~rolling
    bv = acc + llv
    ok1 = building & (bv > min_ll_v)
    ok2 = building & ~ok1 & (llv > min_ll_v)
    b_ok = ok1 | ok2
    if err_consts is not None:
        rel, abs0, merr = err_consts
        eps = F32(2.0 ** -24)

        def near(val, err):
            return jnp.abs(val - min_ll_v) <= err + F32(merr)

        te = F32(rel) * jnp.abs(llv) + F32(abs0)
        verr = eerr + te + eps * jnp.abs(v)
        bverr = aerr + te + eps * jnp.abs(bv)
        eq_t = llv == min_ll_v
        border = border | (
            on & ((rolling & near(v, verr))
                  | (building
                     & ((near(bv, bverr) & ~((acc == zf) & eq_t))
                        | (~ok1 & near(llv, te) & ~eq_t))))
        )
    j_base = jnp.where(ok1, j, zi)
    acc_base = jnp.where(ok1, acc, zf)

    take = (roll_ok | b_ok) & on
    keep = ok1 | roll_ok
    s_fhi = jnp.where(keep, fhi, zu)
    s_flo = jnp.where(keep, flo, zu)
    s_rhi = jnp.where(keep, rhi, zu)
    s_rlo = jnp.where(keep, rlo, zu)
    cc = c ^ U32(2)
    if k <= 16:
        n_flo = ((s_flo << 2) | c) & lo_mask
        n_fhi = zu
        n_rlo = ((s_rlo >> 2) | (cc << (2 * k - 2))) & lo_mask
        n_rhi = zu
    else:
        n_fhi = ((s_fhi << 2) | (s_flo >> 30)) & hi_mask
        n_flo = (s_flo << 2) | c
        n_rlo = (s_rlo >> 2) | ((s_rhi & 3) << 30)
        n_rhi = ((s_rhi >> 2) | (cc << (2 * k - 34))) & hi_mask
    fhi = jnp.where(take, n_fhi, fhi)
    flo = jnp.where(take, n_flo, flo)
    rhi = jnp.where(take, n_rhi, rhi)
    rlo = jnp.where(take, n_rlo, rlo)

    j_new = jnp.where(b_ok, j_base + 1, jnp.where(building, zi, j))
    acc_new = jnp.where(b_ok, acc_base + llv, jnp.where(building, zf, acc))
    completed = building & b_ok & (j_new == k) & on
    emit = (completed | (roll_ok & rolling)) & on

    rolling_new = jnp.where(on, (rolling & ~roll_fail) | completed, rolling)
    j_new = jnp.where(on, jnp.where(roll_fail, zi, j_new), j)
    acc_new = jnp.where(on, jnp.where(roll_fail, zf, acc_new), acc)
    emitC = jnp.where(completed, acc_new - llv + llnext,
                      jnp.where(roll_fail, zf, emitC))
    if err_consts is None:
        return (rolling_new, j_new, fhi, flo, rhi, rlo, acc_new,
                emitC), emit
    # error-lane updates mirror the value updates op for op (see
    # ops.scan_iter.ll_scan)
    aerr_base = jnp.where(ok1, aerr, zf)
    aerr_new = jnp.where(
        b_ok, aerr_base + te + eps * jnp.abs(acc_base + llv),
        jnp.where(building, zf, aerr),
    )
    aerr_new = jnp.where(on, jnp.where(roll_fail, zf, aerr_new), aerr)
    ecand = acc_new - llv + llnext
    ecand_err = (aerr_new + te + (F32(rel) * jnp.abs(llnext) + F32(abs0))
                 + eps * (jnp.abs(acc_new) + jnp.abs(llv)
                          + jnp.abs(ecand)))
    eerr_new = jnp.where(completed, ecand_err,
                         jnp.where(roll_fail, zf, eerr))
    return (rolling_new, j_new, fhi, flo, rhi, rlo, acc_new, emitC,
            border, aerr_new, eerr_new), emit


def _kernel(seq_ref, qual_ref, len_ref, tab_ref, *out_refs, k: int,
            min_ll: float, err_consts):
    if err_consts is not None:
        emit_ref, fhi_ref, flo_ref, rhi_ref, rlo_ref, flag_ref = out_refs
    else:
        emit_ref, fhi_ref, flo_ref, rhi_ref, rlo_ref = out_refs
    L = seq_ref.shape[0]
    lengths = len_ref[...]
    long_read = lengths > k
    min_ll_v = jnp.full((BLOCK,), min_ll, F32)

    def ll_at(p):
        q = qual_ref[p, :].astype(I32)
        return plgpu.load(tab_ref.at[q])

    def body(p, carry):
        state, llv = carry
        c = (seq_ref[p, :].astype(U32) >> 1) & U32(3)
        on = long_read & (p < lengths)
        # ll of the base after the window, 0 past the read end (the
        # clamped load at p == L-1 is always masked by the length)
        llnext = jnp.where(p + 1 < lengths,
                           ll_at(jnp.minimum(p + 1, L - 1)), F32(0.0))
        state, emit = _fsm_step(state, c, llv, llnext, on, k=k,
                                min_ll_v=min_ll_v, err_consts=err_consts)
        emit_ref[p, :] = emit.astype(jnp.uint8)
        fhi_ref[p, :] = state[2]
        flo_ref[p, :] = state[3]
        rhi_ref[p, :] = state[4]
        rlo_ref[p, :] = state[5]
        # the next step's own term: ll[p+1] unmasked (padding quality
        # bytes give the sentinel term, exactly as ll_scan sees them)
        return state, ll_at(jnp.minimum(p + 1, L - 1))

    zf = jnp.zeros((BLOCK,), F32)
    zu = jnp.zeros((BLOCK,), U32)
    zb = jnp.zeros((BLOCK,), jnp.bool_)
    state = (zb, jnp.zeros((BLOCK,), I32), zu, zu, zu, zu, zf, zf)
    if err_consts is not None:
        state = state + (zb, zf, zf)
    state, _ = jax.lax.fori_loop(0, L, body, (state, ll_at(0)))
    if err_consts is not None:
        flag_ref[...] = state[8].astype(jnp.uint8)


@functools.partial(
    jax.jit,
    static_argnames=("k", "min_ll", "return_flags", "min_q_char",
                     "interpret"),
)
def ll_scan_pallas(
    ascii_u8: jax.Array, qual_u8: jax.Array, lengths: jax.Array, k: int,
    min_ll: float, return_flags: bool = False,
    min_q_char: int | None = None, interpret: bool = False,
) -> Tuple[jax.Array, ...]:
    """``ll_scan(..., precision='fast')`` as one kernel, in the [L, B]
    layout: returns (emit, fhi, flo, rhi, rlo) each [L, B] — the
    transposes of ll_scan's [B, L] outputs (order-insensitive consumers
    such as counting flatten either way).

    return_flags: additionally return the per-read borderline flag (bool
    [B]) of ``ll_scan(..., return_flags=True)`` (hybrid mode).

    min_q_char: when given, the comparison threshold becomes the backend's
    own analytic f32 value for that quality character (scan_iter
    .fast_min_ll), so q == min_q terms compare bitwise-equal — the flag
    exemptions depend on this; pass it whenever min_ll is a Q_TO_LL entry.

    interpret: run the kernel in the Pallas interpreter (CPU tests)."""
    B, L = ascii_u8.shape
    Bp = -(-B // BLOCK) * BLOCK
    if Bp != B:
        ascii_u8 = jnp.pad(ascii_u8, ((0, Bp - B), (0, 0)),
                           constant_values=ord("N"))
        qual_u8 = jnp.pad(qual_u8, ((0, Bp - B), (0, 0)))
        lengths = jnp.pad(lengths, (0, Bp - B))
    min_ll_f = (fast_min_ll(min_q_char) if min_q_char is not None
                else float(min_ll))
    err_consts = None
    if return_flags:
        # merr in f32 step order, matching ll_scan's traced computation
        rel = np.float32(_rel_bound())
        abs0 = np.float32(_ABS0)
        m32 = np.abs(np.float32(min_ll_f))
        merr = ((rel * m32 + abs0) if min_q_char is not None
                else (np.float32(2.0 ** -24) * m32 + abs0))
        err_consts = (float(rel), float(abs0), float(merr))
    col = pl.BlockSpec((L, BLOCK), lambda i: (0, i))
    row = pl.BlockSpec((BLOCK,), lambda i: (i,))
    out_shape = [jax.ShapeDtypeStruct((L, Bp), jnp.uint8)] + [
        jax.ShapeDtypeStruct((L, Bp), U32)] * 4
    out_specs = [col] * 5
    if return_flags:
        out_shape.append(jax.ShapeDtypeStruct((Bp,), jnp.uint8))
        out_specs.append(row)
    outs = pl.pallas_call(
        functools.partial(_kernel, k=k, min_ll=min_ll_f,
                          err_consts=err_consts),
        grid=(Bp // BLOCK,),
        in_specs=[col, col, row, pl.BlockSpec((256,), lambda i: (0,))],
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=2),
        interpret=interpret,
        name="ll_fsm",
    )(ascii_u8.T, qual_u8.T, lengths.astype(I32),
      jnp.asarray(ll_table_f32()))
    emit = outs[0][:, :B] != 0
    res = (emit,) + tuple(o[:, :B] for o in outs[1:5])
    if return_flags:
        res = res + (outs[5][:B] != 0,)
    return res
