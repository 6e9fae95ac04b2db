"""Position-parallel k-mer encoding.

The reference encodes k-mers with a sequential rolling register — one base
per iteration, state at position i depending on i-1 (src/kmer_util.h:8,
src/kmer_pos.c:88-95). That recurrence serialises the whole sequence, so
this design eliminates it: every output position computes its packed k-mer
*independently* via a log2(k) shift-OR doubling scan, turning encoding into
O(L log k) pure elementwise work with no loop-carried dependency.

Representation: a k-mer (k <= 32) is 2k bits split across two uint32 lanes
``(hi, lo)`` — ``lo`` holds the last min(k,16) bases, ``hi`` the remainder —
so the elementwise work stays in 32-bit integer ops. All comparisons are
unsigned lexicographic on (hi, lo).

Base encoding matches the reference exactly: ``code(c) = (c>>1)&3`` maps
A->0 C->1 T->2 G->3 for both cases (src/kmer_util.h:8); the complement of a
code is ``code ^ 2`` (== (code+2)%4, src/kmer_util.h:9); N detection is
``(c|0x20) == 'n'`` (src/kmer_util.h:10) — any other byte silently encodes
like the reference does (README.md:13-16).

All functions operate on the last axis and broadcast over leading axes, so
a padded [n_reads, L] batch vectorises for free.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

U32 = jnp.uint32
_COMP_MASK = jnp.uint32(0xAAAAAAAA)  # xor flips each 2-bit group by +2 mod 4


def base_codes(ascii_u8: jax.Array) -> jax.Array:
    """ASCII bytes -> 2-bit codes, uint32 (semantics of kmer_util.h:8)."""
    return (ascii_u8.astype(U32) >> 1) & 3


def n_flags(ascii_u8: jax.Array) -> jax.Array:
    """True where the byte is n/N (semantics of kmer_util.c:5)."""
    return (ascii_u8 | jnp.uint8(0x20)) == jnp.uint8(ord("n"))


def unpack_seq(codes_packed: jax.Array,
               nmask: "jax.Array | None" = None) -> jax.Array:
    """Reconstruct a canonical ASCII byte plane from the compact upload
    form (io.native.iter_fastx_packed): ``codes_packed[..., Lp/4]`` holds
    2-bit base codes little-endian within each byte, ``nmask[..., Lp/8]``
    the n/N bit. ``nmask`` is omitted for N-free batches (the common
    case; validity beyond read lengths comes from the length masks, not
    the pad bytes). The result re-encodes to the SAME (base_codes,
    n_flags) as the original bytes — the only two functions through which
    the device path reads sequence data — so counting over packed uploads
    is bit-identical. Returned bytes are 'A','C','T','G' or 'N'."""
    c = (codes_packed[..., :, None]
         >> jnp.asarray([0, 2, 4, 6], jnp.uint8)) & jnp.uint8(3)
    c = c.reshape(codes_packed.shape[:-1] + (codes_packed.shape[-1] * 4,))
    # code -> byte by nested selects: 0->'A' 1->'C' 2->'T' 3->'G'
    b = jnp.where(
        c == 0, jnp.uint8(ord("A")),
        jnp.where(c == 1, jnp.uint8(ord("C")),
                  jnp.where(c == 2, jnp.uint8(ord("T")),
                            jnp.uint8(ord("G")))),
    )
    if nmask is None:
        return b
    n = (nmask[..., :, None] >> jnp.arange(8, dtype=jnp.uint8)) & jnp.uint8(1)
    n = n.reshape(nmask.shape[:-1] + (nmask.shape[-1] * 8,)).astype(bool)
    return jnp.where(n, jnp.uint8(ord("N")), b)


def unpack_qual(qnib: jax.Array, qdict: jax.Array) -> jax.Array:
    """Reconstruct the quality byte plane from the 4-bit dictionary form
    (io.native.iter_fastx_packed): ``qnib[..., Lp/2]`` holds dict indices
    little-endian within each byte, ``qdict[16]`` the actual byte values.
    Byte-EXACT — even the f64 bit-parity likelihood path sees identical
    input. A select chain, fused elementwise by XLA."""
    if qdict.shape[0] == 1:  # 6-bit relative form (see unpack_qual6)
        return unpack_qual6(qnib, qdict)
    q = (qnib[..., :, None] >> jnp.asarray([0, 4], jnp.uint8)) & jnp.uint8(15)
    q = q.reshape(qnib.shape[:-1] + (qnib.shape[-1] * 2,))
    out = jnp.broadcast_to(qdict[0], q.shape)
    for i in range(1, 16):
        out = jnp.where(q == jnp.uint8(i), qdict[i], out)
    return out


def unpack_qual6(q6: jax.Array, qbase: jax.Array) -> jax.Array:
    """Reconstruct the quality byte plane from the 6-bit relative pack
    (io/native fastx_fill_packed2 qflag=2): ``q6[..., 3*Lp/4]`` holds
    little-endian 6-bit values (4 per 3 bytes), stored = q - vmin + 1
    with 0 reserved for the pad byte; ``qbase[1]`` is vmin. Byte-EXACT
    reconstruction, pure elementwise shifts — no gather."""
    W6 = q6.shape[-1]
    g = q6.reshape(q6.shape[:-1] + (W6 // 3, 3))
    b0 = g[..., 0]
    b1 = g[..., 1]
    b2 = g[..., 2]
    m6 = jnp.uint8(63)
    v0 = b0 & m6
    v1 = ((b0 >> 6) | (b1 << 2)) & m6
    v2 = ((b1 >> 4) | (b2 << 4)) & m6
    v3 = (b2 >> 2) & m6
    v = jnp.stack([v0, v1, v2, v3], axis=-1)
    v = v.reshape(q6.shape[:-1] + ((W6 // 3) * 4,))
    return jnp.where(v == 0, jnp.uint8(0),
                     v + (qbase[0] - jnp.uint8(1)))


def _advance(arr: jax.Array, s: int) -> jax.Array:
    """arr shifted toward index 0 by ``s`` along the last axis, zero padded:
    out[..., i] = arr[..., i+s]. Static shift."""
    if s == 0:
        return arr
    pad = jnp.zeros(arr.shape[:-1] + (s,), arr.dtype)
    return jnp.concatenate([arr[..., s:], pad], axis=-1)


def _power_codes(codes: jax.Array, max_w: int) -> Dict[int, jax.Array]:
    """Doubling pyramid: pw[w][..., i] = codes[..., i..i+w-1] packed
    big-endian into the low 2w bits, for w in powers of two up to max_w.
    Tail positions (closer than w to the end) hold garbage — callers mask."""
    pw = {1: codes}
    w = 1
    while w * 2 <= max_w:
        c = pw[w]
        pw[2 * w] = (c << (2 * w)) | _advance(c, w)
        w *= 2
    return pw


def _compose(pw: Dict[int, jax.Array], w: int) -> jax.Array:
    """out[..., i] = codes[..., i..i+w-1] packed, from the power pyramid."""
    assert 1 <= w <= 16
    acc = None
    off = 0
    for p in (16, 8, 4, 2, 1):
        if w & p:
            part = pw[p]
            if acc is None:
                acc = part if off == 0 else _advance(part, off)
            else:
                acc = (acc << (2 * p)) | _advance(part, off)
            off += p
    return acc


def encode_windows(codes: jax.Array, k: int) -> Tuple[jax.Array, jax.Array]:
    """Forward window codes: (hi, lo) uint32 arrays, same shape as ``codes``;
    entry i is the packed k-mer starting at i (garbage within k-1 of the
    end — mask with :func:`window_valid`).

    Equivalent to the reference's rolling ``UPDATE_OFFSET`` register masked
    to 2k bits (src/kmer_pos.c:70-90), computed position-parallel.
    """
    if not 1 <= k <= 32:
        raise ValueError("k must be in 1..32")
    pw = _power_codes(codes, min(k, 16))
    if k <= 16:
        lo = _compose(pw, k)
        if k < 16:
            lo &= U32((1 << (2 * k)) - 1)
        hi = jnp.zeros_like(lo)
        return hi, lo
    hi = _compose(pw, k - 16)
    if k < 32:
        hi &= U32((1 << (2 * (k - 16))) - 1)
    lo = _advance(_compose(pw, 16), k - 16)
    return hi, lo


def _rev_groups_u32(x: jax.Array) -> jax.Array:
    """Reverse the order of the sixteen 2-bit groups within each uint32."""
    x = (x >> 16) | (x << 16)
    x = ((x & U32(0xFF00FF00)) >> 8) | ((x & U32(0x00FF00FF)) << 8)
    x = ((x & U32(0xF0F0F0F0)) >> 4) | ((x & U32(0x0F0F0F0F)) << 4)
    x = ((x & U32(0xCCCCCCCC)) >> 2) | ((x & U32(0x33333333)) << 2)
    return x


def _shr64(hi: jax.Array, lo: jax.Array, s: int) -> Tuple[jax.Array, jax.Array]:
    """Logical right shift of the (hi, lo) pair as a 64-bit value, static s."""
    if s == 0:
        return hi, lo
    if s < 32:
        return hi >> s, (lo >> s) | (hi << (32 - s))
    if s == 32:
        return jnp.zeros_like(hi), hi
    return jnp.zeros_like(hi), hi >> (s - 32)


@functools.partial(jax.jit, static_argnames=("k",))
def revcomp_windows(
    hi: jax.Array, lo: jax.Array, k: int
) -> Tuple[jax.Array, jax.Array]:
    """Reverse complement of packed k-mers, position-parallel.

    The reference maintains a second rolling register built from the high
    end (UPDATE_OFFSET_RC, src/kmer_util.h:9) and shifts it down by 64-2k at
    extraction (src/kmer_util.c:63). Here RC is derived from the forward
    code directly: complement = xor 0b10 per group, order = full 64-bit
    2-bit-group reversal, then shift right by 64-2k. ~12 elementwise ops,
    no second encode pipeline.
    """
    rhi = _rev_groups_u32(lo ^ _COMP_MASK)
    rlo = _rev_groups_u32(hi ^ _COMP_MASK)
    rhi2, rlo2 = _shr64(rhi, rlo, 64 - 2 * k)
    if k <= 16:
        rhi2 = jnp.zeros_like(rhi2)  # mask the complement junk above 2k bits
        if k < 16:
            rlo2 &= U32((1 << (2 * k)) - 1)
    elif k < 32:
        rhi2 &= U32((1 << (2 * (k - 16))) - 1)
    return rhi2, rlo2


def canonical_windows(
    fhi: jax.Array, flo: jax.Array, rhi: jax.Array, rlo: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """min(fwd, rc) per window, unsigned lexicographic on (hi, lo)
    (semantics of src/kmer_reader.c:30)."""
    take_f = (fhi < rhi) | ((fhi == rhi) & (flo <= rlo))
    return jnp.where(take_f, fhi, rhi), jnp.where(take_f, flo, rlo)


def window_any(flags: jax.Array, k: int) -> jax.Array:
    """out[..., i] = any(flags[..., i..i+k-1]) via OR-doubling (tail entries
    within k-1 of the end are meaningless; callers mask by length)."""
    pw = {1: flags}
    w = 1
    while w * 2 <= k:
        f = pw[w]
        pw[2 * w] = f | _advance(f, w)
        w *= 2
    acc = None
    off = 0
    for p in (32, 16, 8, 4, 2, 1):
        if k & p:
            part = pw[p]  # doubling built every power <= largest bit of k
            if acc is None:
                acc = part if off == 0 else _advance(part, off)
            else:
                acc = acc | _advance(part, off)
            off += p
    return acc


@functools.partial(
    jax.jit, static_argnames=("k", "drop_trailing_exact_k")
)
def window_valid(
    ascii_u8: jax.Array, k: int, true_len, drop_trailing_exact_k: bool = False
) -> jax.Array:
    """Validity mask over window start positions.

    A window [i, i+k) is valid iff it contains no N and lies entirely within
    the sequence's true length (padding is expected to be 'N' anyway).

    ``drop_trailing_exact_k`` reproduces the reference quirk by which the
    forward-streaming paths (position index, count.kmers, seq.kmer.pos
    queries) drop a window that (a) ends exactly at the end of the sequence
    and (b) starts a fresh valid region (preceded by N or at position 0):
    ``init_kmer`` returns it but ``if(!seq[i]) break`` fires before the
    insert (src/kmer_pos.c:81-84, src/kmer_hash.c:235-238). The iterator
    paths (fastq counting) do NOT drop it.
    """
    L = ascii_u8.shape[-1]
    nf = n_flags(ascii_u8)
    has_n = window_any(nf, k)
    idx = jnp.arange(L, dtype=jnp.int32)
    true_len = jnp.asarray(true_len, jnp.int32)
    if true_len.ndim:
        true_len = true_len[..., None]
    in_range = idx + k <= true_len
    valid = (~has_n) & in_range
    if drop_trailing_exact_k:
        prev_is_n = jnp.concatenate(
            [jnp.ones(nf.shape[:-1] + (1,), bool), nf[..., :-1]], axis=-1
        )
        at_end = idx + k == true_len
        valid &= ~(at_end & prev_is_n)
    return valid


@functools.partial(
    jax.jit, static_argnames=("k", "canonical", "drop_trailing_exact_k")
)
def encode_stream(
    ascii_u8: jax.Array, k: int, true_len, canonical: bool = False,
    drop_trailing_exact_k: bool = False,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Full encode: ASCII -> (hi, lo, valid) over window start positions
    (the doubling graph, which XLA fuses into a few elementwise kernels).
    """
    codes = base_codes(ascii_u8)
    hi, lo = encode_windows(codes, k)
    valid = window_valid(ascii_u8, k, true_len, drop_trailing_exact_k)
    if canonical:
        rhi, rlo = revcomp_windows(hi, lo, k)
        hi, lo = canonical_windows(hi, lo, rhi, rlo)
    return hi, lo, valid


def pack_u64_np(hi, lo):
    """Host helper: (hi, lo) uint32 arrays -> numpy uint64 (for tests)."""
    import numpy as np

    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        lo
    ).astype(np.uint64)
