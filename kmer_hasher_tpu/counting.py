"""High-level counting entries — analogues of the reference's
``count.kmers*`` R surface (kmer_hash.R:43-96, src/kmer_hash.c:548-857).

Reads stream through the batched FSM iterators (quality paths) or the
position-parallel encoder (no-quality paths), are canonicalised where the
reference canonicalises, and merge into a :class:`CountStore`. The
reference's thread count (its prefix-sharded reader pool,
src/kmer_reader.c:28-39) has no analogue here — single-chip batches are
data-parallel already, and multi-chip sharding lives in
``kmer_hasher_tpu.parallel`` keyed on the same prefix notion.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .index.count_store import CountStore
from .io import pad_records
from .io.fastx import Record
from .ops import encode as enc
from .ops import scan_iter as si
from .qll import Q_TO_LL

MAX_K = 32


def win_bucket(lmax: int, k: int) -> int:
    """Static window-axis trim for a batch: the true max read length
    bucketed to a multiple of 16 (bounds compiled-program variants),
    minus the k-1 window offset. EVERY site that sizes or trims the
    window axis must use this one definition — the per-batch trim
    (_fused_rp_batch / _fused_threshold_batch / ShardedCountStore
    .add_reads) and the run-capacity tuning (_tuned_batch_rows) have to
    agree, and the sharded trim must match across processes."""
    return max(1, -(-max(1, int(lmax)) // 16) * 16 - k + 1)


def derive_prefix_suffix_bits(k: int, prefix_bits: int) -> Tuple[int, int]:
    """Reader-pool bit split (src/kmer_reader.c:86-95), clamped sanely."""
    total = 2 * k
    prefix_bits = min(prefix_bits, 36, total)
    suffix_bits = total - prefix_bits
    if suffix_bits > 32:
        suffix_bits = 32
        prefix_bits = total - 32
    return prefix_bits, suffix_bits


def _pad_pow2(records: List[Record]):
    """Pad a record batch to power-of-two rows and length so XLA programs
    are reused across batches."""
    pr = pad_records(records, pad_to_multiple=1)
    B, L = pr.seq.shape
    from .io.fastx import col_bucket
    Bp = 1 << max(3, (B - 1).bit_length())
    Lp = col_bucket(L)
    seq = np.full((Bp, Lp), ord("N"), np.uint8)
    qual = np.zeros((Bp, Lp), np.uint8)
    seq[:B, :L] = pr.seq
    qual[:B, :L] = pr.qual
    lengths = np.zeros(Bp, np.int32)
    lengths[:B] = pr.lengths
    has_qual = np.zeros(Bp, bool)
    has_qual[:B] = pr.has_qual
    return seq, qual, lengths, has_qual


def _pack_np(seq: np.ndarray):
    """NumPy fallback for the C++ packer: byte plane -> (codes, nmask)
    in the compact upload form (see io.native.iter_fastx_packed)."""
    codes = ((seq >> 1) & 3).astype(np.uint8)
    B, L = seq.shape
    c4 = codes.reshape(B, L // 4, 4)
    packed = (c4[..., 0] | (c4[..., 1] << 2) | (c4[..., 2] << 4)
              | (c4[..., 3] << 6))
    is_n = (seq | np.uint8(0x20)) == np.uint8(ord("n"))
    nmask = np.packbits(is_n, axis=-1, bitorder="little")
    return packed, nmask


def _use_packed_upload() -> bool:
    import os

    return os.environ.get("KMH_PACK_UPLOAD", "1") != "0"


def _normalize_paths(path):
    """None for a single path-like input; a non-empty list of str paths
    when the caller passed a sequence of files."""
    import os

    if isinstance(path, (str, bytes, os.PathLike)):
        return None
    paths = [os.fspath(p) for p in path]
    if not paths:
        raise ValueError("empty file list")
    return paths


def _iter_padded_batches(path: str, max_reads: Optional[int],
                         batch_rows: Optional[int] = None,
                         prefetch: int = 2, skip: int = 0,
                         to_device: bool = False, packed: bool = False,
                         byte_range=None, range_info=None):
    """Yield device-ready (seq, qual, lengths, has_qual) batches, padded to
    power-of-two shapes. ``skip`` discards the first N records (mid-file
    resume); ``max_reads`` then limits the records yielded after the skip.

    Fast path: the native parser streams contiguous buffers batch-by-batch
    (constant memory) and a background thread parses/pads batch N+1 while
    the caller dispatches batch N to the device — the host->device input
    pipeline of ROADMAP §5. Falls back to streamed Python parsing when the
    native parser is unavailable.

    With ``to_device=True`` the prefetch thread also ``jax.device_put``\\ s
    seq/qual/lengths/has_qual, so the host->device copy of batch N+1
    overlaps the device compute of batch N; batches then carry both
    device and host views.
    """
    if max_reads is not None and max_reads < 0:
        max_reads = None
    limit = None if max_reads is None else skip + max_reads
    if batch_rows is None:
        # bigger batches amortise the per-batch host dispatch over more
        # reads; KMH_BATCH_ROWS tunes it
        import os

        batch_rows = int(os.environ.get("KMH_BATCH_ROWS", "16384"))
    from .io import native

    ship = _ship_to_device if to_device else (lambda b: b)
    if byte_range is not None:
        # multi-host input slice: records starting in [start, end) only.
        # Padded (non-packed) form — the packed quality modes are chosen
        # per local batch and would diverge across processes.
        if native.available():
            def produce_range():
                for b in native.iter_fastx_padded(
                        path, batch_rows, max_reads,
                        byte_range=byte_range, range_info=range_info):
                    yield ship(b)

            yield from _prefetch_iter(produce_range(), prefetch)
            return
        from .io.fastx import iter_fastx_range

        def produce_range_py():
            left = max_reads
            for recs in iter_fastx_range(path, byte_range[0],
                                         byte_range[1], batch_rows,
                                         range_info=range_info):
                if left is not None:
                    recs = recs[:left]
                    left -= len(recs)
                if recs:
                    yield ship(_pad_pow2(recs))
                if left is not None and left <= 0:
                    return

        yield from _prefetch_iter(produce_range_py(), prefetch)
        return
    if native.available():
        import os as _os

        if _os.environ.get("KMH_NATIVE_PAD", "1") != "0":
            # padding (and optional 2-bit packing) by per-row memcpy in
            # C++ — skips the NumPy fancy-index scatter entirely
            # (KMH_NATIVE_PAD=0 reverts)
            it_native = (native.iter_fastx_packed if packed
                         else native.iter_fastx_padded)

            def produce_cpp():
                for b in it_native(path, batch_rows, max_reads, skip):
                    yield ship(b)

            yield from _prefetch_iter(produce_cpp(), prefetch)
            return

        def repack(b):
            if not packed:
                return b
            seq, qual, lengths, has_qual = b
            return _pack_np(seq), qual, lengths, has_qual

        def produce():
            to_skip = skip
            for raw in native.iter_fastx_raw(path, batch_rows, limit):
                seq_all, qual_all, offsets, qpres = raw
                n = len(qpres)
                if to_skip >= n:
                    to_skip -= n
                    continue
                start, to_skip = to_skip, 0
                yield ship(repack(_pad_from_raw(
                    seq_all, qual_all, offsets, qpres, start, n,
                    batch_rows)))

        yield from _prefetch_iter(produce(), prefetch)
        return
    from .io.fastx import iter_fastx

    def produce_py():
        to_skip = skip
        for recs in iter_fastx(path, batch_size=batch_rows,
                               max_records=limit):
            if to_skip >= len(recs):
                to_skip -= len(recs)
                continue
            if to_skip:
                recs, to_skip = recs[to_skip:], 0
            b = _pad_pow2(recs)
            if packed:
                seq, qual, lengths, has_qual = b
                b = (_pack_np(seq), qual, lengths, has_qual)
            yield ship(b)

    yield from _prefetch_iter(produce_py(), prefetch)


class _DevBatch:
    """A padded batch shipped to the device in the prefetch thread; keeps
    the host views for control flow / hybrid backlog re-runs."""

    __slots__ = ("seq", "qual", "lengths", "has_qual",
                 "seq_h", "qual_h", "lengths_h", "has_qual_h")

    def __init__(self, seq, qual, lengths, has_qual):
        self.seq_h, self.qual_h = seq, qual
        self.lengths_h, self.has_qual_h = lengths, has_qual
        import os

        if os.environ.get("KMH_PREPUT", "1") != "0":
            self.seq = jax.device_put(seq)
            self.qual = jax.device_put(qual)
            self.lengths = jax.device_put(lengths)
            self.has_qual = jax.device_put(has_qual)
        else:  # A/B: leave the upload to the consumer dispatch
            self.seq, self.qual = seq, qual
            self.lengths, self.has_qual = lengths, has_qual


def _ship_to_device(batch) -> "_DevBatch":
    return _DevBatch(*batch)


def _prefetch_iter(it, depth: int = 2):
    """Run an iterator in a daemon thread with a bounded queue: the gz
    decompression + numpy padding of the next batch overlaps the device
    work on the current one (the parser's hot loops run in C/numpy, which
    release the GIL)."""
    if depth <= 0:
        yield from it
        return
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    DONE = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(DONE)
        except BaseException as e:  # surface parse errors to the consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is DONE:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def _pad_from_raw(seq_all, qual_all, offsets, qpres, i: int, j: int,
                  batch_rows: int):
    """Vectorised batch padding from contiguous record buffers."""
    lens = (offsets[i + 1:j + 1] - offsets[i:j]).astype(np.int64)
    B = j - i
    # Row bucket scales with the ACTUAL batch (pow-2), capped at the nominal
    # batch_rows bucket (a 1024-multiple for tuned batch sizes): full
    # batches all share one program; a small file or the final partial
    # batch gets a proportionally small program instead of paying the
    # full pad (keeps CPU tests fast).
    from .io.fastx import row_bucket
    Bp = row_bucket(B, batch_rows)
    Lmax = int(lens.max()) if B else 1
    from .io.fastx import col_bucket
    Lp = col_bucket(Lmax)
    seq = np.full((Bp, Lp), ord("N"), np.uint8)
    qual = np.zeros((Bp, Lp), np.uint8)
    total = int(lens.sum())
    if total:
        rows = np.repeat(np.arange(B, dtype=np.int64), lens)
        starts = np.repeat(offsets[i:j], lens)
        cols = np.arange(total, dtype=np.int64) - np.repeat(
            (np.concatenate([[0], np.cumsum(lens)[:-1]])), lens
        )
        flat = rows * Lp + cols
        src = slice(int(offsets[i]), int(offsets[j]))
        seq.reshape(-1)[flat] = seq_all[src]
        qual.reshape(-1)[flat] = qual_all[src]
    lengths = np.zeros(Bp, np.int32)
    lengths[:B] = lens
    has_qual = np.zeros(Bp, bool)
    has_qual[:B] = qpres[i:j]
    return seq, qual, lengths, has_qual


def _add_canonical_fsm(store: CountStore, emit, fhi, flo, rhi, rlo,
                       source: int):
    chi, clo = enc.canonical_windows(fhi, flo, rhi, rlo)
    store.add_kmers(chi, clo, emit, source=source, defer=True)


@functools.partial(
    jax.jit,
    static_argnames=("k", "counts_n", "source", "min_ll_f", "fsm",
                     "with_noq", "keyonly", "min_q_char", "n_win",
                     "interpret"),
)
def _fused_rp_batch(seq, qual, lengths, has_qual, k: int, counts_n: int,
                    source: int, min_ll_f: float, fsm: str,
                    with_noq: bool = False, keyonly: bool = False,
                    min_q_char: int | None = None,
                    n_win: int | None = None, interpret: bool = False):
    """One fused device program for the whole flagship batch pipeline:
    quality-likelihood FSM (+ no-quality encoder rows) -> canonical
    min(fwd, rc) -> batch sort + segment-reduce -> LSM run.

    One program per batch keeps the loop free of per-op host dispatches.
    Returns (run_hi, run_lo, run_cnt, n_obs[counts_n], flags, n_flag).

    ``fsm`` picks the likelihood FSM (see :func:`_pick_fsm`): "exact"
    (f64 ``ll_scan``), "fast" / "hybrid" (f32 ``ll_scan``, hybrid with
    borderline flags), or "pallas" / "pallas_hybrid" (the same f32 FSM as
    one GPU kernel, ops.pallas_scan; ``interpret`` runs that kernel in the
    Pallas interpreter, for tests).

    ``n_win`` (static) trims the window-start axis to the batch's true
    maximum (bucketed by the caller): window starts past
    ``true_max_len - k`` can never emit, but they inflate the run's
    pow-2 capacity — at 151 bp reads in 192-wide buckets the padded
    window slots are 1.3x the real ones, and every padded row rides
    every LSM tier merge afterwards.
    """
    from .index import count_store as cs

    if isinstance(seq, tuple):  # compact upload form: (codes, nmask)
        seq = enc.unpack_seq(*seq)
    if isinstance(qual, tuple):  # 4-bit dictionary form: (qnib, qdict)
        qual = enc.unpack_qual(*qual)
    min_ll = jnp.asarray(min_ll_f)
    lens_q = jnp.where(has_qual, lengths, 0)
    flags = None
    lb = fsm in ("pallas", "pallas_hybrid")  # kernel outputs are [L, B]
    if lb:
        # in hybrid mode the kernel computes the borderline flag; flagged
        # reads contribute nothing here and are re-counted exactly by the
        # caller's backlog sweep
        from .ops.pallas_scan import ll_scan_pallas

        hybrid = fsm == "pallas_hybrid"
        out = ll_scan_pallas(seq, qual, lens_q, k, min_ll_f,
                             return_flags=hybrid,
                             min_q_char=min_q_char if hybrid else None,
                             interpret=interpret)
        emit, fhi, flo, rhi, rlo = out[:5]
        if hybrid:
            flags = out[5]
            emit = emit & ~flags[None, :]
        hq_bcast = has_qual[None, :]
    elif fsm == "hybrid":
        # fast f32 scan with borderline flags; flagged reads contribute
        # NOTHING here (their windows are re-counted exactly by the
        # caller's backlog sweep) — keeps the hot loop sync-free
        out = si.ll_scan(seq, qual, lens_q, k, min_ll, precision="fast",
                         return_flags=True, min_q_char=min_q_char)
        emit, fhi, flo, rhi, rlo, flags = out
        emit = emit & ~flags[:, None]
        hq_bcast = has_qual[:, None]
    else:
        emit, fhi, flo, rhi, rlo = si.ll_scan(
            seq, qual, lens_q, k, min_ll,
            precision="exact" if fsm == "exact" else "fast",
        )
        hq_bcast = has_qual[:, None]
    chi, clo = enc.canonical_windows(fhi, flo, rhi, rlo)
    if n_win is not None:
        # FSM windows are END-aligned (column p = the window ending at
        # p, ll_scan docstring): columns < k-1 (no full window yet) and
        # columns >= the true max length never emit — keep exactly the
        # n_win columns [k-1, n_win + k - 1)
        if lb:
            nw_end = min(n_win + k - 1, emit.shape[0])
            emit = emit[k - 1:nw_end]
            chi, clo = chi[k - 1:nw_end], clo[k - 1:nw_end]
        else:
            nw_end = min(n_win + k - 1, emit.shape[1])
            emit = emit[:, k - 1:nw_end]
            chi, clo = chi[:, k - 1:nw_end], clo[:, k - 1:nw_end]
    emit = emit & hq_bcast
    if with_noq:
        # no-quality rows take the encoder's windows (start-aligned)
        no_q = (~has_qual) & (lengths > k)
        hi2, lo2, v2 = enc.encode_stream(
            seq, k, jnp.where(no_q, lengths, 0), canonical=True,
            drop_trailing_exact_k=False,
        )
        if n_win is not None:
            nw = min(n_win, v2.shape[1])
            hi2, lo2, v2 = hi2[:, :nw], lo2[:, :nw], v2[:, :nw]
        if lb:
            hi2, lo2, v2 = hi2.T, lo2.T, v2.T
        chi = jnp.where(hq_bcast, chi, hi2)
        clo = jnp.where(hq_bcast, clo, lo2)
        emit = emit | v2
    flat_hi, flat_lo, flat_ok = (chi.reshape(-1), clo.reshape(-1),
                                 emit.reshape(-1))
    onehot = jnp.zeros(counts_n, jnp.uint32).at[source].set(1)
    if keyonly:  # key-only unit run: no count column (CountStore derives)
        r_hi, r_lo, n_scalar = cs._build_run_keys(flat_hi, flat_lo,
                                                  flat_ok, k)
        r_cnt = None
    else:
        r_hi, r_lo, r_cnt, n_scalar = cs._build_run_direct(
            flat_hi, flat_lo, flat_ok, onehot, k
        )
    n_obs = onehot.astype(jnp.int64) * n_scalar
    if flags is None:
        flags = jnp.zeros(seq.shape[0], bool)
    # n_flag rides the fused program, so the sweep reads back one small
    # vector instead of dispatching a sum per batch
    return r_hi, r_lo, r_cnt, n_obs, flags, flags.sum(dtype=jnp.int32)


def count_kmers(seqs: Sequence[str], k: int, source: int = 0,
                source_n: int = 1,
                store: Optional[CountStore] = None) -> CountStore:
    """In-memory multi-source counting (``count.kmers``,
    src/kmer_hash.c:548-591): forward strand only (no canonicalisation), no
    quality, N-delimited windows with the trailing exactly-k drop;
    sequences of length <= k skipped."""
    if not 1 <= k <= MAX_K:
        raise ValueError("k must be a positive integer less than 1+MAX_K")
    if source_n < 1 or source >= source_n:
        raise ValueError("source_n must be larger than 1 and larger than source")
    if store is None:
        store = CountStore(k, counts_n=source_n, mode="khash")
    if store.k != k:
        raise ValueError(
            "mismatch between specified k and that given in the store"
        )
    if isinstance(seqs, (str, bytes)):
        seqs = [seqs]
    todo = [s for s in seqs if len(s) > k]
    if not todo:
        return store
    recs = [("", s.encode() if isinstance(s, str) else bytes(s), None)
            for s in todo]
    seq, _qual, lengths, _hq = _pad_pow2(recs)
    hi, lo, valid = enc.encode_stream(
        seq, k, lengths, canonical=False, drop_trailing_exact_k=True
    )
    store.add_kmers(hi, lo, valid, source=source)
    return store


def _progress(report_every: Optional[int], name: str):
    if not report_every:
        return None
    from .utils.metrics import ProgressMeter

    return ProgressMeter(name=name, report_every=report_every)


@functools.partial(
    jax.jit, static_argnames=("k", "counts_n", "min_q_char", "with_q",
                              "with_noq", "keyonly", "n_win")
)
def _fused_threshold_batch(seq, qual, lengths, has_qual, k: int,
                           counts_n: int, min_q_char: int, with_q: bool,
                           with_noq: bool, keyonly: bool = False,
                           n_win: int | None = None):
    """Fused batch program for the per-base-threshold entries (same
    dispatch-cost and window-trim rationale as _fused_rp_batch)."""
    from .index import count_store as cs

    if isinstance(seq, tuple):  # compact upload form: (codes, nmask)
        seq = enc.unpack_seq(*seq)
    if isinstance(qual, tuple):  # 4-bit dictionary form: (qnib, qdict)
        qual = enc.unpack_qual(*qual)
    mq = jnp.asarray(min_q_char)

    def trim(chi, clo, ok):
        if n_win is None:
            return chi, clo, ok
        # threshold_scan windows are END-aligned like ll_scan's
        nw = max(1, min(n_win, ok.shape[1] - k + 1))
        return (chi[:, k - 1:k - 1 + nw], clo[:, k - 1:k - 1 + nw],
                ok[:, k - 1:k - 1 + nw])

    parts = []
    if with_q:
        out = si.threshold_scan(
            seq, qual, jnp.where(has_qual, lengths, 0), k, mq,
            has_qual=True,
        )
        chi, clo = enc.canonical_windows(*out[1:])
        parts.append(trim(chi, clo, out[0] & has_qual[:, None]))
    if with_noq:
        out = si.threshold_scan(
            seq, qual, jnp.where(~has_qual, lengths, 0), k, mq,
            has_qual=False,
        )
        chi, clo = enc.canonical_windows(*out[1:])
        parts.append(trim(chi, clo, out[0] & (~has_qual)[:, None]))
    flat_hi = jnp.concatenate([p[0].reshape(-1) for p in parts])
    flat_lo = jnp.concatenate([p[1].reshape(-1) for p in parts])
    flat_ok = jnp.concatenate([p[2].reshape(-1) for p in parts])
    onehot = jnp.zeros(counts_n, jnp.uint32).at[0].set(1)
    if keyonly:
        r_hi, r_lo, n_scalar = cs._build_run_keys(flat_hi, flat_lo,
                                                  flat_ok, k)
        r_cnt = None
    else:
        r_hi, r_lo, r_cnt, n_scalar = cs._build_run_direct(
            flat_hi, flat_lo, flat_ok, onehot, k
        )
    return r_hi, r_lo, r_cnt, onehot.astype(jnp.int64) * n_scalar


def _count_fastq_threshold(path: str, k: int, min_q: int,
                           store: CountStore, max_reads: Optional[int],
                           report_every: Optional[int] = None):
    """Shared body of count.kmers.fq / count.kmers.fq.sh: per-base-threshold
    iterator, canonical min(fwd, rc) (src/kmer_hash.c:618-806)."""
    min_q_char = 33 + int(min_q)  # '!' + q, src/kmer_hash.c:633
    meter = _progress(report_every, f"count_fq[{path}]")
    for b in _iter_padded_batches(
            path, max_reads, packed=_use_packed_upload(), to_device=True,
            batch_rows=_tuned_batch_rows(path, k)):
        n_recs = int((b.lengths_h > 0).sum())
        with_q = bool(b.has_qual_h.any())
        with_noq = bool(((~b.has_qual_h) & (b.lengths_h > 0)).any())
        if not (with_q or with_noq):
            continue
        run_hi, run_lo, run_cnt, n_obs = _fused_threshold_batch(
            b.seq, b.qual, b.lengths, b.has_qual, k, store.counts_n,
            min_q_char, with_q, with_noq, keyonly=store.keyonly_runs,
            n_win=win_bucket(b.lengths_h.max(initial=1), k),
        )
        store.add_run(run_hi, run_lo, run_cnt, n_obs)
        if meter:
            meter.update(n_recs,
                         distinct_kmers=lambda: store.peek_n_unique())
    return store.flush()


def count_kmers_fq(path: str, k: int, min_q: int = 0, prefix_bits: int = 16,
                   max_mem_gb: Optional[int] = None,
                   max_reads: Optional[int] = None,
                   store: Optional[CountStore] = None,
                   report_every: Optional[int] = None,
                   budget_semantics: str = "error") -> CountStore:
    """``count.kmers.fq`` (src/kmer_hash.c:618-711): kmer_tree-backed
    canonical counting — spectra include zero cells of allocated prefix
    blocks; optional soft memory budget (src/kmer_tree.c:57-67).
    ``budget_semantics='drop'`` reproduces the reference's silent-drop
    behaviour past the budget (first-come prefix blocks keep counting,
    later prefixes are discarded) instead of raising MemoryError; see
    PARITY.md deviation 7 for the single remaining within-batch
    admission-order caveat."""
    if not 1 <= k <= MAX_K:
        raise ValueError("k must be a positive integer less than 1+MAX_K")
    if store is None:
        pb, sb = derive_prefix_suffix_bits(k, prefix_bits)
        store = CountStore(
            k, counts_n=1, prefix_bits=pb, suffix_bits=sb, mode="ktree",
            max_size_bytes=(max_mem_gb << 30) if max_mem_gb else None,
            budget_semantics=budget_semantics,
        )
    return _count_fastq_threshold(path, k, min_q, store, max_reads,
                                  report_every)


def count_kmers_fq_sh(path: str, k: int, min_q: int = 0,
                      prefix_bits: int = 16,
                      max_mem_gb: Optional[int] = None,
                      max_reads: Optional[int] = None,
                      store: Optional[CountStore] = None,
                      report_every: Optional[int] = None) -> CountStore:
    """``count.kmers.fq.sh`` (src/kmer_hash.c:715-806): suffix_hash-backed
    variant — spectra over present k-mers only."""
    if not 1 <= k <= MAX_K:
        raise ValueError("k must be a positive integer less than 1+MAX_K")
    if store is None:
        pb, sb = derive_prefix_suffix_bits(k, prefix_bits)
        store = CountStore(k, counts_n=1, prefix_bits=pb, suffix_bits=sb,
                           mode="sh")
    return _count_fastq_threshold(path, k, min_q, store, max_reads,
                                  report_every)


def count_kmers_fq_sh_rp(path: str, k: int, prefix_bits: int = 20,
                         min_q: int = 20, n_shards: int = 1,
                         max_reads: Optional[int] = None,
                         max_mem_gb: Optional[int] = None,
                         source_n: int = 1, source: int = 0,
                         store: Optional[CountStore] = None,
                         report_every: Optional[int] = None,
                         exact_ll: bool = True,
                         mesh=None,
                         skip_reads: int = 0,
                         checkpoint_every: Optional[int] = None,
                         checkpoint_path: Optional[str] = None):
    """The flagship path ``count.kmers.fq.sh.rp`` (src/kmer_hash.c:810-857):
    quality-likelihood filtered, canonical, multi-source counting.

    ``n_shards`` mirrors the reference's thread_n parameter; it does not
    change results (the reference's threads shard disjoint prefixes of one
    shared store, src/kmer_reader.c:28-39) and is accepted for API parity.

    ``exact_ll=False`` runs the likelihood filter in float32;
    ``exact_ll="hybrid"`` runs float32
    with borderline-flagging and re-runs only flagged reads in float64 —
    bitwise-equal results to ``exact_ll=True`` at near-fast speed; see
    ops.scan_iter.ll_scan. With ``mesh=`` hybrid runs per-shard: shards
    whose batch rows flagged no read skip the f64 re-scan entirely
    (lax.cond inside the fused program).

    With ``mesh=`` (a jax.sharding.Mesh) counting runs multi-chip: reads
    are data-parallel across devices and each device owns a hash shard of
    the key space (routed via all_to_all); returns a
    parallel.ShardedCountStore. The reference's "thread pool over one
    shared store" becomes chips over a sharded store.

    ``path`` may be a single file or a LIST of files. A list accumulates
    every file into one store (the reference's incremental multi-file
    pattern, src/kmer_hash.c:833-841, test.R:110-127); on a multi-process
    mesh the files are additionally PARTITIONED across hosts (each host
    parses only its own files) whenever any input is gzip — which cannot
    be byte-range-sliced — or there are at least as many files as hosts
    (KMH_FILE_PARTITION=1/0 forces/disables). Cursor-level options
    (skip_reads/max_reads/checkpoint_every) require single-file calls.

    ``skip_reads`` discards the first N records before counting, and with
    ``checkpoint_every=N`` the store plus a progress record (file path,
    reads consumed) is written atomically to ``checkpoint_path`` every N
    reads — together they give mid-file resume for long runs (see
    utils.checkpoint.load_progress and the CLI's --checkpoint-every).
    """
    if checkpoint_every is not None and checkpoint_path is None:
        # statically invalid — fail now, not after checkpoint_every reads
        # of counting when the first checkpoint fires
        raise ValueError("checkpoint_every requires checkpoint_path")
    paths = _normalize_paths(path)
    if paths is not None and len(paths) == 1:
        path, paths = paths[0], None
    if paths is not None and (skip_reads or max_reads is not None
                              or checkpoint_every is not None):
        raise ValueError(
            "a file list supports neither skip_reads, max_reads nor "
            "checkpointing — make incremental per-file calls with store= "
            "for cursor-level control (the reference's multi-file "
            "pattern, test.R:110-127)")
    if mesh is not None:
        return _count_rp_sharded(paths or path, k, min_q, max_reads,
                                 source_n, source, store, mesh, exact_ll,
                                 report_every, skip_reads,
                                 checkpoint_every, checkpoint_path)
    if paths is not None:
        # sequential accumulation into one store, same semantics as
        # incremental per-file calls (src/kmer_hash.c:833-841)
        for p in paths:
            store = count_kmers_fq_sh_rp(
                p, k, prefix_bits, min_q, n_shards, None, max_mem_gb,
                source_n, source, store, report_every, exact_ll)
        return store
    if not 1 <= k <= MAX_K:
        raise ValueError("k must be a positive integer less than 1+MAX_K")
    if not 1 <= source_n <= 4:
        raise ValueError("Source_n must be in the range 1 - 4")
    if source >= source_n:
        raise ValueError("source_i must be less than source_n")
    if store is None:
        pb, sb = derive_prefix_suffix_bits(k, prefix_bits)
        store = CountStore(k, counts_n=source_n, prefix_bits=pb,
                           suffix_bits=sb, mode="sh")
    if store.k != k:
        raise ValueError("Incompatible arguments: k does not match the store")
    if source >= store.counts_n:
        raise ValueError("Value of source is too large")
    min_ll = jnp.asarray(float(Q_TO_LL[33 + int(min_q)]))
    meter = _progress(report_every, f"count_rp[{path}]")
    # fused path: one device program per batch, runs straight into the
    # LSM store — no per-batch eager dispatches or syncs. Hybrid mode
    # excludes borderline-flagged reads on-device and re-counts them
    # exactly in periodic backlog sweeps (one flag readback per
    # ``sweep_every`` batches), so results stay bitwise-equal to
    # exact_ll=True at fast-path speed.
    fsm = _pick_fsm(exact_ll)
    min_ll_f = float(Q_TO_LL[33 + int(min_q)])
    backlog = []  # [(seq_dev, qual_dev, lengths_dev, flags_dev)]
    sweep_every = 64

    def sweep_backlog():
        _sweep_backlog(store, backlog, k, source, min_ll_f)

    batch_rows = _tuned_batch_rows(path, k)

    reads_done = int(skip_reads)
    since_ckpt = 0
    for b in _iter_padded_batches(
            path, max_reads, skip=skip_reads, to_device=True,
            packed=_use_packed_upload(), batch_rows=batch_rows):
        n_recs = int((b.lengths_h > 0).sum())
        with_noq = bool(((~b.has_qual_h) & (b.lengths_h > k)).any())
        n_win = win_bucket(b.lengths_h.max(initial=1), k)
        run_hi, run_lo, run_cnt, n_obs, flags, n_flag = _fused_rp_batch(
            b.seq, b.qual, b.lengths, b.has_qual, k, store.counts_n,
            source, min_ll_f, fsm, with_noq, keyonly=store.keyonly_runs,
            min_q_char=33 + int(min_q), n_win=n_win,
        )
        store.add_run(run_hi, run_lo, run_cnt, n_obs, source=source)
        if fsm in ("hybrid", "pallas_hybrid"):
            backlog.append((b.seq, b.qual, b.lengths, flags, n_win,
                            n_flag))
            if len(backlog) >= sweep_every:
                sweep_backlog()
        reads_done += n_recs
        since_ckpt += n_recs
        if checkpoint_every is not None and since_ckpt >= checkpoint_every:
            since_ckpt = 0
            sweep_backlog()  # checkpointed state must be exact
            _checkpoint_progress(store, checkpoint_path, path, reads_done)
        if meter:
            meter.update(n_recs,
                         distinct_kmers=lambda: store.peek_n_unique())
    sweep_backlog()
    store.flush()
    if checkpoint_every is not None:
        # done only when the file was exhausted (a max_reads-limited leg
        # may have more records left; resume continues from the cursor)
        consumed = reads_done - int(skip_reads)
        _checkpoint_progress(
            store, checkpoint_path, path, reads_done,
            done=max_reads is None or consumed < max_reads,
        )
    return store


def _pick_fsm(exact_ll) -> str:
    """The likelihood FSM for a precision mode on the active backend:
    the f64 exact path is always the ``lax.scan``; the f32 fast and hybrid
    paths run as the Pallas kernel (ops.pallas_scan) on a GPU and as the
    ``lax.scan`` elsewhere."""
    on_gpu = jax.default_backend() == "gpu"
    if exact_ll == "hybrid":
        return "pallas_hybrid" if on_gpu else "hybrid"
    if exact_ll:
        return "exact"
    return "pallas" if on_gpu else "fast"


_SWEEP_ROWS = (256, 2048)  # compacted exact-sweep row buckets (static)


@functools.partial(jax.jit, static_argnames=("rows",))
def _compact_flagged(seq, qual, lengths, flags, rows: int):
    """Gather a batch's flagged rows into a small [rows, L] batch,
    device-side (no host gather / re-upload). Filler rows (when fewer
    than ``rows`` are flagged) carry length 0, so the exact re-scan
    ignores them."""
    _, idx = jax.lax.top_k(flags.astype(jnp.int32), rows)

    def take_rows(x):
        return jnp.take(x, idx, axis=0)

    if isinstance(seq, tuple):
        seq_c = tuple(take_rows(p) for p in seq)
    else:
        seq_c = take_rows(seq)
    if isinstance(qual, tuple):  # (qnib, qdict): the dict rides whole
        qual_c = (take_rows(qual[0]), qual[1])
    else:
        qual_c = take_rows(qual)
    f_c = jnp.take(flags, idx)
    len_c = jnp.where(f_c, jnp.take(lengths, idx), 0)
    return seq_c, qual_c, len_c, f_c


def _sweep_backlog(store, backlog, k, source, min_ll_f) -> None:
    """Re-count the borderline-flagged reads exactly (f64), emptying
    ``backlog`` ([(seq, qual, lengths, flags[, n_win[, n_flag]])]
    device-resident batches; the optional trailing entries are the
    batch's static window-axis trim and its in-program flag count).

    ONE tiny readback (the stacked per-batch flag counts) decides what
    re-runs; flag vectors stay device-side. A batch with a handful of
    flagged reads — the overwhelmingly common case: even at ~1e-6 window
    flag rates nearly every 16K-row batch flags SOME read — compacts its
    flagged rows into the smallest fitting [_SWEEP_ROWS bucket, L] batch
    on device and exact-scans only that, not the whole batch. Batches with more flagged rows than the largest bucket
    (adversarial inputs) fall back to the full-batch exact program with
    non-flagged lengths zeroed. Either way hybrid stays bitwise-equal to
    exact_ll=True."""
    if not backlog:
        return
    # each tuple may carry its flag count as a device scalar computed
    # inside the fused batch program; summing here instead costs one
    # eager dispatch per batch
    n_flags = np.asarray(
        jnp.stack([b[5] if len(b) > 5 else b[3].sum() for b in backlog]))
    buckets = (_SWEEP_ROWS if isinstance(_SWEEP_ROWS, (tuple, list))
               else (_SWEEP_ROWS,))
    for (seq_b, qual_b, len_b, f_b, *rest), nf in zip(backlog, n_flags):
        if nf == 0:
            continue
        n_win = rest[0] if rest else None
        B = int(len_b.shape[0])
        C = next((min(c, B) for c in buckets if nf <= min(c, B)), None)
        if C is not None and C < B:
            seq_c, qual_c, len_c, f_c = _compact_flagged(
                seq_b, qual_b, len_b, f_b, C)
            r = _fused_rp_batch(seq_c, qual_c, len_c, f_c, k,
                                store.counts_n, source, min_ll_f,
                                "exact", False,
                                keyonly=store.keyonly_runs, n_win=n_win)
        else:
            lens = jnp.where(f_b, len_b, 0)
            r = _fused_rp_batch(seq_b, qual_b, lens, f_b, k,
                                store.counts_n, source, min_ll_f,
                                "exact", False,
                                keyonly=store.keyonly_runs, n_win=n_win)
        store.add_run(r[0], r[1], r[2], r[3], source=source)
    backlog.clear()


def _tuned_batch_rows(path: str, k: int) -> Optional[int]:
    """Pick batch rows so a full batch's windows just fill the pow-2 LSM
    run capacity: rows = largest 1024-multiple with rows * n_win <= 2^23
    (~99% capacity utilisation; a pow-2 row bucket at 151 bp reads wastes
    ~1.9x of every tier merge on dead padding, and bigger runs mean one
    fewer merge level per read; the 2^23 target is not yet tuned for the
    H100, ROADMAP S2). Sizes from the MAX length of the first 64
    records (a single short leading read in a variable-length file would
    otherwise inflate rows toward 65536 and overshoot the run-capacity
    target ~2x; variable-length files stay correct either
    way, since n_win is derived per batch). KMH_BATCH_ROWS overrides;
    returns None (the reader's default) when the file can't be peeked."""
    import os

    if os.environ.get("KMH_BATCH_ROWS"):
        return None  # the reader reads the env itself
    try:
        from .io.fastx import iter_fastx

        for recs in iter_fastx(path, batch_size=64, max_records=64):
            if recs:
                lmax = max(len(r[1]) for r in recs)
                n_win = win_bucket(lmax, k)
                rows = (1 << 23) // n_win // 1024 * 1024
                return int(min(max(rows, 8192), 65536))
            break
    except Exception:  # unreadable here; let the reader raise properly
        pass
    return None


def _checkpoint_progress(store, ckpt_path, src_path, reads_done,
                         done: bool = False) -> None:
    """Atomically persist the store + resume cursor (write tmp, replace)."""
    import os

    from .utils import checkpoint as ckpt

    if ckpt_path is None:
        raise ValueError("checkpoint_every requires checkpoint_path")
    tmp = str(ckpt_path) + ".tmp.npz"  # .npz so numpy doesn't re-suffix
    ckpt.save_count_store(
        store, tmp,
        progress={"path": str(src_path), "reads_done": int(reads_done),
                  "done": bool(done)},
    )
    if os.path.exists(tmp):  # multi-process: only process 0 writes
        os.replace(tmp, ckpt_path)


def seq_kmer_depth(store: CountStore, seq, k: int,
                   semantics: str = "intent") -> np.ndarray:
    """``seq.kmer.depth.sh`` (src/kmer_reader.c:155-194): per-position
    canonical k-mer counts, shape (counts_n, len(seq)), NA (INT_MIN) where
    no count was written.

    ``semantics="intent"`` (default) deviates deliberately from the
    reference (PARITY.md dev 1-2, 1b): windows overlapping N are NA (the
    C rolls a stale register across N gaps after exactly-k regions and
    looks up a partial window at end-of-sequence), and counts are
    window-start-aligned (the C's rolling branch writes before ++i,
    shifting every count one column left and dropping each region's first
    window — found by the compiled-C ground-truth diff,
    tests/test_ground_truth.py).

    ``semantics="c"`` reproduces the reference byte-for-byte on the
    device path (the refsem.seq_kmer_depth default): the one-column
    shift, the stale-register windows across N gaps, and the
    partial-window write at end-of-sequence, via post-passes over the
    batched device encodes (see _seq_kmer_depth_c)."""
    if store.k != k:
        raise ValueError("Receieved error from seq_kmer_counts: k mismatch")
    if isinstance(seq, str):
        seq = np.frombuffer(seq.encode(), np.uint8)
    elif isinstance(seq, (bytes, bytearray)):
        seq = np.frombuffer(bytes(seq), np.uint8)
    seq = np.asarray(seq, np.uint8)
    if semantics == "c":
        return _seq_kmer_depth_c(store, seq, k)
    L = int(seq.shape[0])
    Lp = 1 << max(5, (L - 1).bit_length())
    if Lp != L:
        seq = np.concatenate([seq, np.full(Lp - L, ord("N"), np.uint8)])
    hi, lo, valid = enc.encode_stream(
        seq, k, L, canonical=True, drop_trailing_exact_k=False
    )
    rows = store.lookup(hi, lo)  # [Lp, counts_n]
    valid_np = np.asarray(valid)
    out = np.full((store.counts_n, L), np.int32(-(2 ** 31)), np.int32)
    sel = np.where(valid_np[:L])[0]
    out[:, sel] = rows[:L][sel].T
    return out


def _seq_kmer_depth_c(store: CountStore, seq: np.ndarray, k: int
                      ) -> np.ndarray:
    """Exact-C depth track on the device path (src/kmer_reader.c:155-194,
    bit-parity with the compiled C core and refsem.seq_kmer_depth's
    default "c" semantics).

    The C loop is sequential, but its outputs decompose by maximal non-N
    region into three batched sources (PARITY.md dev 1/1b/2):

    * a build-completing region (len >= k) writes column ``s`` = window(s)
      then roll-writes column ``c`` = window(c+1) — all plain windows of
      the ORIGINAL sequence (one batched encode);
    * a region entered with a STALE register (the region right after an
      exactly-k build) mixes up to k-1 pre-gap bases into its first
      windows — exactly the windows of a (prev-k-bases ++ this-region)
      junction snippet (one batched encode of [J, 2k-1] rows);
    * an init() that runs off the end writes the partial register's count
      at column n-k (computed host-side over <= k bases).

    Everything is looked up in ONE batched store.lookup; the planner is
    O(#regions) numpy."""
    n = int(seq.shape[0])
    NA = np.int32(-(2 ** 31))
    out = np.full((store.counts_n, n), NA, np.int32)
    if n < k:
        # the C underflows its output buffer here (PARITY.md dev 2); we
        # validate and return all-NA
        return out
    isn = (seq | np.uint8(0x20)) == np.uint8(ord("n"))
    d = np.diff((~isn).astype(np.int8), prepend=np.int8(0),
                append=np.int8(0))
    r_starts = np.flatnonzero(d == 1)
    r_ends = np.flatnonzero(d == -1)  # exclusive

    Lp = 1 << max(5, (n - 1).bit_length())
    padded = seq
    if Lp != n:
        padded = np.concatenate([seq, np.full(Lp - n, ord("N"), np.uint8)])
    hi_o, lo_o, _v = enc.encode_stream(
        padded, k, n, canonical=True, drop_trailing_exact_k=False
    )
    hi_o, lo_o = np.asarray(hi_o), np.asarray(lo_o)

    # --- planner: columns, and where each column's kmer comes from ------
    # events are (col, src) parallel array blocks, O(#regions) Python
    # with np.arange spans per region (a chromosome-scale query would
    # otherwise spin tens of millions of pure-Python iterations on this
    # ~50x-throttled host): jrow >= 0 -> junction-snippet window jt;
    # else src_o >= 0 -> original window src_o; else the EOS partial
    col_b: list = []
    srco_b: list = []
    jrow_b: list = []
    jt_b: list = []

    def emit(cols_a, srco_a, jrow_a, jt_a):
        col_b.append(np.asarray(cols_a, np.int64))
        srco_b.append(np.asarray(srco_a, np.int64))
        jrow_b.append(np.asarray(jrow_a, np.int64))
        jt_b.append(np.asarray(jt_a, np.int64))

    junctions: list = []     # (prev_start, cur_start, cur_len)
    stale = False
    last_active_end = -1     # end of the last build/stale-rolled region
    last_active_r = -1
    m = len(r_starts)
    for r in range(m):
        s, e = int(r_starts[r]), int(r_ends[r])
        Lr = e - s
        if stale:
            stale = False
            last_active_end, last_active_r = e, r
            jrow = len(junctions)
            junctions.append((int(r_starts[r - 1]), s, Lr))
            t = np.arange(min(Lr, k - 1))    # mixed-register steps
            c = s + t - k
            keep = c >= 0
            nkeep = int(keep.sum())
            emit(c[keep], np.full(nkeep, -1), np.full(nkeep, jrow),
                 (t + 1)[keep])
            c = s + np.arange(k - 1, Lr) - k  # register pure again
            keep = c >= 0
            nkeep = int(keep.sum())
            emit(c[keep], c[keep] + 1, np.full(nkeep, -1),
                 np.zeros(nkeep))
            # roll ended at N (or EOS); next region rebuilds
        elif Lr >= k:
            last_active_end, last_active_r = e, r
            if Lr == k:
                emit([s], [s], [-1], [0])    # rebuild write survives
                stale = True                 # sq[s+k] is N (or EOS)
            else:
                c = np.arange(s, s + Lr - k)  # roll: col c = window(c+1)
                emit(c, c + 1, np.full(c.shape[0], -1),
                     np.zeros(c.shape[0]))
        # else: short region in INIT mode — consumed-but-reset, invisible

    # --- end-of-sequence partial write (init ran off the end) -----------
    partial = None
    if last_active_end == n:
        pass  # rolling/build ended exactly at EOS: loop exits, no write
    elif stale and last_active_r == m - 1:
        pass  # exactly-k build then Ns to EOS: skip_n exits the loop
    else:
        # a rebuild init scanned past last_active_end and hit EOS: its
        # register holds the LAST region's bases (reset at each earlier
        # short region), or nothing if only Ns remain
        if m and last_active_r < m - 1:
            s, e = int(r_starts[-1]), int(r_ends[-1])
            tail = seq[s:e]
        else:
            tail = seq[:0]
        off_f = 0
        off_r = 0
        for b in tail.tolist():
            code = (b >> 1) & 3
            off_f = ((off_f << 2) | code) & 0xFFFFFFFFFFFFFFFF
            off_r = (off_r >> 2) | (((code + 2) % 4) << 62)
        mask = (1 << (2 * k)) - 1 if k < 32 else (1 << 64) - 1
        kmer = min(off_f & mask, off_r >> (64 - 2 * k))
        partial = (np.uint32(kmer >> 32), np.uint32(kmer & 0xFFFFFFFF))
        emit([n - k], [-2], [-1], [0])  # -2 = the EOS partial source

    cols = (np.concatenate(col_b) if col_b
            else np.zeros(0, np.int64))
    if cols.size == 0:
        return out
    srco = np.concatenate(srco_b)
    jrow_a = np.concatenate(jrow_b)
    jt_a = np.concatenate(jt_b)

    # --- junction snippet encode (one batched device call) --------------
    hi_j = lo_j = None
    if junctions:
        W = 2 * k - 1
        Wp = 1 << max(5, (W - 1).bit_length())
        rows_ = np.full((len(junctions), Wp), ord("N"), np.uint8)
        for ji, (ps, cs, cl) in enumerate(junctions):
            rows_[ji, :k] = seq[ps:ps + k]
            take = min(cl, k - 1)
            rows_[ji, k:k + take] = seq[cs:cs + take]
        hj, lj, _vj = enc.encode_stream(
            rows_, k, np.full(len(junctions), W, np.int64),
            canonical=True, drop_trailing_exact_k=False,
        )
        hi_j, lo_j = np.asarray(hj), np.asarray(lj)

    # --- one batched lookup, then scatter into the track -----------------
    E = int(cols.shape[0])
    q_hi = np.zeros(E, np.uint32)
    q_lo = np.zeros(E, np.uint32)
    mj = jrow_a >= 0
    if mj.any():
        q_hi[mj] = hi_j[jrow_a[mj], jt_a[mj]]
        q_lo[mj] = lo_j[jrow_a[mj], jt_a[mj]]
    mo = (~mj) & (srco >= 0)
    if mo.any():
        q_hi[mo] = hi_o[srco[mo]]
        q_lo[mo] = lo_o[srco[mo]]
    mp = (~mj) & (srco == -2)
    if mp.any():
        q_hi[mp], q_lo[mp] = partial
    Ep = 1 << max(3, (E - 1).bit_length())
    if Ep != E:
        q_hi = np.concatenate([q_hi, np.zeros(Ep - E, np.uint32)])
        q_lo = np.concatenate([q_lo, np.zeros(Ep - E, np.uint32)])
    rows = np.asarray(store.lookup(q_hi, q_lo))[:E]  # [E, counts_n]
    out[:, cols] = rows.T
    return out


def _count_rp_sharded(path, k, min_q, max_reads, source_n, source, store,
                      mesh, exact_ll, report_every, skip_reads=0,
                      checkpoint_every=None, checkpoint_path=None):
    from .parallel.sharded import ShardedCountStore

    if store is None:
        store = ShardedCountStore(k, mesh, counts_n=source_n)
    if store.k != k:
        raise ValueError("Incompatible arguments: k does not match the store")
    if source >= store.counts_n:
        raise ValueError("Value of source is too large")
    D = store.n_shards
    precision = ("hybrid" if exact_ll == "hybrid"
                 else "exact" if exact_ll else "fast")
    n_proc = jax.process_count()
    p_idx = jax.process_index()
    import os as _os

    from .io.fastx import is_fourline_fastq, is_gzip

    if isinstance(path, (list, tuple)):
        paths = list(path)
        fp = _os.environ.get("KMH_FILE_PARTITION", "")
        if (n_proc > 1 and fp != "0"
                and (fp == "1" or any(is_gzip(p) for p in paths)
                     or len(paths) >= n_proc)):
            # partition whole files across hosts: the only parse-scaling
            # route for gzip inputs, and the natural one when there are
            # at least as many files as hosts
            return _count_rp_files(paths, k, min_q, source, store,
                                   precision, report_every)
        for p in paths:  # few plain files on many hosts: byte-slice each
            store = _count_rp_sharded(p, k, min_q, None, source_n, source,
                                      store, mesh, exact_ll, report_every)
        return store

    if (n_proc > 1 and skip_reads == 0 and max_reads is None
            and checkpoint_every is None and not is_gzip(path)
            and is_fourline_fastq(path)
            and _os.environ.get("KMH_HOST_SLICE", "1") != "0"):
        # true input data parallelism: each host parses ONLY its own byte
        # range. Mid-file resume / max_reads need global record cursors,
        # so those fall through to the lockstep path below; gzip streams
        # cannot be byte-addressed without decompressing the prefix, and
        # multi-line FASTQ defeats the boundary re-sync (the peek above
        # catches it up front; a post-run continuity check over the
        # resolved boundaries catches any multi-line tail).
        return _count_rp_sliced(path, k, min_q, source, store, precision,
                                report_every)
    meter = _progress(report_every, f"count_rp_sharded[{path}]")
    reads_done = int(skip_reads)
    since_ckpt = 0
    # multi-process (jax.distributed) lockstep fallback: every process
    # streams the same file (each add_batch is a collective) but encodes/
    # feeds only its own row slice of every batch, so each read is counted
    # exactly once and device work is split across hosts; the sliced path
    # above avoids the redundant parse entirely when the input allows it
    min_ll_f = float(Q_TO_LL[33 + int(min_q)])
    for seq, qual, lengths, has_qual in _iter_padded_batches(
            path, max_reads, skip=skip_reads,
            packed=_use_packed_upload(),
            batch_rows=_tuned_batch_rows(path, k)):
        n_recs = int((lengths > 0).sum())
        packed = isinstance(seq, tuple)
        packed_q = isinstance(qual, tuple)
        B = lengths.shape[0]
        # program-structure statics come from the FULL batch so they agree
        # across processes: with_q/with_noq select traced branches and
        # n_win sizes the window axis — all three must be derived BEFORE
        # the per-process row slice (per-slice maxima can straddle a
        # 16-length bucket and trace differently-shaped programs entering
        # the same collective: hang or corrupt routing)
        with_q = bool(has_qual.any())
        with_noq = bool(((~has_qual) & (lengths > 0)).any())
        n_win = win_bucket(lengths.max(initial=1), k)
        if B % D:
            padr = D - B % D
            if packed:  # 0xFF = all-N pad in the compact form
                seq = tuple(np.pad(p, ((0, padr), (0, 0)),
                                   constant_values=0xFF) for p in seq)
            else:
                seq = np.pad(seq, ((0, padr), (0, 0)),
                             constant_values=ord("N"))
            if packed_q:  # nibble 0 unpacks to qdict[0] == 0 == qual pad
                qual = (np.pad(qual[0], ((0, padr), (0, 0))), qual[1])
            else:
                qual = np.pad(qual, ((0, padr), (0, 0)))
            lengths = np.pad(lengths, (0, padr))
            has_qual = np.pad(has_qual, (0, padr))
        if n_proc > 1:  # this process's contiguous row block
            rpp = lengths.shape[0] // n_proc
            sl = slice(p_idx * rpp, (p_idx + 1) * rpp)
            seq = (tuple(p[sl] for p in seq) if packed else seq[sl])
            qual = (qual[0][sl], qual[1]) if packed_q else qual[sl]
            lengths, has_qual = lengths[sl], has_qual[sl]
        if not (with_q or with_noq):
            continue
        # ONE fused shard_map program per batch: FSM + canonical +
        # routing + run build (the sharded twin of _fused_rp_batch)
        store.add_reads(seq, qual, lengths, has_qual, min_ll_f,
                        precision=precision, source=source,
                        with_q=with_q, with_noq=with_noq,
                        min_q_char=33 + int(min_q), n_win=n_win)
        reads_done += n_recs
        since_ckpt += n_recs
        if checkpoint_every is not None and since_ckpt >= checkpoint_every:
            since_ckpt = 0
            _checkpoint_progress(store, checkpoint_path, path, reads_done)
        if meter:
            meter.update(n_recs,
                         distinct_kmers=lambda: int(store.peek_n_unique()))
    if checkpoint_every is not None:
        consumed = reads_done - int(skip_reads)
        _checkpoint_progress(
            store, checkpoint_path, path, reads_done,
            done=max_reads is None or consumed < max_reads,
        )
    return store


def _count_rp_sliced(path, k, min_q, source, store, precision,
                     report_every):
    """Multi-host counting with TRUE per-host input slicing: process p
    parses only the records whose first byte falls in byte range
    [size*p/n, size*(p+1)/n) (boundary re-sync in the range reader), so
    host parse work scales 1/N with hosts — unlike the reference's reader
    pool, where every worker re-reads the whole file and keeps a prefix
    slice (src/kmer_reader.h:32-34), and unlike the round-3 lockstep path,
    which re-parsed the full file on every host.

    ``store.add_reads`` is a collective, so its static program structure
    (row/column shapes, window-axis trim, with_q/with_noq branches) must
    be identical on every process even though each parsed a different
    slice: a tiny per-batch ``process_allgather`` of six host scalars
    aligns them, and processes whose range is exhausted keep feeding
    empty batches until every range is drained."""
    import os

    n_proc = jax.process_count()
    p_idx = jax.process_index()
    size = os.path.getsize(path)
    lo_b = size * p_idx // n_proc
    hi_b = size * (p_idx + 1) // n_proc
    batch_rows = _tuned_batch_rows(path, k) or int(
        os.environ.get("KMH_BATCH_ROWS", "16384"))
    rows_pp = max(-(-batch_rows // n_proc), store.n_shards // n_proc)
    range_info: dict = {}
    it = _iter_padded_batches(path, None, batch_rows=rows_pp,
                              packed=False, byte_range=(lo_b, hi_b),
                              range_info=range_info)
    _reads, my_reads = _aligned_collective_loop(
        it, store, k, min_q, source, precision, report_every,
        f"count_rp_sliced[{path}]")
    _check_slice_continuity(path, range_info, my_reads)
    return store


def _count_rp_files(paths, k, min_q, source, store, precision,
                    report_every):
    """Multi-host counting over a FILE LIST: files are partitioned across
    processes (greedy by size) and each host parses ONLY its own files —
    the gzip-friendly complement of ``_count_rp_sliced`` (gzip streams
    cannot be byte-addressed mid-file, but whole files need no boundary
    re-sync). The reference's R1+R2 corpus pattern — one store, many
    files (test.R:110-127) — becomes a single call whose host parse work
    scales ~1/N. ``store.add_reads`` statics are aligned by the same
    per-batch allgather as the byte-sliced path."""
    import os

    n_proc = jax.process_count()
    p_idx = jax.process_index()
    try:
        sizes = [os.path.getsize(p) for p in paths]
    except OSError:
        # a host cannot stat another host's files: fall back to a
        # stat-free deterministic round-robin assignment
        mine = list(paths[p_idx::n_proc])
    else:
        order = sorted(range(len(paths)), key=lambda i: (-sizes[i], i))
        loads = [0] * n_proc
        assign: list = [[] for _ in range(n_proc)]
        for i in order:
            j = min(range(n_proc), key=lambda t: (loads[t], t))
            assign[j].append(i)
            loads[j] += sizes[i]
        mine = [paths[i] for i in sorted(assign[p_idx])]
    batch_rows = (_tuned_batch_rows(mine[0], k) if mine else None) or int(
        os.environ.get("KMH_BATCH_ROWS", "16384"))
    rows_pp = max(-(-batch_rows // n_proc), store.n_shards // n_proc)

    def produce():
        for p in mine:
            yield from _iter_padded_batches(p, None, batch_rows=rows_pp,
                                            packed=False)

    _aligned_collective_loop(
        produce(), store, k, min_q, source, precision, report_every,
        f"count_rp_files[{len(paths)} files, {len(mine)} mine]")
    return store


def _aligned_collective_loop(it, store, k, min_q, source, precision,
                             report_every, label):
    """Drain ``it`` (host-side padded batches, possibly a different number
    per process) through ``store.add_reads``, aligning the collective's
    static program structure across processes with a per-batch allgather
    of six host scalars; processes whose iterator is exhausted feed all-N
    empty batches until every process drains. Returns
    (global_reads, this_process_reads)."""
    from jax.experimental import multihost_utils

    from .io.fastx import col_bucket

    n_proc = jax.process_count()
    p_idx = jax.process_index()
    d_loc = store.n_shards // n_proc
    meter = _progress(report_every, label)
    min_ll_f = float(Q_TO_LL[33 + int(min_q)])
    it = iter(it)
    reads_done = 0
    my_reads = 0
    while True:
        b = next(it, None)
        if b is None:
            stats = np.zeros(6, np.int64)
            seq = qual = lengths = has_qual = None
        else:
            seq, qual, lengths, has_qual = b
            stats = np.array([
                1, lengths.shape[0], int(lengths.max(initial=0)),
                int(bool(has_qual.any())),
                int(bool(((~has_qual) & (lengths > 0)).any())),
                int((lengths > 0).sum()),
            ], np.int64)
        g = np.asarray(multihost_utils.process_allgather(stats))
        g = g.reshape(n_proc, 6)
        if not g[:, 0].any():
            break
        # collective-aligned statics from the GLOBAL batch
        Bp = -(-max(int(g[:, 1].max()), 1) // d_loc) * d_loc
        lmax_g = max(int(g[:, 2].max()), 1)
        Lp = col_bucket(lmax_g)
        with_q = bool(g[:, 3].any())
        with_noq = bool(g[:, 4].any())
        n_win = win_bucket(lmax_g, k)
        if b is None:
            seq = np.full((Bp, Lp), ord("N"), np.uint8)
            qual = np.zeros((Bp, Lp), np.uint8)
            lengths = np.zeros(Bp, np.int32)
            has_qual = np.zeros(Bp, bool)
        else:
            B0, L0 = seq.shape
            if B0 != Bp or L0 != Lp:
                seq = np.pad(seq[:Bp, :Lp], ((0, Bp - min(B0, Bp)),
                                             (0, Lp - min(L0, Lp))),
                             constant_values=ord("N"))
                qual = np.pad(qual[:Bp, :Lp], ((0, Bp - min(B0, Bp)),
                                               (0, Lp - min(L0, Lp))))
                lengths = np.pad(lengths[:Bp], (0, Bp - min(B0, Bp)))
                has_qual = np.pad(has_qual[:Bp], (0, Bp - min(B0, Bp)))
        if with_q or with_noq:
            store.add_reads(seq, qual, lengths, has_qual, min_ll_f,
                            precision=precision, source=source,
                            with_q=with_q, with_noq=with_noq,
                            min_q_char=33 + int(min_q), n_win=n_win)
        reads_done += int(g[:, 5].sum())
        my_reads += int(g[p_idx, 5])
        if meter:
            meter.update(int(g[:, 5].sum()),
                         distinct_kmers=lambda: int(store.peek_n_unique()))
    return reads_done, my_reads


def _check_slice_continuity(path, range_info, my_reads: int) -> None:
    """Verify the hosts' resolved record boundaries TILE the file exactly:
    host p's stream must end precisely where host p+1's first record
    starts, and the last host must end at EOF. This turns any boundary
    mis-sync (a multi-line FASTQ tail past the is_fourline_fastq peek, a
    pathological quality line fooling the 4-line verifier) into a loud
    error instead of silently dropped reads."""
    import os

    from jax.experimental import multihost_utils

    trip = np.array([
        1 if my_reads > 0 else 0,
        range_info.get("start", -1),
        range_info.get("end", -1),
    ], np.int64)
    g = np.asarray(multihost_utils.process_allgather(trip)).reshape(-1, 3)
    live = [i for i in range(g.shape[0]) if g[i, 0]]
    if not live:
        return  # no records anywhere: nothing to drop
    size = os.path.getsize(path)
    chain = [(int(g[i, 1]), int(g[i, 2])) for i in live]
    ok = all(chain[j][1] == chain[j + 1][0]
             for j in range(len(chain) - 1))
    ok = ok and chain[-1][1] == size
    if not ok:
        raise RuntimeError(
            "multi-host input slices do not tile the file (resolved "
            f"boundaries {chain}, size {size}): records would be dropped "
            "or double-counted — is this a multi-line FASTQ past the "
            "4-line peek? Re-run with KMH_HOST_SLICE=0 (lockstep "
            "streaming) for this input.")
