"""ctypes bindings for the native FASTA/FASTQ parser.

Builds ``fastx.cpp`` on first use with g++ (cached under ``build/native``
in the checkout, or ``KMH_NATIVE_CACHE``) and exposes :func:`read_fastx` with the same
record format as the pure-Python reader. Falls back silently if no
compiler/zlib is available — callers check :func:`available`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
from typing import List, Optional, Tuple

_SRC = pathlib.Path(__file__).parent / "native" / "fastx.cpp"
_lib = None
_tried = False


class _FastxResult(ctypes.Structure):
    _fields_ = [
        ("seq", ctypes.POINTER(ctypes.c_uint8)),
        ("qual", ctypes.POINTER(ctypes.c_uint8)),
        ("offsets", ctypes.POINTER(ctypes.c_int64)),
        ("qual_present", ctypes.POINTER(ctypes.c_uint8)),
        ("names", ctypes.c_char_p),
        ("n_records", ctypes.c_int64),
        ("names_len", ctypes.c_int64),
        ("error", ctypes.c_int),
    ]


def _build() -> Optional[ctypes.CDLL]:
    cache = pathlib.Path(
        os.environ.get(
            "KMH_NATIVE_CACHE",
            str(pathlib.Path(__file__).resolve().parents[2] / "build"
                / "native"),
        )
    )
    cache.mkdir(parents=True, exist_ok=True)
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    so = cache / f"fastx_{tag}.so"
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")  # concurrent builders
        cmd = [
            "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
            str(_SRC), "-o", str(tmp), "-lz",
        ]
        r = subprocess.run(cmd, capture_output=True, timeout=300)
        if r.returncode != 0:
            return None
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.fastx_read.restype = ctypes.POINTER(_FastxResult)
    lib.fastx_read.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.fastx_free.argtypes = [ctypes.POINTER(_FastxResult)]
    lib.fastx_open.restype = ctypes.c_void_p
    lib.fastx_open.argtypes = [ctypes.c_char_p]
    lib.fastx_open_range.restype = ctypes.c_void_p
    lib.fastx_open_range.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
    lib.fastx_handle_tell.restype = ctypes.c_int64
    lib.fastx_handle_tell.argtypes = [ctypes.c_void_p]
    lib.fastx_read_batch.restype = ctypes.POINTER(_FastxResult)
    lib.fastx_read_batch.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.fastx_close.argtypes = [ctypes.c_void_p]
    lib.fastx_fill_padded.restype = None
    lib.fastx_fill_padded.argtypes = [
        ctypes.POINTER(_FastxResult), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.fastx_fill_packed.restype = None
    lib.fastx_fill_packed.argtypes = [
        ctypes.POINTER(_FastxResult), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.fastx_fill_packed2.restype = None
    lib.fastx_fill_packed2.argtypes = [
        ctypes.POINTER(_FastxResult), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
    ]
    return lib


def available() -> bool:
    global _lib, _tried
    if not _tried:
        _tried = True
        if os.environ.get("KMH_NATIVE_IO", "1") != "0":
            try:
                _lib = _build()
            except Exception:
                _lib = None
    return _lib is not None


def read_fastx_raw(path: str, max_records: Optional[int] = None):
    """Contiguous-buffer access: returns (seq_all, qual_all, offsets,
    qual_present) as numpy arrays with ONE bulk copy each — the fast path
    for batch building on a slow host (no per-record Python objects).
    ``offsets`` has n+1 entries into seq_all/qual_all."""
    import numpy as np

    if not available():
        raise RuntimeError("native fastx parser unavailable")
    res = _lib.fastx_read(
        os.fsencode(path), -1 if max_records is None else int(max_records)
    )
    try:
        r = res.contents
        if r.error == 1:
            raise FileNotFoundError(path)
        if r.error == 2:
            raise ValueError(f"unrecognised fastx content in {path}")
        if r.error == 3:
            raise IOError(f"read error (corrupt stream?) in {path}")
        n = int(r.n_records)
        offsets = np.ctypeslib.as_array(r.offsets, shape=(n + 1,)).copy() if n else np.zeros(1, np.int64)
        total = int(offsets[-1])
        seq_all = (np.ctypeslib.as_array(r.seq, shape=(total,)).copy()
                   if total else np.zeros(0, np.uint8))
        qual_all = (np.ctypeslib.as_array(r.qual, shape=(total,)).copy()
                    if total else np.zeros(0, np.uint8))
        qpres = (np.ctypeslib.as_array(r.qual_present, shape=(n,)).copy()
                 if n else np.zeros(0, np.uint8))
        return seq_all, qual_all, offsets, qpres.astype(bool)
    finally:
        _lib.fastx_free(res)


def _result_to_raw(res, path):
    """Copy a FastxResult into numpy arrays and free it."""
    import numpy as np

    try:
        r = res.contents
        if r.error == 1:
            raise FileNotFoundError(path)
        if r.error == 2:
            raise ValueError(f"unrecognised fastx content in {path}")
        if r.error == 3:
            raise IOError(f"read error (corrupt stream?) in {path}")
        n = int(r.n_records)
        offsets = (np.ctypeslib.as_array(r.offsets, shape=(n + 1,)).copy()
                   if n else np.zeros(1, np.int64))
        total = int(offsets[-1])
        seq_all = (np.ctypeslib.as_array(r.seq, shape=(total,)).copy()
                   if total else np.zeros(0, np.uint8))
        qual_all = (np.ctypeslib.as_array(r.qual, shape=(total,)).copy()
                    if total else np.zeros(0, np.uint8))
        qpres = (np.ctypeslib.as_array(r.qual_present, shape=(n,)).copy()
                 if n else np.zeros(0, np.uint8))
        return seq_all, qual_all, offsets, qpres.astype(bool)
    finally:
        _lib.fastx_free(res)


def iter_fastx_raw(path: str, batch_records: int = 4096,
                   max_records: Optional[int] = None):
    """Stream (seq_all, qual_all, offsets, qual_present) raw-buffer batches
    with constant memory — the scalable input path for multi-hundred-GB
    corpora (the whole-file :func:`read_fastx_raw` keeps everything
    resident). Each yielded batch holds up to ``batch_records`` records."""
    if not available():
        raise RuntimeError("native fastx parser unavailable")
    h = _lib.fastx_open(os.fsencode(path))
    if not h:
        raise FileNotFoundError(path)
    try:
        remaining = max_records
        while True:
            take = (batch_records if remaining is None
                    else min(batch_records, remaining))
            if take <= 0:
                return
            out = _result_to_raw(_lib.fastx_read_batch(h, take), path)
            n = len(out[3])
            if n == 0:
                return
            if remaining is not None:
                remaining -= n
            yield out
            if n < take:
                return
    finally:
        _lib.fastx_close(h)


#: Per-process parse accounting: record bytes materialised into batch
#: buffers by the filled iterators below (multi-host input slicing tests
#: assert each process parses ~1/N of the corpus).
STATS = {"bytes_parsed": 0}


def _iter_fastx_filled(path: str, batch_records: int,
                       max_records: Optional[int], skip: int, packed: bool,
                       byte_range: "Optional[Tuple[int, int]]" = None,
                       range_info: Optional[dict] = None):
    """Shared streaming skeleton for the C++-filled padded/packed batch
    iterators (see :func:`iter_fastx_padded` / :func:`iter_fastx_packed`).

    ``byte_range=(start, end)`` restricts the stream to records whose first
    byte falls in [start, end) — the multi-host input slice (plain files
    only; the opener re-synchronises to a record boundary; multi-line
    FASTQ is NOT range-safe — callers must gate, see
    fastx.is_fourline_fastq). ``range_info`` (a dict) receives the
    resolved record-boundary offsets once the iterator is exhausted:
    ``start`` = offset of the first owned record, ``end`` = stream offset
    after the last owned record — consecutive hosts' [start, end) must
    tile the file exactly (the counting path allgathers + checks this, so
    a boundary mis-sync fails loudly instead of dropping reads)."""
    import numpy as np

    if not available():
        raise RuntimeError("native fastx parser unavailable")
    if byte_range is not None:
        if skip:
            raise ValueError("skip and byte_range are mutually exclusive")
        h = _lib.fastx_open_range(os.fsencode(path),
                                  int(byte_range[0]), int(byte_range[1]))
    else:
        h = _lib.fastx_open(os.fsencode(path))
    if not h:
        raise FileNotFoundError(path)
    if range_info is not None:
        range_info["start"] = int(_lib.fastx_handle_tell(h))
    from .fastx import row_cap_bucket

    row_cap = row_cap_bucket(batch_records)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    try:
        remaining = max_records
        to_skip = skip
        while True:
            take = (batch_records if remaining is None
                    else min(batch_records, remaining + to_skip))
            if take <= 0:
                return
            res = _lib.fastx_read_batch(h, take)
            try:
                r = res.contents
                if r.error == 2:
                    raise ValueError(f"unrecognised fastx content in {path}")
                if r.error == 3:
                    raise IOError(f"read error (corrupt stream?) in {path}")
                n = int(r.n_records)
                if n == 0:
                    return
                if to_skip >= n:
                    to_skip -= n
                    if n < take:
                        return
                    continue
                start, to_skip = to_skip, 0
                offs = np.ctypeslib.as_array(r.offsets, shape=(n + 1,))
                STATS["bytes_parsed"] += int(offs[n])
                lmax = int((offs[start + 1:n + 1] - offs[start:n]).max())
                B = n - start
                Bp = min(1 << max(3, (B - 1).bit_length()), row_cap)
                from .fastx import col_bucket
                Lp = col_bucket(lmax)
                qual = np.empty((Bp, Lp), np.uint8)
                lengths = np.empty(Bp, np.int32)
                qpres = np.empty(Bp, np.uint8)
                if packed and os.environ.get("KMH_QDICT", "1") == "0":
                    # A/B gate: 2-bit seq packing without the 4-bit qual
                    # dictionary (raw qual byte plane)
                    codes = np.empty((Bp, Lp // 4), np.uint8)
                    nmask = np.empty((Bp, Lp // 8), np.uint8)
                    _lib.fastx_fill_packed(
                        res, start, n, Bp, Lp,
                        codes.ctypes.data_as(u8p),
                        nmask.ctypes.data_as(u8p),
                        qual.ctypes.data_as(u8p),
                        lengths.ctypes.data_as(i32p),
                        qpres.ctypes.data_as(u8p),
                    )
                    batch = ((codes, nmask), qual, lengths,
                             qpres.astype(bool))
                elif packed:
                    codes = np.empty((Bp, Lp // 4), np.uint8)
                    nmask = np.empty((Bp, Lp // 8), np.uint8)
                    qnib = np.empty((Bp, Lp // 2), np.uint8)
                    qdict = np.empty(16, np.uint8)
                    qflag = np.empty(1, np.int32)
                    _lib.fastx_fill_packed2(
                        res, start, n, Bp, Lp,
                        codes.ctypes.data_as(u8p),
                        nmask.ctypes.data_as(u8p),
                        qual.ctypes.data_as(u8p),
                        qnib.ctypes.data_as(u8p),
                        qdict.ctypes.data_as(u8p),
                        qflag.ctypes.data_as(i32p),
                        lengths.ctypes.data_as(i32p),
                        qpres.ctypes.data_as(u8p),
                    )
                    qmode = int(qflag[0]) & 3
                    if qmode == 1:  # <= 16 distinct: 4-bit dictionary
                        q_out = (qnib, qdict)
                    elif qmode == 2:
                        # 6-bit relative pack: contiguous [Bp, 3Lp/4]
                        # prefix of the raw buffer (zero-copy view);
                        # qdict[0] carries the base (vmin)
                        w6 = (Lp * 3) // 4
                        q_out = (qual.reshape(-1)[: Bp * w6]
                                 .reshape(Bp, w6), qdict[:1])
                    else:
                        q_out = qual
                    # bit 2: batch has no N bases -> omit the nmask plane
                    s_out = ((codes,) if int(qflag[0]) & 4
                             else (codes, nmask))
                    batch = (s_out, q_out, lengths, qpres.astype(bool))
                else:
                    seq = np.empty((Bp, Lp), np.uint8)
                    _lib.fastx_fill_padded(
                        res, start, n, Bp, Lp,
                        seq.ctypes.data_as(u8p), qual.ctypes.data_as(u8p),
                        lengths.ctypes.data_as(i32p),
                        qpres.ctypes.data_as(u8p),
                    )
                    batch = (seq, qual, lengths, qpres.astype(bool))
            finally:
                _lib.fastx_free(res)
            if remaining is not None:
                remaining -= B
            yield batch
            if n < take:
                return
    finally:
        if range_info is not None:
            range_info["end"] = int(_lib.fastx_handle_tell(h))
        _lib.fastx_close(h)


def iter_fastx_padded(path: str, batch_records: int = 4096,
                      max_records: Optional[int] = None, skip: int = 0,
                      byte_range: "Optional[Tuple[int, int]]" = None,
                      range_info: Optional[dict] = None):
    """Stream device-ready padded batches (seq, qual, lengths, has_qual)
    with the padding done by per-row memcpy in C++ (``fastx_fill_padded``)
    instead of a NumPy fancy-index scatter — the fast input path for
    throttled hosts. Shapes follow the same power-of-two bucketing as the
    Python padder: rows to pow2(B) capped at pow2(batch_records), columns
    to pow2(max record length, min 32). ``skip`` discards the first N
    records (mid-file resume); ``byte_range`` restricts to the records
    starting in [start, end) (multi-host input slicing; ``range_info``
    receives the resolved boundary offsets, see _iter_fastx_filled)."""
    yield from _iter_fastx_filled(path, batch_records, max_records, skip,
                                  packed=False, byte_range=byte_range,
                                  range_info=range_info)


def iter_fastx_packed(path: str, batch_records: int = 4096,
                      max_records: Optional[int] = None, skip: int = 0):
    """Like :func:`iter_fastx_padded` but the sequence plane comes out in
    the compact upload form ``(codes[B, Lp/4], nmask[B, Lp/8])`` — 2-bit
    base codes + N bitmask, the exact information the device path consumes
    (ops.encode.base_codes / n_flags) at 4x/8x fewer upload bytes.
    ``ops.encode.unpack_seq`` reconstructs the canonical byte plane
    on-device. The quality plane comes out as ``(qnib[B, Lp/2], qdict[16])``
    (4-bit dictionary indices; byte-exact reconstruction via
    ``ops.encode.unpack_qual``) whenever the batch has <= 16 distinct
    quality byte values — the norm on binned-quality Illumina data — and
    as the raw [B, Lp] byte plane otherwise."""
    yield from _iter_fastx_filled(path, batch_records, max_records, skip,
                                  packed=True)


def read_fastx(
    path: str, max_records: Optional[int] = None
) -> List[Tuple[str, bytes, Optional[bytes]]]:
    if not available():
        raise RuntimeError("native fastx parser unavailable")
    res = _lib.fastx_read(
        os.fsencode(path), -1 if max_records is None else int(max_records)
    )
    try:
        r = res.contents
        if r.error == 1:
            raise FileNotFoundError(path)
        if r.error == 2:
            raise ValueError(f"unrecognised fastx content in {path}")
        if r.error == 3:
            raise IOError(f"read error (corrupt stream?) in {path}")
        n = int(r.n_records)
        if n == 0:
            return []
        offsets = [r.offsets[i] for i in range(n + 1)]
        names = (
            ctypes.string_at(r.names, r.names_len).decode().split("\n")[:n]
            if r.names_len
            else [""] * n
        )
        total = offsets[-1]
        seq_all = ctypes.string_at(r.seq, total) if total else b""
        qual_all = ctypes.string_at(r.qual, total) if total else b""
        out: List[Tuple[str, bytes, Optional[bytes]]] = []
        for i in range(n):
            a, b = offsets[i], offsets[i + 1]
            q = qual_all[a:b] if r.qual_present[i] else None
            out.append((names[i], seq_all[a:b], q))
        return out
    finally:
        _lib.fastx_free(res)
