"""Trusted sequential re-implementation of the reference semantics.

This module is the **parity oracle**: a slow, direct Python/NumPy
re-statement of what the C reference (lmjakt/kmer_hasheR) computes,
including its edge-case quirks. Every function
cites the reference code it models. It is used by the test-suite to generate
golden outputs for the device compute path and is NOT on any hot path.

Deliberately reproduced quirks (each has a dedicated test):

* A maximal N-free region of length exactly ``k`` at the *end* of a sequence
  contributes no k-mer to the position index / forward-count paths, because
  the reference checks ``if(!seq[i]) break`` after ``init_kmer`` returns and
  before inserting (src/kmer_pos.c:81-84, src/kmer_hash.c:235-238).
* The quality-likelihood iterator "pollutes" its running window sum with the
  log-likelihood of the base *after* the window during window (re)builds,
  because the accumulating assignment lives inside the ``while`` condition
  that is evaluated once more after the k-th base (src/kmer_util.c:104).
* The rolling window-likelihood update subtracts the *previous new base*'s
  log-likelihood instead of the base leaving the window, so the running sum
  telescopes to ``ll(first k-1 bases of last rebuilt window) + ll(newest)``
  rather than a true sliding sum (src/kmer_util.c:150).
* The depth track rolls a *stale* encoder register across an N gap whenever
  the preceding valid region has length exactly ``k`` (src/kmer_reader.c:170-190,
  the ``skip_n``/``continue`` path re-enters the rolling branch without
  re-initialising), and looks up a partial window at end-of-sequence.
  ``refsem`` reproduces this; the device path implements the documented intent
  (NA for windows overlapping N) — see PARITY.md.

Encoding (src/kmer_util.h:8-12, src/kmer_hash.c:21):
  ``code(c) = (c >> 1) & 3`` maps A->0, C->1, T->2, G->3 (either case);
  the reverse complement of a code is ``(code + 2) % 4``;
  decode table NUC = "ACTG".
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .qll import Q_TO_LL

U64 = (1 << 64) - 1
MAX_K = 32  # src/kmer_util.h:12
NUC = "ACTG"  # src/kmer_hash.c:21
NA_INTEGER = -(2 ** 31)  # R NA_integer_ == INT_MIN (src/kmer_reader.c:163-166)


def base_code(c: int) -> int:
    """2-bit encode one ASCII base: (c>>1)&3  (src/kmer_util.h:8)."""
    return (c >> 1) & 3


def is_n(c: int) -> bool:
    """True for 'n'/'N' (src/kmer_util.c:5, LC macro kmer_util.h:10)."""
    return (c | 0x20) == ord("n")


def kmer_mask(k: int) -> int:
    """2k-bit mask; full 64 bits at k=32 (src/kmer_pos.c:70-77)."""
    return U64 if k >= 32 else (1 << (2 * k)) - 1


def update_offset(off: int, c: int) -> int:
    """Rolling forward update (src/kmer_util.h:8), 64-bit wrap."""
    return ((off << 2) | base_code(c)) & U64


def update_offset_rc(off: int, c: int) -> int:
    """Rolling reverse-complement update (src/kmer_util.h:9)."""
    return (off >> 2) | (((base_code(c) + 2) % 4) << 62)


def decode_kmer(code: int, k: int) -> str:
    """Decode a 2-bit packed k-mer to a string (src/kmer_hash.c:123-133)."""
    out = []
    for shift in range(2 * (k - 1), -1, -2):
        out.append(NUC[(code >> shift) & 3])
    return "".join(out)


def encode_kmer(s: str) -> int:
    """Inverse of :func:`decode_kmer` (test helper)."""
    off = 0
    for ch in s.encode():
        off = update_offset(off, ch)
    return off & kmer_mask(len(s))


def revcomp_code(code: int, k: int) -> int:
    """Reverse-complement of a packed k-mer (semantics of kmer_util.h:9)."""
    out = 0
    for _ in range(k):
        out = (out << 2) | ((code & 3) + 2) % 4
        code >>= 2
    return out


# ---------------------------------------------------------------------------
# N-window initialisers (src/kmer_util.c:4-53)
# ---------------------------------------------------------------------------

def skip_n(seq: bytes, i: int) -> int:
    """Advance past a run of N (src/kmer_util.c:4-8)."""
    n = len(seq)
    while i < n and is_n(seq[i]):
        i += 1
    return i


def skip_n_qual(seq: bytes, qual: Optional[bytes], min_q: int, i: int) -> int:
    """Advance past N or low-quality bases (src/kmer_util.c:10-14)."""
    n = len(seq)
    while i < n and (is_n(seq[i]) or (qual is not None and qual[i] < min_q)):
        i += 1
    return i


def init_kmer(seq: bytes, i: int, k: int) -> Tuple[int, int]:
    """Build the first valid k-window at/after ``i``.

    Returns ``(index just past the window, rolling offset)``; the caller must
    check whether the index ran off the end (src/kmer_util.c:18-32).
    """
    n = len(seq)
    j = 0
    off = 0
    while i < n:
        off = 0
        j = 0
        while j < k and i + j < n and not is_n(seq[i + j]):
            off = update_offset(off, seq[i + j])
            j += 1
        if i + j >= n or j == k:
            break
        i = skip_n(seq, i + j)
        j = 0
    return i + j, off


def init_kmer_qual_2(
    seq: bytes, qual: Optional[bytes], min_q: int, i: int, k: int
) -> Tuple[int, int, int]:
    """Forward + reverse-complement window build with per-base quality gate
    ``qual >= min_q`` (src/kmer_util.c:35-53). Returns (i_past, off, off_rc).
    """
    n = len(seq)
    j = 0
    off = 0
    off_rc = 0
    while i < n:
        off = 0
        off_rc = 0
        j = 0
        while (
            j < k
            and i + j < n
            and not is_n(seq[i + j])
            and (qual is None or qual[i + j] >= min_q)
        ):
            off = update_offset(off, seq[i + j])
            off_rc = update_offset_rc(off_rc, seq[i + j])
            j += 1
        if i + j >= n or j == k:
            break
        i = skip_n_qual(seq, qual, min_q, i + j)
        j = 0
    return i + j, off, off_rc


# ---------------------------------------------------------------------------
# Position index (src/kmer_pos.c)
# ---------------------------------------------------------------------------

@dataclass
class RefKmerHash:
    """Oracle analogue of ``khash_ptr`` (src/kmer_pos.h:43-48): mapping
    packed k-mer -> list of 1-based start positions, in insertion order.
    ``order`` records first-insertion order of keys; the C iteration order is
    a khash bucket-layout artifact, so table parity is checked as multiset /
    canonically-sorted equality (see SURVEY.md section 7)."""

    k: int
    pos: Dict[int, List[int]] = field(default_factory=dict)
    order: List[int] = field(default_factory=list)
    kmer_count: int = 0  # number of distinct k-mers inserted


def seq_to_hash(seq: bytes, k: int, h: Optional[RefKmerHash] = None) -> RefKmerHash:
    """Stream a sequence into the position index (src/kmer_pos.c:66-98).

    Pushes 1-based window-start positions ``i+1-k``; forward strand only, no
    canonicalisation. A trailing N-free region of exactly ``k`` bases is
    dropped (the ``if(!seq[i]) break`` quirk, src/kmer_pos.c:82-83).
    """
    if h is None:
        h = RefKmerHash(k=k)
    mask = kmer_mask(k)
    n = len(seq)
    i = 0

    def insert(kmer: int, p: int) -> None:
        if kmer not in h.pos:
            h.pos[kmer] = []
            h.order.append(kmer)
            h.kmer_count += 1
        h.pos[kmer].append(p)

    while i < n:
        i, off = init_kmer(seq, i, k)
        if i >= n:
            break
        insert(off & mask, i + 1 - k)
        while i < n and not is_n(seq[i]):
            off = update_offset(off, seq[i])
            i += 1
            insert(off & mask, i + 1 - k)
    return h


def make_kmer_hash(seq: str, k: int) -> RefKmerHash:
    """R entry ``make.kmer.hash`` (src/kmer_hash.c:506-540): validates
    1 <= k <= 32 and len(seq) > k (strict), indexes the sequence."""
    if not 1 <= k <= MAX_K:
        raise ValueError("k must be a positive integer less than 1+MAX_K")
    if len(seq) <= k:
        raise ValueError("the length of the sequence must be at least k")
    return seq_to_hash(seq.encode(), k)


def kmer_positions(h: RefKmerHash, opt_flag: int) -> Dict[str, object]:
    """R entry ``kmer.pos`` (src/kmer_hash.c:1054-1147), emitted in canonical
    sorted-by-kmer-code order (the C emits khash bucket order, an
    implementation artifact; i indices are the 1-based rank in emission
    order either way). opt_flag bits: 1=kmer 2=pos 4=pair.pos 8=count
    (src/kmer_hash.c:17)."""
    keys = sorted(h.pos)
    counts = np.array([len(h.pos[key]) for key in keys], dtype=np.int32)
    out: Dict[str, object] = {"kmer": None, "pos": None, "pair.pos": None, "count": None}
    if opt_flag & 1:
        out["kmer"] = [decode_kmer(key, h.k) for key in keys]
    if opt_flag & 2:
        i_col = np.repeat(np.arange(1, len(keys) + 1, dtype=np.int32), counts)
        p_col = np.concatenate(
            [np.asarray(h.pos[key], dtype=np.int32) for key in keys]
        ) if keys else np.zeros(0, np.int32)
        out["pos"] = np.stack([i_col, p_col], axis=1)
    if opt_flag & 4:
        # upper-triangle expansion per k-mer: rows (i, pos[a], pos[b]), a<b,
        # in the reference's (j, k) nested-loop order (kmer_hash.c:1113-1121)
        def tri(n: int) -> Tuple[np.ndarray, np.ndarray]:
            # row-major strict upper-triangle indices in O(n(n-1)/2)
            lens = np.arange(n - 1, 0, -1)
            a = np.repeat(np.arange(n - 1), lens)
            starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
            r = np.arange(lens.sum())
            b = r - np.repeat(starts, lens) + a + 1
            return a, b

        tri_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        blocks: List[np.ndarray] = []
        for i, key in enumerate(keys, start=1):
            n = len(h.pos[key])
            if n < 2:
                continue
            if n not in tri_cache:
                tri_cache[n] = tri(n)
            a, b = tri_cache[n]
            p = np.asarray(h.pos[key], dtype=np.int32)
            blk = np.empty((len(a), 3), dtype=np.int32)
            blk[:, 0] = i
            blk[:, 1] = p[a]
            blk[:, 2] = p[b]
            blocks.append(blk)
        out["pair.pos"] = (
            np.concatenate(blocks, axis=0) if blocks else np.zeros((0, 3), np.int32)
        )
    if opt_flag & 8:
        out["count"] = counts
    return out


def seq_kmer_positions(h: RefKmerHash, seq: str, k: int) -> np.ndarray:
    """R entry ``seq.kmer.pos`` (src/kmer_pos.c:101-136, src/kmer_hash.c:1151).

    Streams the query; for each query k-mer present in the index emits one
    (i, j) row per indexed position, where ``i`` is the 1-based position of
    the k-mer's LAST base in the query (the post-window index, push sites
    src/kmer_pos.c:127,131-132) and ``j`` the 1-based start in the indexed
    sequence. Requires ``k <= 31`` and ``len(seq) > k``
    (src/kmer_hash.c:1163-1164). Row order is query-stream order and IS
    deterministic apart from within-kmer position order (insertion order =
    ascending), so exact equality is meaningful here."""
    if len(seq) <= k or k > 31:
        raise ValueError(
            "the sequence should be longer than k and k should not be longer than 31"
        )
    sq = seq.encode()
    mask = kmer_mask(k)
    rows: List[Tuple[int, int]] = []
    n = len(sq)
    i = 0
    while i < n:
        i, off = init_kmer(sq, i, k)
        if i >= n:
            break
        for j in h.pos.get(off & mask, ()):  # pair_positions_push
            rows.append((i, j))
        while i < n and not is_n(sq[i]):
            off = update_offset(off, sq[i])
            i += 1
            for j in h.pos.get(off & mask, ()):
                rows.append((i, j))
    return np.array(rows, dtype=np.int32).reshape(-1, 2)


def kmer_pair_pos(a: RefKmerHash, b: RefKmerHash) -> np.ndarray:
    """R entry ``kmer.pairs`` (src/kmer_hash.c:1174-1203): cross product of
    positions for k-mers present in both indexes. The reference version is
    known-broken (unchecked ``kh_exist`` after a failed ``kh_get``,
    src/kmer_hash.c:1184-1185, crash noted test.R:330-331); this is the
    intended semantics, emitted in sorted-key order."""
    rows: List[Tuple[int, int]] = []
    for key in sorted(a.pos):
        if key in b.pos:
            for x in a.pos[key]:
                for y in b.pos[key]:
                    rows.append((x, y))
    return np.array(rows, dtype=np.int32).reshape(-1, 2)


# ---------------------------------------------------------------------------
# Quality-likelihood k-mer iterator (src/kmer_util.c:55-161)
# ---------------------------------------------------------------------------

def iter_kmers_ll(
    seq: bytes, qual: Optional[bytes], k: int, min_q: int
) -> Iterator[Tuple[int, int, int]]:
    """The streaming iterator used by the reader-pool counting path
    (src/kmer_util.c:95-161), yielding ``(end_index_exclusive, fwd, rc)`` for
    each accepted window.

    With ``qual``: a window is accepted iff its running log-likelihood beats
    ``min_ll = Q_TO_LL['!' + min_q]``; reproduces both the window-build
    pollution and the telescoped rolling update (module docstring). N is NOT
    checked on this path (N bases encode as G and are normally rejected via
    their low quality). Without ``qual``: N-delimited windows.
    """
    n = len(seq)
    mask = kmer_mask(k)
    rc_shift = 64 - 2 * k
    if qual is None:
        yield from _iter_kmers_nq(seq, k, mask, rc_shift)
        return
    min_ll = float(Q_TO_LL[33 + min_q])
    s = 0
    while True:
        # --- kmer_iterator_begin (src/kmer_util.c:95-128) ---
        fwd = 0
        rev = 0
        kmer_ll = 0.0
        prev_ll = 0.0
        i = 0
        p = s
        # while(*seq && ((kmer_ll += ll) > min_ll) && i < k): note the
        # condition-order: the (k+1)-th base's ll is accumulated (pollution)
        # before the i<k test stops the loop (src/kmer_util.c:104).
        while p < n:
            kmer_ll += float(Q_TO_LL[qual[p]])
            if not (kmer_ll > min_ll):
                break
            if not (i < k):
                break
            fwd = update_offset(fwd, seq[p])
            rev = update_offset_rc(rev, seq[p])
            prev_ll = float(Q_TO_LL[qual[p]])
            p += 1
            i += 1
        else:
            # ran off the end of the read
            if i != k:
                return
        if i != k:
            # skip individually-bad bases, then retry (src/kmer_util.c:120-127)
            while p < n and float(Q_TO_LL[qual[p]]) <= min_ll:
                p += 1
            if p >= n:
                return
            s = p
            continue
        yield p, fwd & mask, rev >> rc_shift
        # --- kmer_iterator_next (src/kmer_util.c:145-161) ---
        while True:
            if p >= n:
                return
            kmer_ll += float(Q_TO_LL[qual[p]]) - prev_ll
            if kmer_ll < min_ll:
                s = p + 1  # begin(++seq, ++qual): offending base consumed
                break
            fwd = update_offset(fwd, seq[p])
            rev = update_offset_rc(rev, seq[p])
            prev_ll = float(Q_TO_LL[qual[p]])
            p += 1
            yield p, fwd & mask, rev >> rc_shift
        if s >= n:
            return


def _iter_kmers_nq(
    seq: bytes, k: int, mask: int, rc_shift: int
) -> Iterator[Tuple[int, int, int]]:
    """No-quality variant (src/kmer_util.c:68-93,131-143): N-delimited,
    emits every N-free window (restart logic scans them in order)."""
    n = len(seq)
    s = 0
    while True:
        fwd = 0
        rev = 0
        i = 0
        p = s
        while p < n and not is_n(seq[p]) and i < k:
            fwd = update_offset(fwd, seq[p])
            rev = update_offset_rc(rev, seq[p])
            p += 1
            i += 1
        if i != k:
            p = skip_n(seq, p)
            if p >= n:
                return
            s = p
            continue
        yield p, fwd & mask, rev >> rc_shift
        while True:
            if p >= n:
                return
            if is_n(seq[p]):
                s = p + 1
                break
            fwd = update_offset(fwd, seq[p])
            rev = update_offset_rc(rev, seq[p])
            p += 1
            yield p, fwd & mask, rev >> rc_shift
        if s >= n:
            return


def iter_kmers_qual_threshold(
    seq: bytes, qual: Optional[bytes], k: int, min_q: int
) -> Iterator[Tuple[int, int, int]]:
    """Window stream of the per-base-threshold counting loops
    ``seq_to_counts_kt`` / ``seq_to_counts_sh`` (src/kmer_hash.c:257-332):
    window build requires ``qual >= min_q`` (src/kmer_util.c:42) while the
    rolling step requires strictly ``qual > min_q`` (src/kmer_hash.c:278,317)
    — the documented inconsistency. Also reproduces the trailing exactly-k
    region drop (``if(!seq[i]) break``). Yields (end_exclusive, fwd, rc)."""
    n = len(seq)
    mask = kmer_mask(k)
    rc_shift = 64 - 2 * k
    i = 0
    while i < n:
        i, off, off_rc = init_kmer_qual_2(seq, qual, min_q, i, k)
        if i >= n:
            break
        yield i, off & mask, (off_rc >> rc_shift) & mask
        while i < n and not is_n(seq[i]) and (qual is None or qual[i] > min_q):
            off = update_offset(off, seq[i])
            off_rc = update_offset_rc(off_rc, seq[i])
            i += 1
            yield i, mask & off, mask & (off_rc >> rc_shift)


# ---------------------------------------------------------------------------
# Counting stores (src/kmer_tree.c, src/suffix_hash.c)
# ---------------------------------------------------------------------------

@dataclass
class RefCountStore:
    """Oracle analogue of ``suffix_hash_n`` (src/suffix_hash.h:53-64) and,
    with ``track_allocated``, of ``kmer_tree``'s dense-block accounting
    (zero cells of allocated prefix blocks appear in the spectrum,
    src/kmer_tree.c:85-99)."""

    k: int
    counts_n: int = 1
    prefix_bits: int = 0
    suffix_bits: int = 0
    counts: Dict[int, List[int]] = field(default_factory=dict)
    allocated_prefixes: set = field(default_factory=set)

    def add(self, kmer: int, source: int = 0) -> int:
        if source >= self.counts_n:
            return -1
        self.allocated_prefixes.add(kmer >> self.suffix_bits)
        c = self.counts.get(kmer)
        if c is None:
            c = [0] * self.counts_n
            self.counts[kmer] = c
        c[source] += 1
        return c[source]

    def count(self, kmer: int) -> List[int]:
        return list(self.counts.get(kmer, [0] * self.counts_n))


def derive_prefix_suffix_bits(k: int, prefix_bits: int) -> Tuple[int, int]:
    """Reader-pool bit split (src/kmer_reader.c:86-95): clamp prefix to 36,
    suffix = 2k - prefix, then clamp suffix to 32 re-deriving prefix.
    (We additionally clamp prefix to 2k — the reference underflows its
    unsigned subtraction and errors out for prefix_bits > 2k; the split is
    a sharding detail with no observable output effect.)"""
    total = 2 * k
    prefix_bits = min(prefix_bits, 36, total)
    suffix_bits = total - prefix_bits
    if suffix_bits > 32:
        suffix_bits = 32
        prefix_bits = total - 32
    return prefix_bits, suffix_bits


def count_kmers_seqs(
    seqs: Sequence[str], k: int, source: int, source_n: int,
    store: Optional[RefCountStore] = None,
) -> RefCountStore:
    """R entry ``count.kmers`` (src/kmer_hash.c:548-591): forward strand
    only (NO canonicalisation), no quality, N-delimited windows, per-source
    counts; sequences of length <= k skipped; trailing exactly-k region
    dropped (src/kmer_hash.c:233-238)."""
    if store is None:
        store = RefCountStore(k=k, counts_n=source_n)
    if store.k != k:
        raise ValueError("mismatch between specified k and store k")
    mask = kmer_mask(k)
    for s in seqs:
        if len(s) <= k:
            continue
        sq = s.encode()
        n = len(sq)
        i = 0
        while i < n:
            i, off = init_kmer(sq, i, k)
            if i >= n:
                break
            store.add(off & mask, source)
            while i < n and not is_n(sq[i]):
                off = update_offset(off, sq[i])
                i += 1
                store.add(off & mask, source)
    return store


def count_kmers_reads_threshold(
    reads: Sequence[Tuple[bytes, Optional[bytes]]], k: int, min_q_phred: int,
    store: Optional[RefCountStore] = None, prefix_bits: int = 0,
    track_allocated: bool = False,
) -> RefCountStore:
    """FASTQ counting of ``count.kmers.fq`` / ``count.kmers.fq.sh``
    (src/kmer_hash.c:618-806): canonical ``min(fwd, rc)`` k-mers
    (src/kmer_hash.c:274,313), per-base quality threshold iterator, reads of
    length <= k skipped. ``min_q_phred`` is converted with ``'!' + q``
    (src/kmer_hash.c:633)."""
    if store is None:
        suffix_bits = 2 * k - prefix_bits
        store = RefCountStore(k=k, counts_n=1, prefix_bits=prefix_bits,
                              suffix_bits=suffix_bits)
    min_q = 33 + min_q_phred
    for sq, qual in reads:
        if len(sq) <= k:
            continue
        for _end, fwd, rc in iter_kmers_qual_threshold(sq, qual, k, min_q):
            store.add(min(fwd, rc), 0)
    return store


def count_kmers_reads_ll(
    reads: Sequence[Tuple[bytes, Optional[bytes]]], k: int, min_q_phred: int,
    source: int = 0, store: Optional[RefCountStore] = None,
    source_n: int = 1, prefix_bits: int = 20, max_reads: Optional[int] = None,
) -> RefCountStore:
    """The flagship reader-pool path ``count.kmers.fq.sh.rp``
    (src/kmer_hash.c:810-857, src/kmer_reader.c:41-77): quality-likelihood
    iterator, canonical min(fwd, rc) (src/kmer_reader.c:30), reads with
    length <= k skipped (src/kmer_reader.c:54-55). The thread-count prefix
    sharding (src/kmer_reader.c:33) partitions work but not results, so the
    oracle ignores it."""
    if store is None:
        pb, sb = derive_prefix_suffix_bits(k, prefix_bits)
        store = RefCountStore(k=k, counts_n=source_n, prefix_bits=pb,
                              suffix_bits=sb)
    for ri, (sq, qual) in enumerate(reads):
        if max_reads is not None and ri >= max_reads:
            break
        if len(sq) <= k:
            continue
        for _end, fwd, rc in iter_kmers_ll(sq, qual, k, min_q_phred):
            store.add(min(fwd, rc), source)
    return store


def seq_kmer_depth(store: RefCountStore, seq: str, k: int,
                   semantics: str = "c") -> np.ndarray:
    """R entry ``seq.kmer.depth.sh`` (src/kmer_reader.c:155-194): per-position
    canonical-k-mer counts, shape (counts_n, len(seq)), NA = INT_MIN where no
    window was written.

    ``semantics="c"`` (default, the spec) transliterates the reference loop
    exactly, validated bit-for-bit against the *compiled* C core
    (tests/test_ground_truth.py). Note the rolling branch writes its count
    at column ``i-k`` BEFORE ``++i`` (src/kmer_reader.c:189-190), so column
    ``c`` holds the count of the window *starting at c+1* and each valid
    region's first window is overwritten (its count appears nowhere, the
    region's last column stays NA) — a one-column shift versus the
    window-start alignment the surrounding code implies. Also reproduced:
    the stale-register re-entry after exactly-k regions and the
    partial-window write at end-of-sequence (module docstring).

    ``semantics="intent"`` is window-start-aligned: column ``c`` = count of
    the window starting at ``c``, the behaviour the reference's own
    description implies and what the device path implements (PARITY.md).
    """
    sq = seq.encode()
    n = len(sq)
    counts = np.full((store.counts_n, n), NA_INTEGER, dtype=np.int64)
    mask = kmer_mask(k)
    rc_shift = 64 - 2 * k
    off_f = 0
    off_r = 0
    i = 0
    while i < n:
        if i == 0 or is_n(sq[i]):
            i, off_f, off_r = init_kmer_qual_2(sq, None, 0, i, k)
            kmer_f = off_f & mask
            kmer_r = off_r >> rc_shift
            kmer = min(kmer_f, kmer_r)
            if i - k >= 0:  # reference writes unconditionally (OOB if i<k)
                counts[:, i - k] = store.count(kmer)
            if i >= n:
                break
            if is_n(sq[i]):
                i = skip_n(sq, i)
                continue  # stale-register quirk: falls through to rolling
        off_f = update_offset(off_f, sq[i])
        off_r = update_offset_rc(off_r, sq[i])
        kmer_f = off_f & mask
        kmer_r = off_r >> rc_shift
        kmer = min(kmer_f, kmer_r)
        if semantics == "intent":
            i += 1
        if i - k >= 0:
            counts[:, i - k] = store.count(kmer)
        if semantics != "intent":
            i += 1  # C increments AFTER the write: the one-column shift
    return counts


# ---------------------------------------------------------------------------
# Spectra (src/kmer_tree.c:85-99, src/suffix_hash.c:112-129,335-425)
# ---------------------------------------------------------------------------

def kmer_spectrum(store: RefCountStore, max_count: int,
                  include_allocated_zeros: bool = False) -> np.ndarray:
    """Histogram of per-kmer counts, clamped into the last bin
    (src/suffix_hash.c:112-129). With ``include_allocated_zeros`` models the
    ``kmer_tree`` dense scan where all 2^suffix_bits cells of every allocated
    prefix block contribute, zeros included (src/kmer_tree.c:85-99)."""
    out = np.zeros(max_count + 1, dtype=np.float64)
    for vals in store.counts.values():
        c = vals[0]
        out[min(c, max_count)] += 1
    if include_allocated_zeros:
        per_block = 1 << store.suffix_bits
        nonzero_cells: Dict[int, int] = {}
        for kmer in store.counts:
            p = kmer >> store.suffix_bits
            nonzero_cells[p] = nonzero_cells.get(p, 0) + 1
        for p in store.allocated_prefixes:
            out[0] += per_block - nonzero_cells.get(p, 0)
    return out


def kmer_spectrum_n(
    store: RefCountStore, max_count: int, comb: Sequence[int],
    comb_inner: Sequence[int], source_min: Sequence[int],
) -> np.ndarray:
    """Combinatorial multi-source spectrum ``kmer.spec.sh.n``
    (src/suffix_hash.c:335-425): per k-mer a presence bit-flag
    ``val[j] >= source_min[j]``; for each requested combination (exact match
    if ``comb_inner`` else any-overlap) increments a
    (comb_n*counts_n) x (max_count+1) histogram."""
    comb = list(comb)
    comb_inner = list(comb_inner)
    cn = store.counts_n
    comb_n = len(comb)
    for i in range(comb_n):
        if not 0 <= comb_inner[i] <= 1:
            raise ValueError("comb_inner values must be 0 or 1")
        if comb[i] >= (1 << cn):
            raise ValueError("comb values must be < 2^counts_n")
    out = np.zeros((comb_n * cn, max_count + 1), dtype=np.float64)
    for vals in store.counts.values():
        flag = 0
        for j in range(cn):
            flag |= int(vals[j] >= source_min[j]) << j
        for jj in range(comb_n):
            if (comb_inner[jj] and flag == comb[jj]) or (
                not comb_inner[jj] and (flag & comb[jj]) > 0
            ):
                for s in range(cn):
                    c = min(vals[s], max_count)
                    out[jj * cn + s, c] += 1
    return out
