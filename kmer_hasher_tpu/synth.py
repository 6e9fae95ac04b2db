"""Seeded synthetic sequencing data: FASTA/FASTQ files written from a seed.

Two uses:

* :func:`write_test_data` writes the small files the test suite drives the
  system with. Each reproduces a feature of the data files shipped with
  the reference repository (a single-record ~60 kb FASTA; a 10-read FASTQ whose first
  read starts with ``N``; 2,500 gzipped reads of 51-151 bp; ten 250 bp
  exact ``ACTGG`` repeat reads with a few phred-0 bases), so tests check
  the device path against ``refsem`` on the same bytes.
* :func:`simulate_reads` / :func:`write_fastq` build sequencing runs at
  real scale (millions of reads from a genome, with substitutions, binned
  qualities and N-led reads) in bulk NumPy, for on-device runs.
"""
from __future__ import annotations

import gzip
import os
from typing import Dict, Tuple

import numpy as np

_ACGT = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.zeros(256, np.uint8)
_COMP[list(b"ACGTN")] = list(b"TGCAN")
# NovaSeq-style binned phred+33 qualities ('#'=2, ','=11, ':'=25, 'F'=37)
# and their frequencies: ~4% of bases below phred 20
BINNED_QUALS = np.frombuffer(b"#,:F", np.uint8)
BINNED_PROBS = (0.02, 0.02, 0.08, 0.88)


def random_genome(n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` uniform random bases (uint8 ASCII)."""
    return _ACGT[rng.integers(0, 4, n)]


def repeat_rich_genome(n: int, rng: np.random.Generator,
                       unit: int = 2048, div: float = 0.002
                       ) -> np.ndarray:
    """A satellite-like sequence: random background in the first half,
    then tandem copies of one ``unit``-bp repeat with ``div`` substitution
    divergence per copy. k-mers of the repeat occur thousands of times, so
    the self dot-plot pair stream is quadratic in the array length."""
    out = random_genome(n, rng)
    half = n // 2
    base = random_genome(unit, rng)
    copies = -(-(n - half) // unit)
    arr = np.tile(base, copies)
    mut = rng.random(arr.shape[0]) < div
    arr[mut] = _ACGT[rng.integers(0, 4, int(mut.sum()))]
    out[half:] = arr[: n - half]
    return out


def revcomp(seq: np.ndarray) -> np.ndarray:
    return _COMP[seq[..., ::-1]]


def simulate_reads(genome: np.ndarray, n_reads: int, read_len: int,
                   rng: np.random.Generator, sub_rate: float = 0.01,
                   n_lead_frac: float = 0.005,
                   quals: np.ndarray = BINNED_QUALS,
                   qual_probs=BINNED_PROBS
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Reads sampled uniformly from both strands of ``genome``.

    Returns (seq, qual), each uint8 [n_reads, read_len]. ``sub_rate`` of
    the bases are substituted (to a random base, possibly the same one);
    each base's quality is drawn from ``quals`` with ``qual_probs``;
    ``n_lead_frac`` of the reads start with ``N`` (at ``quals[0]``)."""
    starts = rng.integers(0, genome.shape[0] - read_len + 1, n_reads)
    seq = genome[starts[:, None] + np.arange(read_len)[None, :]]
    rc = rng.random(n_reads) < 0.5
    seq[rc] = revcomp(seq[rc])
    sub = rng.random(seq.shape) < sub_rate
    seq[sub] = _ACGT[rng.integers(0, 4, int(sub.sum()))]
    cdf = np.cumsum(qual_probs)
    qual = quals[np.minimum(np.searchsorted(cdf, rng.random(seq.shape),
                                            side="right"), len(quals) - 1)]
    lead = rng.random(n_reads) < n_lead_frac
    seq[lead, 0] = ord("N")
    qual[lead, 0] = quals[0]
    return seq, qual


def write_fastq(path: str, seq: np.ndarray, qual: np.ndarray,
                first_id: int = 0, chunk: int = 1 << 18) -> None:
    """Write equal-length reads as 4-line FASTQ (``@r<9-digit id>``),
    vectorised in chunks of ``chunk`` reads. A ``.gz`` path is gzipped."""
    n, L = seq.shape
    rec = 12 + L + 1 + 2 + L + 1  # '@r%09d\n' seq '\n+\n' qual '\n'
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        for c0 in range(0, n, chunk):
            c1 = min(n, c0 + chunk)
            m = c1 - c0
            buf = np.empty((m, rec), np.uint8)
            buf[:, 0] = ord("@")
            buf[:, 1] = ord("r")
            ids = np.arange(first_id + c0, first_id + c1, dtype=np.int64)
            for d in range(9):
                buf[:, 10 - d] = ord("0") + (ids // 10 ** d) % 10
            buf[:, 11] = ord("\n")
            buf[:, 12:12 + L] = seq[c0:c1]
            o = 12 + L
            buf[:, o] = ord("\n")
            buf[:, o + 1] = ord("+")
            buf[:, o + 2] = ord("\n")
            buf[:, o + 3:o + 3 + L] = qual[c0:c1]
            buf[:, o + 3 + L] = ord("\n")
            f.write(buf.tobytes())


def _write_records(path: str, records, fastq: bool = True) -> None:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        for name, s, q in records:
            if fastq:
                f.write(b"@%s\n%s\n+\n%s\n" % (name.encode(), s, q))
            else:
                f.write(b">%s\n" % name.encode())
                for i in range(0, len(s), 60):
                    f.write(s[i:i + 60] + b"\n")


def _illumina_quals(L: int, rng: np.random.Generator) -> np.ndarray:
    """One read's phred+33 qualities: high at the start, decaying toward
    the end, with occasional dips (2..41, '#'..'J')."""
    mean = 38.0 - 14.0 * (np.arange(L) / max(L - 1, 1)) ** 2
    q = np.clip(np.round(mean + rng.normal(0.0, 4.0, L)), 2, 41)
    dips = rng.random(L) < 0.02
    q[dips] = rng.integers(2, 12, int(dips.sum()))
    return (33 + q).astype(np.uint8)


def _sample_read(genome: np.ndarray, L: int,
                 rng: np.random.Generator) -> Tuple[bytes, bytes]:
    s0 = int(rng.integers(0, genome.shape[0] - L + 1))
    s = genome[s0:s0 + L].copy()
    if rng.random() < 0.5:
        s = revcomp(s)
    sub = rng.random(L) < 0.005
    s[sub] = _ACGT[rng.integers(0, 4, int(sub.sum()))]
    q = _illumina_quals(L, rng)
    nn = rng.random(L) < 0.002
    s[nn] = ord("N")
    q[nn] = ord("#")
    return s.tobytes(), q.tobytes()


def write_test_data(directory: str, seed: int = 0) -> Dict[str, str]:
    """Write the test suite's data files into ``directory`` (created if
    needed) and return {file name: path}. Deterministic in ``seed``.

    * ``test.fa`` — one record ``SUPER_1`` of 59,940 bp, no N: random
      background with interspersed copies of a diverged 300 bp repeat
      family and short tandem repeats, so k-mer counts and pair tables
      are repeat-rich;
    * ``test_10.fastq`` — 10 reads of 151 bp from that sequence; the
      first read starts with ``N``;
    * ``test.fastq.gz`` — 2,500 gzipped reads of 51-151 bp with
      Illumina-like decaying qualities and rare ``N`` bases;
    * ``repeat_40.fq`` — ten 250 bp reads of exact ``ACTGG`` repeats at
      random phases, high quality with a few phred-0 (``!``) bases.

    Files are written under temporary names and renamed into place, so
    concurrent writers of the same directory never expose partial files.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)

    n = 59940
    fa = random_genome(n, rng)
    fam = random_genome(300, rng)
    for _ in range(40):  # interspersed diverged repeat copies
        L = int(rng.integers(150, 301))
        cp = fam[:L].copy()
        mut = rng.random(L) < 0.05
        cp[mut] = _ACGT[rng.integers(0, 4, int(mut.sum()))]
        at = int(rng.integers(0, n - L))
        fa[at:at + L] = cp
    for unit in (b"AT", b"ACTGG", b"CAG", b"GGAATTCC"):  # tandem repeats
        reps = int(rng.integers(40, 120))
        tr = np.frombuffer(unit * reps, np.uint8)
        at = int(rng.integers(0, n - len(tr)))
        fa[at:at + len(tr)] = tr

    ten = [_sample_read(fa, 151, rng) for _ in range(10)]
    s0, q0 = ten[0]
    ten[0] = (b"N" + s0[1:], b"#" + q0[1:])

    gz = [_sample_read(fa, int(rng.integers(51, 152)), rng)
          for _ in range(2500)]

    rep = []
    for _ in range(10):
        ph = int(rng.integers(0, 5))
        s = (b"ACTGG" * 52)[ph:ph + 250]
        q = bytearray(rng.choice(np.frombuffer(b"FFFFF:", np.uint8),
                                 250).tobytes())
        for i in rng.choice(250, int(rng.integers(1, 4)), replace=False):
            q[int(i)] = ord("!")
        rep.append((s, bytes(q)))

    out = {}
    for name, records, fastq in (
        ("test.fa", [("SUPER_1", fa.tobytes(), None)], False),
        ("test_10.fastq", [(f"read_{i}", s, q)
                           for i, (s, q) in enumerate(ten)], True),
        ("test.fastq.gz", [(f"read_{i}", s, q)
                           for i, (s, q) in enumerate(gz)], True),
        ("repeat_40.fq", [(f"rep_{i}", s, q)
                          for i, (s, q) in enumerate(rep)], True),
    ):
        path = os.path.join(directory, name)
        tmp = f"{path}.{os.getpid()}.tmp"
        if name.endswith(".gz"):
            tmp += ".gz"
        _write_records(tmp, records, fastq)
        os.replace(tmp, path)
        out[name] = path
    return out
