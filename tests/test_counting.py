"""Counting paths (device) vs the oracle — BASELINE config 3 (fastq
counting on test_10.fastq + repeat_40.fq, k=21) and the full entry family."""
import numpy as np
import pytest

from kmer_hasher_tpu import refsem as rs
from kmer_hasher_tpu.api import (
    count_kmers,
    count_kmers_fq,
    count_kmers_fq_sh,
    count_kmers_fq_sh_rp,
    kmer_spectrum,
    kmer_spectrum_n,
    seq_kmer_depth,
)



def store_dict(store):
    return {k: v for k, v in store.counts_dict().items()}


def oracle_dict(st: rs.RefCountStore):
    return {k: list(v) for k, v in st.counts.items()}


# ---------------------------------------------------------------------------
# count.kmers (in-memory, forward-only, multi-source)
# ---------------------------------------------------------------------------

def test_count_kmers_matches_oracle():
    seqs = ["ACGTACGTA", "ggttacNgtACA", "TTTT", "ACGTANNACGT"]
    got = count_kmers(seqs, k=4, source=0, source_n=2)
    got = count_kmers(["ACACACACAC"], k=4, source=1, source_n=2, store=got)
    want = rs.count_kmers_seqs(seqs, 4, 0, 2)
    want = rs.count_kmers_seqs(["ACACACACAC"], 4, 1, 2, store=want)
    assert store_dict(got) == oracle_dict(want)


def test_count_kmers_validation():
    with pytest.raises(ValueError):
        count_kmers(["ACGT"], k=4, source=2, source_n=2)
    st = count_kmers(["ACGTACGT"], k=4, source=0, source_n=1)
    with pytest.raises(ValueError):
        count_kmers(["ACGTACGT"], k=5, source=0, source_n=1, store=st)


# ---------------------------------------------------------------------------
# fastq counting — threshold paths (count.kmers.fq / .sh)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,min_q", [(5, 20), (21, 2)])
def test_count_fq_sh_matches_oracle(ref, k, min_q, repeat_40_fq):
    got = count_kmers_fq_sh(f"{ref}/repeat_40.fq", k=k, min_q=min_q,
                            prefix_bits=2)
    reads = [(s, q) for (_n, s, q) in repeat_40_fq]
    want = rs.count_kmers_reads_threshold(reads, k=k, min_q_phred=min_q,
                                          prefix_bits=2)
    assert store_dict(got) == oracle_dict(want)


def test_count_fq_ktree_spectrum_zero_cells(ref, repeat_40_fq):
    # kmer_tree mode: spectrum bin 0 counts the zero cells of allocated
    # dense blocks (the reference's table(spc.0) structure, test.R:409-417)
    k = 5
    got = count_kmers_fq(f"{ref}/repeat_40.fq", k=k, min_q=0, prefix_bits=1)
    spec = kmer_spectrum(got, 10000)
    reads = [(s, q) for (_n, s, q) in repeat_40_fq]
    want = rs.count_kmers_reads_threshold(
        reads, k=k, min_q_phred=0, prefix_bits=1)
    want.suffix_bits = 2 * k - 1
    want_spec = rs.kmer_spectrum(want, 10000, include_allocated_zeros=True)
    np.testing.assert_array_equal(spec, want_spec)
    assert spec[0] > 0  # zero cells present


# ---------------------------------------------------------------------------
# flagship: count.kmers.fq.sh.rp (BASELINE config 3)
# ---------------------------------------------------------------------------

def test_rp_test10_and_repeat40_k21(ref, test_10_fastq, repeat_40_fq):
    # min_q=10: at min_q=20 a whole 21-mer of repeat_40's q32 bases fails
    # the whole-window likelihood test and source 1 would be all zeros
    # (verified faithful to the reference; see PARITY docs) — 10 keeps the
    # multi-source path non-trivial
    k, min_q = 21, 10
    st = count_kmers_fq_sh_rp(f"{ref}/test_10.fastq", k=k, min_q=min_q,
                              source_n=2, source=0)
    st = count_kmers_fq_sh_rp(f"{ref}/repeat_40.fq", k=k, min_q=min_q,
                              source_n=2, source=1, store=st)
    reads10 = [(s, q) for (_n, s, q) in test_10_fastq]
    reads40 = [(s, q) for (_n, s, q) in repeat_40_fq]
    want = rs.count_kmers_reads_ll(reads10, k=k, min_q_phred=min_q,
                                   source=0, source_n=2)
    want = rs.count_kmers_reads_ll(reads40, k=k, min_q_phred=min_q,
                                   source=1, source_n=2, store=want)
    assert store_dict(st) == oracle_dict(want)


def test_rp_gz_subset(ref, test_fastq_gz):
    k, min_q = 21, 20
    st = count_kmers_fq_sh_rp(f"{ref}/test.fastq.gz", k=k, min_q=min_q,
                              max_reads=400)
    reads = [(s, q) for (_n, s, q) in test_fastq_gz[:400]]
    want = rs.count_kmers_reads_ll(reads, k=k, min_q_phred=min_q)
    assert store_dict(st) == oracle_dict(want)


def test_rp_incremental_doubles(ref, repeat_40_fq):
    st = count_kmers_fq_sh_rp(f"{ref}/repeat_40.fq", k=5, min_q=0)
    once = store_dict(st)
    st = count_kmers_fq_sh_rp(f"{ref}/repeat_40.fq", k=5, min_q=0, store=st)
    twice = store_dict(st)
    assert set(once) == set(twice)
    for kk, v in once.items():
        assert twice[kk][0] == 2 * v[0]


def test_rp_validation(ref):
    with pytest.raises(ValueError):
        count_kmers_fq_sh_rp(f"{ref}/repeat_40.fq", k=5, source_n=5)
    with pytest.raises(ValueError):
        count_kmers_fq_sh_rp(f"{ref}/repeat_40.fq", k=5, source_n=2, source=2)


# ---------------------------------------------------------------------------
# depth track + spectra
# ---------------------------------------------------------------------------

def test_depth_track_matches_oracle(ref, repeat_40_fq):
    k = 5
    st = count_kmers_fq_sh_rp(f"{ref}/repeat_40.fq", k=k, min_q=0,
                              source_n=2, source=0)
    reads = [(s, q) for (_n, s, q) in repeat_40_fq]
    want_st = rs.count_kmers_reads_ll(reads, k=k, min_q_phred=0,
                                      source=0, source_n=2)
    seq = repeat_40_fq[0][1].decode()
    got = seq_kmer_depth(st, seq, k)
    want = rs.seq_kmer_depth(want_st, seq, k, semantics="intent")
    np.testing.assert_array_equal(got, want.astype(np.int64))
    # and a sequence with Ns + novel kmers (no stale-register degenerate
    # regions: valid regions around the N are longer than k)
    seq2 = seq[:40] + "N" + "TTTTTTTTCCCC" + seq[40:80]
    got2 = seq_kmer_depth(st, seq2, k)
    want2 = rs.seq_kmer_depth(want_st, seq2, k, semantics="intent")
    np.testing.assert_array_equal(got2, want2.astype(np.int64))


def test_depth_k_mismatch(ref, repeat_40_fq):
    st = count_kmers_fq_sh_rp(f"{ref}/repeat_40.fq", k=5, min_q=0)
    with pytest.raises(ValueError):
        seq_kmer_depth(st, "ACGTACGTAA", 6)


def test_spectrum_matches_oracle(ref, test_fastq_gz):
    k, min_q = 16, 10
    st = count_kmers_fq_sh_rp(f"{ref}/test.fastq.gz", k=k, min_q=min_q,
                              max_reads=300)
    reads = [(s, q) for (_n, s, q) in test_fastq_gz[:300]]
    want_st = rs.count_kmers_reads_ll(reads, k=k, min_q_phred=min_q)
    np.testing.assert_array_equal(kmer_spectrum(st, 50),
                                  rs.kmer_spectrum(want_st, 50))


def test_spectrum_n_matches_oracle(ref, test_10_fastq, repeat_40_fq):
    k = 7
    st = count_kmers_fq_sh_rp(f"{ref}/test_10.fastq", k=k, min_q=0,
                              source_n=2, source=0)
    st = count_kmers_fq_sh_rp(f"{ref}/repeat_40.fq", k=k, min_q=0,
                              source_n=2, source=1, store=st)
    want = rs.count_kmers_reads_ll(
        [(s, q) for (_n, s, q) in test_10_fastq], k=k, min_q_phred=0,
        source=0, source_n=2)
    want = rs.count_kmers_reads_ll(
        [(s, q) for (_n, s, q) in repeat_40_fq], k=k, min_q_phred=0,
        source=1, source_n=2, store=want)
    comb, inner, smin = [3, 1, 2], [1, 0, 0], [1, 1]
    got = kmer_spectrum_n(st, 30, comb, inner, smin)
    exp = rs.kmer_spectrum_n(want, 30, comb, inner, smin)
    np.testing.assert_array_equal(got, exp)
    with pytest.raises(ValueError):
        kmer_spectrum_n(st, 30, [4], [1], smin)  # comb >= 2^counts_n
    with pytest.raises(ValueError):
        kmer_spectrum_n(st, 30, [1], [2], smin)  # bad inner


def test_small_k_prefix_bits_clamped(ref):
    # k < 8 with the default prefix_bits=16 used to give negative
    # suffix_bits and negative spectrum bins (round-1 advisor finding)
    import numpy as np
    from kmer_hasher_tpu import counting

    st = counting.count_kmers_fq(f"{ref}/repeat_40.fq", k=5)
    spec = st.spectrum(6000)
    assert (spec >= 0).all()
    assert st.suffix_bits >= 0
    # khash-free check: total mass equals distinct kmers (+ zero cells)
    assert spec.sum() >= st.n_unique


def test_count_store_rejects_bad_bits():
    import pytest
    from kmer_hasher_tpu.index.count_store import CountStore

    with pytest.raises(ValueError):
        CountStore(5, prefix_bits=16)  # suffix would be negative
    with pytest.raises(ValueError):
        CountStore(32, prefix_bits=40)


def test_packed_upload_counts_bitwise_equal(ref, monkeypatch):
    """KMH_PACK_UPLOAD (2-bit seq upload) must not change any store."""
    from kmer_hasher_tpu import counting

    path = f"{ref}/test.fastq.gz"
    monkeypatch.setenv("KMH_PACK_UPLOAD", "0")
    a = counting.count_kmers_fq_sh(path, k=21, min_q=20, max_reads=600)
    c = counting.count_kmers_fq(path, k=11, min_q=10, max_reads=600)
    monkeypatch.setenv("KMH_PACK_UPLOAD", "1")
    b = counting.count_kmers_fq_sh(path, k=21, min_q=20, max_reads=600)
    d = counting.count_kmers_fq(path, k=11, min_q=10, max_reads=600)
    assert a.counts_dict() == b.counts_dict()
    assert np.array_equal(np.asarray(c.spectrum(12)),
                          np.asarray(d.spectrum(12)))


def test_fasta_records_counted_without_quality(ref, monkeypatch):
    """FASTA input through the fq entries takes the no-quality branch
    (encoder windows, no likelihood filter) — single-chip and sharded,
    packed and unpacked uploads all bitwise equal."""
    from kmer_hasher_tpu import counting
    from kmer_hasher_tpu.io import read_fastx
    from kmer_hasher_tpu.ops import encode as enc

    path = f"{ref}/test.fa"
    k = 15
    monkeypatch.setenv("KMH_PACK_UPLOAD", "1")
    a = counting.count_kmers_fq_sh(path, k=k, min_q=20)
    monkeypatch.setenv("KMH_PACK_UPLOAD", "0")
    b = counting.count_kmers_fq_sh(path, k=k, min_q=20)
    assert a.counts_dict() == b.counts_dict()
    # expected: canonical windows of the raw sequence (no trailing-k drop),
    # emitted only because len > k
    _n, seq, _q = read_fastx(path)[0]
    arr = np.frombuffer(seq, np.uint8)
    L = len(arr)
    Lp = 1 << (L - 1).bit_length()
    arr = np.concatenate([arr, np.full(Lp - L, ord("N"), np.uint8)])
    hi, lo, valid = enc.encode_stream(arr, k, L, canonical=True,
                                      drop_trailing_exact_k=False)
    assert int(a.total_added.sum()) == int(np.asarray(valid).sum())
    # sharded path, packed upload
    from kmer_hasher_tpu.parallel.mesh import make_mesh

    monkeypatch.setenv("KMH_PACK_UPLOAD", "1")
    c = counting.count_kmers_fq_sh_rp(path, k=k, min_q=20,
                                      mesh=make_mesh(8))
    assert int(c.total_added.sum()) == int(a.total_added.sum())
    assert int(c.n_unique.sum()) == a.n_unique


def test_q6_packed_counting_matches_unpacked(tmp_path, monkeypatch):
    """Stress-style quals (>16 distinct, range < 63) take the 6-bit
    relative upload pack; the store must be identical to the raw-plane
    path (byte-exact reconstruction feeds even the f64 FSM)."""
    import numpy as np

    from kmer_hasher_tpu import counting

    rng = np.random.default_rng(0)
    path = tmp_path / "q6.fq"
    with open(path, "w") as f:
        for i in range(64):
            seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 60))
            qual = "".join(chr(int(q)) for q in rng.integers(35, 70, 60))
            f.write(f"@r{i}\n{seq}\n+\n{qual}\n")
    st_packed = counting.count_kmers_fq_sh_rp(str(path), k=11, min_q=20)
    monkeypatch.setenv("KMH_PACK_UPLOAD", "0")
    st_raw = counting.count_kmers_fq_sh_rp(str(path), k=11, min_q=20)
    assert st_packed.counts_dict() == st_raw.counts_dict()
    assert st_packed.total_added.tolist() == st_raw.total_added.tolist()


def test_depth_track_c_semantics_matches_refsem(ref, repeat_40_fq):
    """VERDICT r3: semantics="c" on the device path reproduces the
    reference's depth loop exactly (one-column shift, stale-register
    windows across N gaps after exactly-k regions, partial end-of-seq
    writes) — refsem's "c" mode is the bit-exact oracle
    (src/kmer_reader.c:155-194, ground-truth tested)."""
    k = 5
    st = count_kmers_fq_sh_rp(f"{ref}/repeat_40.fq", k=k, min_q=0,
                              source_n=2, source=0)
    reads = [(s, q) for (_n, s, q) in repeat_40_fq]
    want_st = rs.count_kmers_reads_ll(reads, k=k, min_q_phred=0,
                                      source=0, source_n=2)
    base = repeat_40_fq[0][1].decode()
    rng = np.random.default_rng(11)
    queries = [
        base,                                     # no N at all
        "ACTGG" + "N" + base[:30],                # exactly-k head -> stale
        base[:25] + "NN" + "ACTGG" + "N" + base[30:60],  # mid stale
        "ACTGG" + "N" + "GGA" + "NN" + base[:20],  # stale over short region
        base[:20] + "NNN",                        # trailing Ns (partial 0)
        base[:20] + "N" + "GGA",                  # trailing short region
        "ACTGG" + "N",                            # exactly-k then Ns: none
        "NNNNNNN",                                # all N (partial 0)
        "GGA",                                    # shorter than k -> NA
        "ACT" + "N" + "GG",                       # only short regions
        base[:5],                                 # exactly k, no N
    ]
    for _ in range(20):  # fuzz: random N-riddled strings
        L = int(rng.integers(k, 60))
        chars = rng.choice(list("ACGTN"), size=L,
                           p=[0.22, 0.22, 0.22, 0.22, 0.12])
        queries.append("".join(chars))
    for q in queries:
        got = seq_kmer_depth(st, q, k, semantics="c")
        want = rs.seq_kmer_depth(want_st, q, k, semantics="c")
        np.testing.assert_array_equal(
            got, want.astype(np.int64), err_msg=f"query={q!r}")


def test_tuned_batch_rows(ref):
    """Tuned rows fill the 2^23 run capacity: 151 bp -> n_win 140 ->
    59392 rows (1024-multiple), clamped to [8192, 65536]; env override
    returns None so the reader's env path wins."""
    from kmer_hasher_tpu.counting import _tuned_batch_rows

    rows = _tuned_batch_rows(f"{ref}/repeat_40.fq", 21)  # 250 bp reads
    # 250 -> bucket16 256 -> n_win 236 -> 2^23//236//1024*1024 = 34816
    assert rows == 34816
    import os
    os.environ["KMH_BATCH_ROWS"] = "12345"
    try:
        assert _tuned_batch_rows(f"{ref}/repeat_40.fq", 21) is None
    finally:
        del os.environ["KMH_BATCH_ROWS"]
    assert _tuned_batch_rows("/nonexistent.fq", 21) is None


def test_fused_batch_n_win_trim_equivalence(ref):
    """The static window-axis trim must not change results: same run
    contents with and without n_win, on pure-qual, pure-noq, and MIXED
    has_qual batches (the where-mixed branch aligns FSM end-aligned and
    encoder start-aligned columns)."""
    from kmer_hasher_tpu.counting import _fused_rp_batch
    from kmer_hasher_tpu.qll import Q_TO_LL

    rng = np.random.default_rng(3)
    bases = np.frombuffer(b"ACGT", np.uint8)
    B, L, k = 16, 64, 9
    seq = bases[rng.integers(0, 4, (B, L))]
    qual = rng.integers(63, 74, (B, L)).astype(np.uint8)
    lengths = rng.integers(k + 1, 42, B).astype(np.int32)  # lmax < L
    min_ll_f = float(Q_TO_LL[33 + 20])
    lmax = int(lengths.max())
    n_win = max(1, -(-lmax // 16) * 16 - k + 1)
    for hq in (np.ones(B, bool), np.zeros(B, bool),
               rng.random(B) < 0.5):
        ref = _fused_rp_batch(seq, qual, lengths, hq, k, 1, 0, min_ll_f,
                              "fast", True, keyonly=True)
        got = _fused_rp_batch(seq, qual, lengths, hq, k, 1, 0, min_ll_f,
                              "fast", True, keyonly=True, n_win=n_win)
        # run contents are sorted unique keys; compare live prefixes via
        # the multiset of live (hi, lo)
        def live(r):
            h, lo_ = np.asarray(r[0]), np.asarray(r[1])
            m = ~((h == 0xFFFFFFFF) & (lo_ == 0xFFFFFFFF))
            return sorted(zip(h[m].tolist(), lo_[m].tolist()))
        assert live(got) == live(ref)
        np.testing.assert_array_equal(np.asarray(got[3]),
                                      np.asarray(ref[3]))


def test_rp_spill_ranged_fold_matches_oracle(ref, test_fastq_gz, monkeypatch):
    """CLAUDE.md parity rule for the ranged fold: the spill + out-of-core
    rejoin path must stay bit-identical to refsem on the seeded data."""
    monkeypatch.setenv("KMH_FOLD_BUDGET_BYTES", "16384")
    monkeypatch.setenv("KMH_BATCH_ROWS", "64")
    from kmer_hasher_tpu.index.count_store import CountStore

    k, min_q = 21, 20
    st = CountStore(k, counts_n=1, spill_bytes=32768)
    st = count_kmers_fq_sh_rp(f"{ref}/test.fastq.gz", k=k, min_q=min_q,
                              max_reads=400, store=st)
    assert st._spill_seq >= 2  # the regime: multiple runs spilled
    assert st._ranged_fold_needed(0) or not st._spilled
    reads = [(s, q) for (_n, s, q) in test_fastq_gz[:400]]
    want = rs.count_kmers_reads_ll(reads, k=k, min_q_phred=min_q)
    assert store_dict(st) == oracle_dict(want)


def test_slice_continuity_check(ref):
    """The multi-host boundary continuity check: tiling boundaries pass,
    a gap (dropped records) raises."""
    import pytest

    from kmer_hasher_tpu.counting import _check_slice_continuity

    path = f"{ref}/repeat_40.fq"
    import os

    size = os.path.getsize(path)
    # single process owning the whole file: [0, size) passes
    _check_slice_continuity(path, {"start": 0, "end": size}, my_reads=10)
    # empty host: no records anywhere -> no check
    _check_slice_continuity(path, {}, my_reads=0)
    # a host that stopped short of EOF (boundary mis-sync) must raise
    with pytest.raises(RuntimeError, match="do not tile"):
        _check_slice_continuity(path, {"start": 0, "end": size - 37},
                                my_reads=10)
