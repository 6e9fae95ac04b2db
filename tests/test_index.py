"""KmerIndex (device path) vs the refsem oracle — the BASELINE config
'make.kmer.hash(test.fa, k=8) + kmer.pos opt.flag=15' and edge cases."""
import numpy as np
import pytest

from kmer_hasher_tpu import refsem as rs
from kmer_hasher_tpu.index import KmerIndex


def canonical_tables_from_oracle(h: rs.RefKmerHash, opt_flag: int):
    """Oracle tables are already emitted in canonical sorted-key order."""
    return rs.kmer_positions(h, opt_flag)


def test_small_index_exact():
    seq = "ACGTACGTTTACGT"
    k = 4
    idx = KmerIndex(seq, k)
    h = rs.make_kmer_hash(seq, k)
    t = canonical_tables_from_oracle(h, 15)
    assert idx.kmer_strings() == t["kmer"]
    np.testing.assert_array_equal(idx.counts(), t["count"])
    np.testing.assert_array_equal(idx.pos_table(), t["pos"])
    np.testing.assert_array_equal(idx.pair_table(), t["pair.pos"])


def test_index_with_ns_and_trailing_quirk():
    seq = "ACGTANNACGTNNNGGGGGNACG"
    k = 4
    idx = KmerIndex(seq, k)
    h = rs.make_kmer_hash(seq, k)
    t = canonical_tables_from_oracle(h, 15)
    assert idx.kmer_strings() == t["kmer"]
    np.testing.assert_array_equal(idx.pos_table(), t["pos"])
    np.testing.assert_array_equal(idx.counts(), t["count"])
    np.testing.assert_array_equal(idx.pair_table(), t["pair.pos"])


@pytest.mark.parametrize("k", [1, 8, 16, 17, 32])
def test_random_sequence_parity(k):
    rng = np.random.default_rng(k)
    seq = "".join(rng.choice(list("ACGTacgtN"), size=400,
                             p=[.12, .12, .12, .12, .12, .12, .12, .12, .04]))
    if len(seq) <= k:
        return
    idx = KmerIndex(seq, k)
    h = rs.make_kmer_hash(seq, k)
    t = canonical_tables_from_oracle(h, 15)
    assert idx.kmer_strings() == t["kmer"]
    np.testing.assert_array_equal(idx.pos_table(), t["pos"])
    np.testing.assert_array_equal(idx.counts(), t["count"])
    np.testing.assert_array_equal(idx.pair_table(), t["pair.pos"])


def test_baseline_config_test_fa_k8(test_fa):
    """BASELINE config 1 on the seeded test.fa, full tables (pairs on a slice
    -- full-table pair count asserted exactly, content spot-checked by
    chunk)."""
    k = 8
    idx = KmerIndex(test_fa, k)
    h = rs.make_kmer_hash(test_fa, k)
    t = rs.kmer_positions(h, 1 | 2 | 8)
    assert idx.kmer_strings() == t["kmer"]
    np.testing.assert_array_equal(idx.counts(), t["count"])
    np.testing.assert_array_equal(idx.pos_table(), t["pos"])
    assert idx.n_kmers == len(t["kmer"])
    c = np.asarray(t["count"], np.int64)
    assert idx.total_pairs == int((c * (c - 1) // 2).sum())
    # stream the first chunk and verify against the oracle's leading rows
    t_pairs = rs.kmer_positions(rs.make_kmer_hash(test_fa[:4000], k), 4)
    idx2 = KmerIndex(test_fa[:4000], k)
    np.testing.assert_array_equal(idx2.pair_table(), t_pairs["pair.pos"])


def test_pair_chunking_matches_monolithic():
    seq = "ACGT" * 50 + "TTGCA" * 10
    idx = KmerIndex(seq, 3)
    whole = idx.pair_table()
    chunks = np.concatenate(list(idx.iter_pair_chunks(capacity=64)), axis=0)
    np.testing.assert_array_equal(whole, chunks)
    assert len(whole) == idx.total_pairs


def test_pair_table_guard():
    idx = KmerIndex("A" * 100, 4)
    with pytest.raises(MemoryError):
        idx.pair_table(max_pairs=10)


def test_validation_errors():
    with pytest.raises(ValueError):
        KmerIndex("ACGT", 0)
    with pytest.raises(ValueError):
        KmerIndex("ACGT", 33)
    with pytest.raises(ValueError):
        KmerIndex("ACGT", 4)


def test_k32_all_g_kmers_with_invalid_tail():
    # 32 consecutive Gs: real all-ones keys share the invalid sentinel and
    # must still sort live-first with ascending positions (the safe 2-key
    # branch of sort_windows)
    import kmer_hasher_tpu.refsem as rs
    from kmer_hasher_tpu.index import KmerIndex

    seq = "G" * 40 + "A" + "G" * 35 + "N" + "ACGT" * 3
    idx = KmerIndex(seq, 32)
    oracle = rs.seq_to_hash(seq.encode(), 32)
    tab = idx.tables(opt_flag=10)  # pos + count
    want_total = sum(len(v) for v in oracle.pos.values())
    assert tab["pos"].shape[0] == want_total
    all_g = (1 << 64) - 1
    got = {}
    kmers_sorted = sorted(oracle.pos)
    for i, p in tab["pos"]:
        got.setdefault(kmers_sorted[i - 1], []).append(int(p))
    assert got == oracle.pos
    assert len(oracle.pos[all_g]) == 9 + 4  # sanity: the degenerate case


def test_k16_all_g_kmers_with_invalid_tail():
    # 16 consecutive Gs: lo == 0xFFFFFFFF, so the packed single-u64 branch
    # of sort_windows puts a real all-ones *high word* next to the invalid
    # sentinel — only the position low word separates them. Must still
    # sort live-first with ascending positions.
    seq = "G" * 20 + "A" + "G" * 17 + "N" + "ACGT" * 4
    k = 16
    idx = KmerIndex(seq, k)
    h = rs.make_kmer_hash(seq, k)
    t = canonical_tables_from_oracle(h, 15)
    assert idx.kmer_strings() == t["kmer"]
    np.testing.assert_array_equal(idx.counts(), t["count"])
    np.testing.assert_array_equal(idx.pos_table(), t["pos"])
    np.testing.assert_array_equal(idx.pair_table(), t["pair.pos"])


def test_build_many_matches_individual(test_fa):
    """KmerIndex.build_many: one batched device build per length bucket,
    each result byte-identical to an individually built index."""
    from kmer_hasher_tpu.index import KmerIndex

    k = 9
    # >= 4 sequences in the 512-bucket so the BATCHED path actually runs
    # (long rows / tiny buckets route to individual 1-D builds)
    seqs = [test_fa[:500], test_fa[500:1700], test_fa[1700:1764],
            test_fa[2000:2500], "ACTG" * 40 + "N" + "GGATC" * 30,
            test_fa[3000:3400], test_fa[3400:3900]]
    from kmer_hasher_tpu.index import position_index as pix

    batched_shapes = []
    real_build = pix.build_index_arrays

    def spy(arr, kk, lens, **kw):
        if getattr(arr, "ndim", 1) == 2:
            batched_shapes.append(tuple(arr.shape))
        return real_build(arr, kk, lens, **kw)

    pix.build_index_arrays = spy
    try:
        many = KmerIndex.build_many(seqs, k)
    finally:
        pix.build_index_arrays = real_build
    assert batched_shapes == [(5, 512)]  # the batched path actually ran
    assert len(many) == len(seqs)
    for s, ix in zip(seqs, many):
        one = KmerIndex(s, k)
        assert ix.n_valid == one.n_valid
        assert ix.n_kmers == one.n_kmers
        t_many = ix.tables(opt_flag=15)
        t_one = one.tables(opt_flag=15)
        assert t_many["kmer"] == t_one["kmer"]
        np.testing.assert_array_equal(t_many["pos"], t_one["pos"])
        np.testing.assert_array_equal(t_many["pair.pos"], t_one["pair.pos"])
        np.testing.assert_array_equal(t_many["count"], t_one["count"])
