"""Hybrid-precision likelihood filtering (ROADMAP §2b): the f32 scan with
borderline flags + f64 re-run of flagged reads must equal the exact f64
scan bit-for-bit, and every fast-vs-exact decision flip must occur on a
flagged read (bound soundness)."""
import numpy as np
import pytest

import jax.numpy as jnp

from kmer_hasher_tpu import counting
from kmer_hasher_tpu.ops import scan_iter as si
from kmer_hasher_tpu.qll import Q_TO_LL


def test_delta_max_is_tiny():
    # analytic f32 vs embedded table: per-term delta must be ~ulps-ish
    assert 0 < si._delta_max() < 1e-6


def test_delta_max_covers_true_f32_evaluation():
    """Regression: the bound must cover the delta of a genuine end-to-end
    f32 evaluation (f32 exp/log1p), which is ~3.6x larger than the
    f64-evaluated-then-cast proxy an earlier version measured, AND the
    actual backend evaluation the fast paths execute."""
    qf = np.arange(34, 256, dtype=np.float32) - np.float32(33.0)
    host = np.log1p(-np.exp(qf * np.float32(-si._LN10_OVER_10)))
    host_delta = np.max(np.abs(
        np.asarray(Q_TO_LL)[34:] - host.astype(np.float64)))
    dev = np.asarray(
        si.analytic_ll_f32(jnp.arange(34, 256, dtype=jnp.uint8))
    ).astype(np.float64)
    dev_delta = np.max(np.abs(np.asarray(Q_TO_LL)[34:] - dev))
    # strict margin: the bound is 2x the worst measured + 2^-22
    assert si._delta_max() >= 2.0 * max(host_delta, dev_delta)


def _random_batch(rng, B=64, L=128, lowq_frac=0.1):
    bases = np.frombuffer(b"ACGT", np.uint8)
    seq = bases[rng.integers(0, 4, size=(B, L))]
    qual = rng.integers(35, 74, size=(B, L)).astype(np.uint8)
    low = rng.random((B, L)) < lowq_frac
    qual[low] = rng.integers(33, 40, size=int(low.sum())).astype(np.uint8)
    lengths = rng.integers(40, L + 1, size=B).astype(np.int32)
    return seq, qual, lengths


@pytest.mark.parametrize("with_char", [False, True])
@pytest.mark.parametrize("min_q", [0, 2, 20])
def test_fuzz_unflagged_reads_match_exact(min_q, with_char):
    k = 21
    rng = np.random.default_rng(min_q)
    min_ll = jnp.asarray(float(Q_TO_LL[33 + min_q]))
    mc = 33 + min_q if with_char else None
    for _ in range(3):
        seq, qual, lengths = _random_batch(rng)
        fast = si.ll_scan(seq, qual, lengths, k, min_ll, precision="fast",
                          return_flags=True, min_q_char=mc)
        exact = si.ll_scan(seq, qual, lengths, k, min_ll, precision="exact")
        flags = np.asarray(fast[5])
        mism = np.asarray(fast[0]) != np.asarray(exact[0])
        bad = mism.any(axis=1) & ~flags
        assert not bad.any(), "unflagged read diverged from exact"


def test_flag_rate_low_on_binned_and_uniform_qualities():
    """The tracked error-bound + analytic-threshold flag machinery must
    not over-flag realistic data (the static bound flagged 92-100% of
    NovaSeq-binned/uniform reads at min_q=20: 2*ll(q23) sits 1.1e-6 from
    ll(q20), and every q == min_q base was undecidable against the cast
    threshold), while staying sound."""
    k = 21
    rng = np.random.default_rng(0)
    B, L = 512, 151
    bases = np.frombuffer(b"ACGT", np.uint8)
    min_q = 20
    min_ll = jnp.asarray(float(Q_TO_LL[33 + min_q]))
    for qs, p in ([2, 12, 23, 37], [0.01, 0.03, 0.16, 0.8]), \
                 (list(range(2, 41)), None), ([20, 37], [0.25, 0.75]):
        seq = bases[rng.integers(0, 4, size=(B, L))]
        q = rng.choice(np.array(qs), p=p, size=(B, L))
        qual = (q + 33).astype(np.uint8)
        lengths = np.full(B, L, np.int32)
        fast = si.ll_scan(seq, qual, lengths, k, min_ll, precision="fast",
                          return_flags=True, min_q_char=33 + min_q)
        exact = si.ll_scan(seq, qual, lengths, k, min_ll, precision="exact")
        flags = np.asarray(fast[5])
        mism = (np.asarray(fast[0]) != np.asarray(exact[0])).any(axis=1)
        assert not (mism & ~flags).any()
        assert flags.mean() < 0.02, f"over-flagging: {flags.mean():.3f}"


def test_min_q_exemption_is_sound():
    """Reads saturated with bases at exactly min_q: the analytic threshold
    makes those comparisons bitwise-equal (not flagged), and decisions
    must still match exact everywhere."""
    k = 9
    rng = np.random.default_rng(11)
    B, L = 256, 80
    bases = np.frombuffer(b"ACGT", np.uint8)
    for min_q in (2, 20, 40):
        seq = bases[rng.integers(0, 4, size=(B, L))]
        # half the bases sit exactly at min_q, the rest just above/below
        q = rng.choice(np.array([min_q, min_q - 1, min_q + 1, 37]),
                       p=[0.5, 0.1, 0.2, 0.2], size=(B, L))
        qual = (q + 33).astype(np.uint8)
        lengths = np.full(B, L, np.int32)
        min_ll = jnp.asarray(float(Q_TO_LL[33 + min_q]))
        fast = si.ll_scan(seq, qual, lengths, k, min_ll, precision="fast",
                          return_flags=True, min_q_char=33 + min_q)
        exact = si.ll_scan(seq, qual, lengths, k, min_ll, precision="exact")
        flags = np.asarray(fast[5])
        mism = (np.asarray(fast[0]) != np.asarray(exact[0])).any(axis=1)
        assert not (mism & ~flags).any()
        # the exemption must actually bite: min_q-heavy reads unflagged
        assert flags.mean() < 0.05, f"q==min_q still flagging: {flags.mean()}"


def test_threshold_sweep_flags_cover_all_flips():
    """Scan thresholds densely around an achievable window sum so f32/f64
    decisions genuinely flip; every flip must be flagged, and at least one
    borderline case must be flagged across the sweep."""
    k = 9
    rng = np.random.default_rng(7)
    B, L = 32, 64
    bases = np.frombuffer(b"ACGT", np.uint8)
    seq = bases[rng.integers(0, 4, size=(B, L))]
    Q = 40  # constant quality -> window sums cluster tightly
    qual = np.full((B, L), 33 + Q, np.uint8)
    lengths = np.full(B, L, np.int32)
    base = (k + 1) * float(Q_TO_LL[33 + Q])
    any_flag = False
    any_flip = False
    for off in np.linspace(-2e-6, 2e-6, 41):
        min_ll = jnp.asarray(base + float(off))
        fast = si.ll_scan(seq, qual, lengths, k, min_ll, precision="fast",
                          return_flags=True)
        exact = si.ll_scan(seq, qual, lengths, k, min_ll,
                           precision="exact")
        flags = np.asarray(fast[5])
        mism = (np.asarray(fast[0]) != np.asarray(exact[0])).any(axis=1)
        any_flag |= bool(flags.any())
        any_flip |= bool(mism.any())
        assert not (mism & ~flags).any()
    assert any_flag  # the sweep actually exercised borderline territory


@pytest.mark.parametrize("min_q", [0, 20])
def test_hybrid_counting_bitwise_equals_exact(ref, min_q):
    k = 15
    path = f"{ref}/test.fastq.gz"
    exact = counting.count_kmers_fq_sh_rp(path, k=k, min_q=min_q,
                                          max_reads=150, exact_ll=True)
    hybrid = counting.count_kmers_fq_sh_rp(path, k=k, min_q=min_q,
                                           max_reads=150, exact_ll="hybrid")
    assert hybrid.counts_dict() == exact.counts_dict()
    np.testing.assert_array_equal(hybrid.spectrum(60), exact.spectrum(60))


def test_hybrid_counting_on_borderline_rich_reads(tmp_path):
    """Constant-quality reads with the threshold sitting on the cluster of
    window sums — the adversarial case for f32."""
    k = 9
    rng = np.random.default_rng(3)
    bases = "ACGT"
    n = 200
    Q = 40
    fq = tmp_path / "border.fq"
    with open(fq, "w") as f:
        for i in range(n):
            s = "".join(bases[b] for b in rng.integers(0, 4, 60))
            f.write(f"@r{i}\n{s}\n+\n{chr(33 + Q) * 60}\n")
    # min_q chosen so min_ll is near (k+1)*ll(Q): find the closest q
    target = (k + 1) * float(Q_TO_LL[33 + Q])
    qs = np.asarray(Q_TO_LL)
    min_q = int(np.argmin(np.abs(qs - target))) - 33
    exact = counting.count_kmers_fq_sh_rp(str(fq), k=k, min_q=min_q,
                                          exact_ll=True)
    hybrid = counting.count_kmers_fq_sh_rp(str(fq), k=k, min_q=min_q,
                                           exact_ll="hybrid")
    assert hybrid.counts_dict() == exact.counts_dict()
    # the sharded twin on the same adversarial reads: per-shard lax.cond
    # f64 re-scan must reproduce the exact store bitwise
    from kmer_hasher_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(4)
    sh_ex = counting.count_kmers_fq_sh_rp(str(fq), k=k, min_q=min_q,
                                          exact_ll=True, mesh=mesh)
    # simulate a fresh process: the first _delta_max call then happens
    # inside the shard_map trace (regression for the mid-trace eval)
    si._DELTA_MAX = None
    sh_hy = counting.count_kmers_fq_sh_rp(str(fq), k=k, min_q=min_q,
                                          exact_ll="hybrid", mesh=mesh)
    np.testing.assert_array_equal(sh_hy.n_unique, sh_ex.n_unique)
    np.testing.assert_array_equal(sh_hy.spectrum(600), sh_ex.spectrum(600))
    np.testing.assert_array_equal(np.asarray(exact.spectrum(600)),
                                  np.asarray(sh_hy.spectrum(600)))


def test_compacted_sweep_few_flags_and_fallback(monkeypatch):
    """The round-3 compacted exact sweep: a big batch with a FEW flagged
    reads re-scans only a small gathered [C, L] batch (C < B), and a
    batch with more flags than _SWEEP_ROWS falls back to the full-batch
    exact program — both must add exactly the flagged reads' exact-mode
    kmers. Flags are injected directly (FSM flag generation is
    backend-sensitive; the chip e2e bench exercises the organic path)."""
    from kmer_hasher_tpu.index.count_store import CountStore

    k = 11
    min_q = 20
    min_ll_f = float(Q_TO_LL[33 + min_q])
    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", np.uint8)
    B, L = 512, 64
    seq = bases[rng.integers(0, 4, size=(B, L))]
    qual = rng.integers(63, 74, size=(B, L)).astype(np.uint8)
    lengths = np.full(B, L, np.int32)

    def expected_store(flag_rows):
        st = CountStore(k, counts_n=1, mode="sh")
        lens = np.zeros(B, np.int32)
        lens[flag_rows] = L
        r = counting._fused_rp_batch(
            jnp.asarray(seq), jnp.asarray(qual), jnp.asarray(lens),
            jnp.asarray(lens > 0), k, 1, 0, min_ll_f, "exact", False,
            keyonly=st.keyonly_runs)
        st.add_run(r[0], r[1], r[2], r[3], source=0)
        return st

    compacts = []
    real_compact = counting._compact_flagged

    def spy(seq, qual, lengths, flags, rows):
        compacts.append(rows)
        return real_compact(seq, qual, lengths, flags, rows)

    monkeypatch.setattr(counting, "_compact_flagged", spy)
    monkeypatch.setattr(counting, "_SWEEP_ROWS", 16)
    for flag_rows, expect_compact in (([3, 100, 501], True),
                                      (list(range(0, 340, 20)), False)):
        flags = np.zeros(B, bool)
        flags[flag_rows] = True
        st = CountStore(k, counts_n=1, mode="sh")
        backlog = [(jnp.asarray(seq), jnp.asarray(qual),
                    jnp.asarray(lengths), jnp.asarray(flags))]
        compacts.clear()
        counting._sweep_backlog(st, backlog, k, 0, min_ll_f)
        assert backlog == []
        assert compacts == ([16] if expect_compact else [])
        want = expected_store(flag_rows)
        assert st.counts_dict() == want.counts_dict()
