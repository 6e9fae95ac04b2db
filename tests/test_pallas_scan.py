"""Pallas FSM kernel (Triton route) vs the lax.scan fast-mode FSM —
bit-identical (same f32 op order, same backend-evaluated ll terms).

The kernel runs in the Pallas interpreter here; ``test_kernel_on_gpu``
compiles it for the card and runs only where one is present."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kmer_hasher_tpu import counting
from kmer_hasher_tpu.io import pad_records
from kmer_hasher_tpu.ops import scan_iter as si
from kmer_hasher_tpu.ops.pallas_scan import BLOCK, ll_scan_pallas
from kmer_hasher_tpu.qll import Q_TO_LL


def compare(seq, qual, lengths, k, min_ll, return_flags=False,
            min_q_char=None, interpret=True):
    want = si.ll_scan(seq, qual, lengths, k, jnp.asarray(min_ll),
                      precision="fast", return_flags=return_flags,
                      min_q_char=min_q_char)
    got = ll_scan_pallas(seq, qual, lengths, k, min_ll,
                         return_flags=return_flags, min_q_char=min_q_char,
                         interpret=interpret)
    assert got[0].shape == (seq.shape[1], seq.shape[0])  # [L, B]
    for g, w in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(np.asarray(g).T, np.asarray(w))
    if return_flags:
        np.testing.assert_array_equal(np.asarray(got[5]),
                                      np.asarray(want[5]))
    return want


def padded(reads):
    pr = pad_records([("r%d" % i, s, q) for i, (s, q) in enumerate(reads)])
    return pr.seq, pr.qual, pr.lengths


def random_reads(n, lmin, lmax, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        L = int(rng.integers(lmin, lmax + 1))
        s = rng.choice(list(b"ACGTacgtN"), size=L).astype(np.uint8)
        q = (33 + rng.integers(0, 42, size=L)).astype(np.uint8)
        out.append((s.tobytes(), q.tobytes()))
    return out


@pytest.mark.parametrize("k,min_q", [(5, 20), (21, 20), (32, 0), (16, 10)])
def test_pallas_fsm_matches_scan_fast(k, min_q):
    seq, qual, lengths = padded(random_reads(24, max(2, k - 2), 70,
                                             seed=k + min_q))
    compare(seq, qual, lengths, k, float(Q_TO_LL[33 + min_q]))


def test_pallas_fsm_real_fastq(test_fastq_gz):
    seq, qual, lengths = padded([(s, q) for (_n, s, q)
                                 in test_fastq_gz[:48]])
    compare(seq, qual, lengths, 21, float(Q_TO_LL[33 + 20]))


@pytest.mark.parametrize("with_char", [False, True])
@pytest.mark.parametrize("k,min_q", [(21, 20), (13, 30)])
def test_pallas_fsm_borderline_flags(k, min_q, with_char):
    """In-kernel borderline flag == ll_scan(return_flags=True)'s flag
    (same comparisons, same tracked f32 error-bound arithmetic), with and
    without the analytic min_q threshold."""
    seq, qual, lengths = padded(random_reads(24, max(2, k - 2), 70,
                                             seed=100 + k))
    compare(seq, qual, lengths, k, float(Q_TO_LL[33 + min_q]),
            return_flags=True, min_q_char=33 + min_q if with_char else None)


def test_pallas_flag_threshold_sweep_matches_ll_scan():
    """Sweep min_ll around an achievable window sum so the comparison
    lands inside the *tracked-error band*: low qualities make |ll| large,
    so the accumulated aerr/eerr bound is micro-scale and a 1e-6-step
    sweep reliably hits the region where the flag depends on the error
    state carried along the read in the kernel's registers."""
    k = 9
    rng = np.random.default_rng(1)
    B, L = 16, 40
    bases = np.frombuffer(b"ACGT", np.uint8)
    seq = bases[rng.integers(0, 4, size=(B, L))]
    qual = (33 + rng.integers(2, 11, size=(B, L))).astype(np.uint8)
    lengths = np.full(B, L, np.int32)
    # anchor on an actual f32 window sum (k+1 window = the FSM's first
    # completed-window comparison value)
    ll = np.asarray(si.analytic_ll_f32(jnp.asarray(qual))).astype(
        np.float64)
    sums = np.lib.stride_tricks.sliding_window_view(
        ll, k + 1, axis=1).sum(-1)
    anchor = np.sort(sums.ravel())[sums.size // 6]
    any_flag = False
    for off in (-3e-6, -2.5e-6, 0.0, 1.5e-6, 2e-6, 2.5e-6, 3e-6):
        want = compare(seq, qual, lengths, k, float(anchor + off),
                       return_flags=True)
        any_flag |= bool(np.asarray(want[5]).any())
    assert any_flag  # the sweep actually exercised borderline territory


@pytest.mark.parametrize("B", [1, BLOCK - 1, BLOCK + 3])
def test_pallas_fsm_pads_rows_to_block(B):
    """Batches that are not a multiple of the kernel's block pad with
    zero-length rows and slice back: shapes and values match ll_scan."""
    seq, qual, lengths = padded(random_reads(B, 10, 40, seed=B))
    compare(seq, qual, lengths, 7, float(Q_TO_LL[33 + 15]),
            return_flags=True, min_q_char=33 + 15)


def test_ll_table_is_the_backend_analytic_evaluation():
    """The kernel's term table holds exactly the backend's own
    analytic_ll_f32 values, the ones the hybrid bound was measured on."""
    tab = si.ll_table_f32()
    dev = np.asarray(si.analytic_ll_f32(jnp.arange(256, dtype=jnp.uint8)))
    assert tab.dtype == np.float32 and tab.shape == (256,)
    np.testing.assert_array_equal(tab, dev)
    assert si.fast_min_ll(53) == float(tab[53])


@pytest.mark.parametrize("fsm,ref_fsm", [("pallas", "fast"),
                                         ("pallas_hybrid", "hybrid")])
@pytest.mark.parametrize("with_noq", [False, True])
def test_fused_batch_kernel_matches_scan(fsm, ref_fsm, with_noq):
    """The fused batch program gives the same LSM run, observation count
    and hybrid flags with the kernel's [L, B] outputs as with the scan's
    [B, L] outputs."""
    k, min_q = 11, 20
    seq, qual, lengths = padded(random_reads(40, 8, 60, seed=5))
    has_qual = np.ones(seq.shape[0], bool)
    if with_noq:
        has_qual[::3] = False
    min_ll_f = float(Q_TO_LL[33 + min_q])
    args = (jnp.asarray(seq), jnp.asarray(qual), jnp.asarray(lengths),
            jnp.asarray(has_qual), k, 1, 0, min_ll_f)
    kw = dict(with_noq=with_noq, min_q_char=33 + min_q,
              n_win=counting.win_bucket(int(lengths.max()), k))
    got = counting._fused_rp_batch(*args, fsm, interpret=True, **kw)
    want = counting._fused_rp_batch(*args, ref_fsm, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_fsm_choice_follows_backend(monkeypatch):
    """The f32 paths take the kernel on a GPU and the scan elsewhere; the
    exact f64 path is always the scan. No option selects it."""
    for backend, want in (("gpu", ("exact", "pallas_hybrid", "pallas")),
                          ("cpu", ("exact", "hybrid", "fast"))):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        got = tuple(counting._pick_fsm(m) for m in (True, "hybrid", False))
        assert got == want


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip where none is present."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: the compiled kernel runs only on the card")


@pytest.mark.gpu
def test_kernel_on_gpu(gpu_device):
    """The kernel compiled for the card (no interpreter) equals ll_scan
    fast, with flags, on that card."""
    seq, qual, lengths = padded(random_reads(300, 20, 151, seed=9))
    with jax.default_device(gpu_device):
        compare(seq, qual, lengths, 21, float(Q_TO_LL[53]),
                return_flags=True, min_q_char=53, interpret=False)
