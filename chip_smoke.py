"""On-card smoke run of the index and counting paths, at sizes users run.

Runs on one GPU, in one process, through the public API and the CLI:

* index: a seeded 2^25-base sequence at k=32 — ``make_kmer_hash`` and
  ``kmer_pos(opt_flag=15)``, checked bitwise against a host NumPy stable
  argsort; ``seq_kmer_pos`` of a 1 Mbp slice (on a k=31 index: the
  reference refuses queries at k=32); refsem parity on a 20 kb slice,
  through the API and the CLI (``index``, ``tables``); the first chunks
  of ``iter_pair_chunks`` on a repeat-rich variant;
* counting served from a file: 2,000,000 reads of 151 bp from a seeded
  5 Mbp genome (1% substitutions, binned qualities with ~4% of bases below
  phred 20, some N-led reads), ``count_kmers_fq_sh_rp(k=21, min_q=20)`` exact and
  hybrid (bitwise equal), both against refsem on the first 3,000 reads,
  then ``kmer_spectrum`` and ``seq_kmer_depth`` over the genome; a second
  file where every window passes, counted through the CLI and checked
  against a host ``np.unique`` over canonical k-mers at full size;
* the likelihood FSM kernel against the ``lax.scan`` FSM inside the fused
  batch program at 16384 x 151 bp, bitwise, with both times.

``--four`` runs only the sharded paths on four cards: the sharded count
of the same FASTQ and ``ShardedKmerIndex.lookup_counts``, each against the
single-card result.

Usage: ``python chip_smoke.py [--four]``. Exits non-zero, printing no
result line, when JAX finds no GPU or any phase fails. The last line of a
passing run is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

SEED = 0
INDEX_LOG_L = 25
QUERY_LEN = 1 << 20
PARITY_SLICE = 20_000
N_PAIR_CHUNKS = 3
GENOME_LEN = 5_000_000
N_READS = 2_000_000
READ_LEN = 151
K_COUNT = 21
MIN_Q = 20
REFSEM_READS = 3_000
FSM_ROWS = 16384
TIMED_REPS = 10


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    """The card's name and power limit, read by a child that stays off
    JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else (
        "nvidia-smi failed: " + r.stderr.strip())


def timed(fn, *args, **kw):
    """(result, seconds) with the result ready on the device."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kw))
    return out, time.perf_counter() - t0


def peak_bytes() -> int:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


class Phases:
    """Runs each phase, records its verdicts, and keeps going after a
    failure so one run reports every fault."""

    def __init__(self):
        self.failed = []

    def run(self, name, fn, *args):
        log(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:  # a failed phase fails the run, after the rest
            traceback.print_exc()
            self.failed.append(name)
            log(f"phase {name}: FAILED after "
                f"{time.perf_counter() - t0:.1f} s")
            return None
        log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s, "
            f"peak_bytes_in_use {peak_bytes()}")
        return out


def check(name: str, ok: bool) -> None:
    log(f"parity {name}: {'equal' if ok else 'DIFFERENT'}")
    if not ok:
        raise AssertionError(f"parity check failed: {name}")


# -- host references --------------------------------------------------------

def host_keys(seq: np.ndarray, k: int) -> np.ndarray:
    """Forward packed keys (uint64) of every window of an N-free sequence,
    2 bits per base (A0 C1 T2 G3), first base in the high bits."""
    codes = ((seq >> 1) & 3).astype(np.uint64)
    n = seq.shape[-1] - k + 1
    key = np.zeros(seq.shape[:-1] + (n,), np.uint64)
    for j in range(k):
        key = (key << np.uint64(2)) | codes[..., j:j + n]
    return key


def host_canonical(seq: np.ndarray, k: int) -> np.ndarray:
    """min(fwd, revcomp) packed keys of every window, rows independent."""
    codes = ((seq >> 1) & 3).astype(np.uint64)
    n = seq.shape[-1] - k + 1
    fwd = np.zeros(seq.shape[:-1] + (n,), np.uint64)
    rc = np.zeros_like(fwd)
    for j in range(k):
        fwd = (fwd << np.uint64(2)) | codes[..., j:j + n]
        rc |= (codes[..., j:j + n] ^ np.uint64(2)) << np.uint64(2 * j)
    return np.minimum(fwd, rc)


def u64(hi, lo) -> np.ndarray:
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        lo).astype(np.uint64)


def store_table(store):
    """Sorted (keys u64, counts [n, counts_n]) of a single-card store or a
    sharded store, on the host."""
    from kmer_hasher_tpu.index.count_store import CountStore

    if isinstance(store, CountStore):
        store.flush()
        n = int(store.n_unique)
        return (u64(np.asarray(store.u_hi)[:n], np.asarray(store.u_lo)[:n]),
                np.asarray(store.cnt)[:n])
    from kmer_hasher_tpu.parallel.sharded import _host_read

    store._fold()
    uh, ul, cn = (_host_read(store.u_hi), _host_read(store.u_lo),
                  _host_read(store.cnt))
    nd = np.asarray(store.n_unique)
    keys = np.concatenate([u64(uh[d, :nd[d]], ul[d, :nd[d]])
                           for d in range(uh.shape[0])])
    cnt = np.concatenate([cn[d, :nd[d]] for d in range(uh.shape[0])])
    order = np.argsort(keys, kind="stable")
    return keys[order], cnt[order]


# -- data ---------------------------------------------------------------------

def make_data(workdir: str, full: bool = True):
    """The seeded inputs: the index sequence and the FASTQ file, plus (if
    ``full``) the repeat-rich sequence and the every-window-passes file."""
    from kmer_hasher_tpu import synth

    rng = np.random.default_rng(SEED)
    d = {"workdir": workdir}
    d["index_seq"] = synth.random_genome(1 << INDEX_LOG_L, rng)
    d["genome"] = synth.random_genome(GENOME_LEN, rng)
    t0 = time.perf_counter()
    seq, qual = synth.simulate_reads(d["genome"], N_READS, READ_LEN, rng)
    d["fq"] = os.path.join(workdir, "reads.fq")
    synth.write_fastq(d["fq"], seq, qual)
    d["first_reads"] = [(seq[i].tobytes(), qual[i].tobytes())
                        for i in range(REFSEM_READS)]
    if not full:
        log(f"data: {N_READS} reads x {READ_LEN} bp written in "
            f"{time.perf_counter() - t0:.1f} s")
        return d
    d["repeat_seq"] = synth.repeat_rich_genome(1 << INDEX_LOG_L, rng)
    seq2, qual2 = synth.simulate_reads(
        d["genome"], N_READS, READ_LEN, rng, n_lead_frac=0.0,
        quals=np.frombuffer(b"F", np.uint8), qual_probs=(1.0,))
    d["fq_pass"] = os.path.join(workdir, "reads_pass.fq")
    synth.write_fastq(d["fq_pass"], seq2, qual2)
    d["reads_pass"] = seq2
    d["genome_fa"] = os.path.join(workdir, "genome.fa")
    with open(d["genome_fa"], "wb") as f:
        f.write(b">contig_1\n" + d["genome"].tobytes() + b"\n")
    log(f"data: {N_READS} reads x {READ_LEN} bp twice, written in "
        f"{time.perf_counter() - t0:.1f} s")
    return d


# -- phases ---------------------------------------------------------------------

def phase_index(d):
    import jax.numpy as jnp

    from kmer_hasher_tpu import api, refsem
    from kmer_hasher_tpu.__main__ import main as cli
    from kmer_hasher_tpu.index.position_index import build_index_arrays
    from kmer_hasher_tpu.ops.encode import encode_stream

    k = 32
    seq = d["index_seq"]
    L = seq.shape[0]
    idx, cold = timed(api.make_kmer_hash, seq, k)
    idx, warm = timed(api.make_kmer_hash, seq, k)
    log(f"index build k={k} L=2^{INDEX_LOG_L}: first call {cold:.2f} s "
        f"(compile {cold - warm:.2f} s), warm {warm:.3f} s through the "
        f"API = {L / warm:.4g} k-mers/s")
    dev = jnp.asarray(seq)
    times = []
    for _ in range(TIMED_REPS):
        _, t = timed(build_index_arrays, dev, k, L)
        times.append(t)
    med = float(np.median(times))
    log(f"index device step (encode+sort+group, build_index_arrays): "
        f"median {med * 1e3:.2f} ms = {L / med:.4g} k-mers/s "
        f"(min {min(times) * 1e3:.2f} ms, {TIMED_REPS} runs)")
    enc_t = [timed(encode_stream, dev, k, L,
                   drop_trailing_exact_k=True)[1]
             for _ in range(TIMED_REPS + 1)][1:]
    log(f"encode alone (encode_stream, own program): median "
        f"{np.median(enc_t) * 1e3:.3f} ms of the {med * 1e3:.2f} ms step")
    log("index build trace: " + json.dumps(trace_breakdown(
        d["workdir"], build_index_arrays, dev, k, L)))

    tabs, t_tab = timed(api.kmer_pos, idx, 15)
    log(f"kmer_pos(opt_flag=15): {t_tab:.2f} s, {len(tabs['kmer'])} "
        f"k-mers, {tabs['pos'].shape[0]} positions, "
        f"{tabs['pair.pos'].shape[0]} pairs")
    keys = host_keys(seq, k)
    order = np.argsort(keys, kind="stable")
    s_keys = keys[order]
    starts = np.ones(s_keys.shape[0], bool)
    starts[1:] = s_keys[1:] != s_keys[:-1]
    u_keys = s_keys[starts]
    u_hi, u_lo, n_u = idx.unique_keys()
    check("index sorted keys vs host stable argsort",
          n_u == u_keys.shape[0]
          and np.array_equal(u64(np.asarray(u_hi)[:n_u],
                                 np.asarray(u_lo)[:n_u]), u_keys))
    check("index positions vs host stable argsort",
          np.array_equal(tabs["pos"][:, 1], order + 1)
          and np.array_equal(tabs["pos"][:, 0], np.cumsum(starts)))
    check("index per-k-mer counts vs host",
          np.array_equal(tabs["count"],
                         np.diff(np.append(np.flatnonzero(starts),
                                           s_keys.shape[0]))))
    nuc = np.frombuffer(b"ACTG", np.uint8)
    sample = np.r_[0:1000, n_u - 1000:n_u]
    want = [bytes(nuc[(u_keys[i] >> np.uint64(2 * (k - 1 - np.arange(k))))
                      & np.uint64(3)]).decode() for i in sample]
    check("index k-mer strings (first and last 1000)",
          [tabs["kmer"][i] for i in sample] == want)

    sl = seq[:PARITY_SLICE].tobytes().decode()
    small = api.make_kmer_hash(sl, k)
    st = small.tables(15)
    rt = refsem.kmer_positions(refsem.make_kmer_hash(sl, k), 15)
    check(f"kmer_pos(15) vs refsem on {PARITY_SLICE} bp",
          st["kmer"] == rt["kmer"]
          and all(np.array_equal(np.asarray(st[n]), np.asarray(rt[n]))
                  for n in ("pos", "count", "pair.pos")))

    fa = os.path.join(d["workdir"], "slice.fa")
    with open(fa, "w") as f:
        f.write(">slice\n" + sl + "\n")
    out = os.path.join(d["workdir"], "slice_idx.npz")
    prefix = os.path.join(d["workdir"], "slice")
    cli(["index", fa, "-k", str(k), "-o", out])
    cli(["tables", out, "--opt-flag", "15", "-o", prefix])
    with open(prefix + ".kmer.txt") as f:
        kmers = f.read().split()
    check(f"CLI index + tables vs refsem on {PARITY_SLICE} bp",
          kmers == rt["kmer"]
          and all(np.array_equal(np.load(f"{prefix}.{n}.npy"),
                                 np.asarray(rt[m]))
                  for n, m in (("pos", "pos"), ("count", "count"),
                               ("pair_pos", "pair.pos"))))

    kq = 31
    idx31, t31 = timed(api.make_kmer_hash, seq, kq)
    q = seq[L // 3:L // 3 + QUERY_LEN]
    hits, tq = timed(api.seq_kmer_pos, idx31, q, kq)
    hits, tq_warm = timed(api.seq_kmer_pos, idx31, q, kq)
    log(f"seq_kmer_pos k={kq}: {QUERY_LEN} bp query, {hits.shape[0]} "
        f"hits, first call {tq:.2f} s, warm {tq_warm:.3f} s "
        f"(index build {t31:.2f} s)")
    k31 = host_keys(seq, kq)
    o31 = np.argsort(k31, kind="stable")
    s31 = k31[o31]
    qk = host_keys(q, kq)
    lb = np.searchsorted(s31, qk, "left")
    ub = np.searchsorted(s31, qk, "right")
    rows_i = np.repeat(np.arange(kq, QUERY_LEN + 1, dtype=np.int64), ub - lb)
    rows_j = o31[np.concatenate([np.arange(a, b) for a, b in zip(lb, ub)])
                 ] + 1
    check("seq_kmer_pos 1 Mbp vs host searchsorted",
          hits.shape[0] == rows_i.shape[0]
          and np.array_equal(hits[:, 0], rows_i)
          and np.array_equal(hits[:, 1], rows_j))
    qs = sl[PARITY_SLICE // 4:PARITY_SLICE // 2]
    check(f"seq_kmer_pos vs refsem on {PARITY_SLICE} bp",
          np.array_equal(
              api.seq_kmer_pos(api.make_kmer_hash(sl, kq), qs, kq),
              refsem.seq_kmer_positions(refsem.make_kmer_hash(sl, kq), qs,
                                        kq)))

    rep = d["repeat_seq"]
    ridx, tr = timed(api.make_kmer_hash, rep, k)
    t0 = time.perf_counter()
    chunks = []
    for c in ridx.iter_pair_chunks():
        chunks.append(c)
        if len(chunks) == N_PAIR_CHUNKS:
            break
    tp = time.perf_counter() - t0
    got = np.concatenate(chunks)
    log(f"repeat-rich index: {ridx.total_pairs} pairs in all; first "
        f"{len(chunks)} chunks ({got.shape[0]} rows) in {tp:.2f} s "
        f"(build {tr:.2f} s)")
    check("pair chunks vs host", np.array_equal(
        got, host_first_pairs(rep, k, got.shape[0])))


def host_first_pairs(seq, k, n_rows):
    """The first ``n_rows`` rows of the (i, x, y) pair table: segments in
    key order, and within a segment x ascending, y ascending after x."""
    keys = host_keys(seq, k)
    order = np.argsort(keys, kind="stable")
    s_keys = keys[order]
    starts = np.flatnonzero(np.r_[True, s_keys[1:] != s_keys[:-1]])
    counts = np.diff(np.append(starts, s_keys.shape[0]))
    out, have = [], 0
    for seg in np.flatnonzero(counts >= 2):
        pos = order[starts[seg]:starts[seg] + counts[seg]] + 1
        for j in range(pos.shape[0] - 1):
            ys = pos[j + 1:]
            out.append(np.stack([np.full(ys.shape, seg + 1), np.full(
                ys.shape, pos[j]), ys], axis=1))
            have += ys.shape[0]
            if have >= n_rows:
                return np.concatenate(out)[:n_rows].astype(np.int32)
    return np.concatenate(out)[:n_rows].astype(np.int32)


def phase_count(d, workdir):
    from kmer_hasher_tpu import api, counting, refsem
    from kmer_hasher_tpu.__main__ import main as cli
    from kmer_hasher_tpu.io import native
    from kmer_hasher_tpu.utils import checkpoint as ckpt

    log(f"FASTQ IO path: {'native' if native.available() else 'Python'}")
    stores = {}
    for mode in (True, "hybrid"):
        name = "exact" if mode is True else "hybrid"
        log(f"{name}: FSM {counting._pick_fsm(mode)}")
        _, cold = timed(api.count_kmers_fq_sh_rp, d["fq"], K_COUNT,
                        min_q=MIN_Q, exact_ll=mode)
        st, warm = timed(api.count_kmers_fq_sh_rp, d["fq"], K_COUNT,
                         min_q=MIN_Q, exact_ll=mode)
        log(f"count {name} from file: first call {cold:.2f} s (compile "
            f"{cold - warm:.2f} s), warm {warm:.2f} s = "
            f"{N_READS / warm:.4g} reads/s; {st.n_unique} distinct")
        stores[name] = st
    ex, hy = stores["exact"], stores["hybrid"]
    tex, thy = store_table(ex), store_table(hy)
    check("hybrid vs exact n_unique", ex.n_unique == hy.n_unique)
    check("hybrid vs exact spectrum",
          np.array_equal(api.kmer_spectrum(ex, 10000),
                         api.kmer_spectrum(hy, 10000)))
    check("hybrid vs exact key/count table",
          np.array_equal(tex[0], thy[0]) and np.array_equal(tex[1], thy[1]))

    t0 = time.perf_counter()
    want = refsem.count_kmers_reads_ll(d["first_reads"], K_COUNT, MIN_Q)
    log(f"refsem on {REFSEM_READS} reads: {time.perf_counter() - t0:.1f} s")
    for mode in (True, "hybrid"):
        st = api.count_kmers_fq_sh_rp(d["fq"], K_COUNT, min_q=MIN_Q,
                                      exact_ll=mode, max_reads=REFSEM_READS)
        keys, cnt = store_table(st)
        rk = np.array(sorted(want.counts), np.uint64)
        rc = np.array([want.counts[int(x)] for x in rk],
                      np.uint32).reshape(rk.shape[0], -1)
        check(f"{'exact' if mode is True else 'hybrid'} vs refsem on "
              f"{REFSEM_READS} reads",
              np.array_equal(keys, rk) and np.array_equal(cnt, rc))

    spec, ts = timed(api.kmer_spectrum, ex, 10000)
    log(f"kmer_spectrum: {ts:.3f} s; spectrum[1..5] {spec[1:6].tolist()}")
    depth, td = timed(api.seq_kmer_depth, ex, d["genome"], K_COUNT)
    tk = host_canonical(d["genome"], K_COUNT)
    idx = np.searchsorted(tex[0], tk)
    idx_c = np.minimum(idx, tex[0].shape[0] - 1)
    want_d = np.where(tex[0][idx_c] == tk, tex[1][idx_c, 0].astype(np.int64),
                      0)
    nw = tk.shape[0]
    check("seq_kmer_depth over the genome vs host lookup",
          depth.shape == (1, GENOME_LEN)
          and np.array_equal(depth[0, :nw], want_d)
          and (depth[0, nw:] == -(2 ** 31)).all())
    log(f"seq_kmer_depth over {GENOME_LEN} bp: {td:.2f} s")

    out = os.path.join(workdir, "pass_store.npz")
    t0 = time.perf_counter()
    cli(["count", d["fq_pass"], "-k", str(K_COUNT), "--min-q", str(MIN_Q),
         "-o", out])
    log(f"CLI count (every window passes): "
        f"{time.perf_counter() - t0:.2f} s")
    st = ckpt.load_count_store(out)
    keys, cnt = store_table(st)
    t0 = time.perf_counter()
    hk, hc = np.unique(host_canonical(d["reads_pass"], K_COUNT).ravel(),
                       return_counts=True)
    log(f"host canonical k-mers + np.unique over {hc.sum()} k-mers: "
        f"{time.perf_counter() - t0:.1f} s, {hk.shape[0]} distinct")
    check("every-window-passes store vs host np.unique",
          np.array_equal(keys, hk) and np.array_equal(cnt[:, 0], hc))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli(["spectrum", out, "--max-count", "10000"])
    want_s = np.bincount(np.minimum(hc, 10000), minlength=10001)
    got_s = np.zeros(10001, np.int64)
    for line in buf.getvalue().splitlines():
        c, n = line.split()
        got_s[int(c)] = int(n)
    check("CLI spectrum vs host", np.array_equal(got_s, want_s))
    dep = os.path.join(workdir, "depth.npy")
    cli(["depth", out, d["genome_fa"], "-k", str(K_COUNT), "-o", dep])
    cd = np.load(dep)
    idx = np.minimum(np.searchsorted(hk, tk), hk.shape[0] - 1)
    check("CLI depth vs host lookup",
          np.array_equal(cd[0, :nw], np.where(hk[idx] == tk, hc[idx], 0)))


def phase_fsm(d):
    """The FSM kernel against the lax.scan FSM in the fused batch program
    (16384 x 151 bp, k=21), and the kernel alone against ll_scan."""
    import jax.numpy as jnp

    from kmer_hasher_tpu import counting, synth
    from kmer_hasher_tpu.io.fastx import col_bucket
    from kmer_hasher_tpu.ops import scan_iter as si
    from kmer_hasher_tpu.ops.pallas_scan import ll_scan_pallas
    from kmer_hasher_tpu.qll import Q_TO_LL

    rng = np.random.default_rng(SEED + 1)
    seq, qual = synth.simulate_reads(d["genome"], FSM_ROWS, READ_LEN, rng)
    Lp = col_bucket(READ_LEN)
    s = np.full((FSM_ROWS, Lp), ord("N"), np.uint8)
    q = np.zeros((FSM_ROWS, Lp), np.uint8)
    s[:, :READ_LEN], q[:, :READ_LEN] = seq, qual
    lens = jnp.full(FSM_ROWS, READ_LEN, jnp.int32)
    s, q = jnp.asarray(s), jnp.asarray(q)
    mc = 33 + MIN_Q
    min_ll = float(Q_TO_LL[mc])
    want = si.ll_scan(s, q, lens, K_COUNT, jnp.asarray(min_ll),
                      precision="fast", return_flags=True, min_q_char=mc)
    got = ll_scan_pallas(s, q, lens, K_COUNT, min_ll, return_flags=True,
                         min_q_char=mc)
    check(f"FSM kernel vs ll_scan fast+flags at {FSM_ROWS} x {READ_LEN}",
          all(np.array_equal(np.asarray(g).T, np.asarray(w))
              for g, w in zip(got[:5], want[:5]))
          and np.array_equal(np.asarray(got[5]), np.asarray(want[5])))
    log(f"hybrid flag rate: {float(np.asarray(want[5]).mean()):.4g}")

    hq = jnp.ones(FSM_ROWS, bool)
    nwin = counting.win_bucket(READ_LEN, K_COUNT)
    res = {}
    for fsm in ("exact", "fast", "pallas", "hybrid", "pallas_hybrid"):
        def run(fsm=fsm):
            return counting._fused_rp_batch(
                s, q, lens, hq, K_COUNT, 1, 0, min_ll, fsm,
                min_q_char=mc, n_win=nwin)
        out, cold = timed(run)
        times = [timed(run)[1] for _ in range(TIMED_REPS)]
        res[fsm] = out
        log(f"fused batch {fsm:>13}: median {np.median(times) * 1e3:.3f} "
            f"ms (min {min(times) * 1e3:.3f}, first call {cold:.2f} s)")
    for a, b in (("pallas", "fast"), ("pallas_hybrid", "hybrid")):
        check(f"fused batch {a} vs {b}", all(
            np.array_equal(np.asarray(x), np.asarray(y))
            for x, y in zip(res[a], res[b])))


def trace_breakdown(workdir, fn, *args):
    """Device time over one warm call of the jitted ``fn``, from a
    profiler trace: kernels on the device's stream lines, each assigned to
    encode / sort / other through the op_name metadata of its HLO op in
    the compiled module. Returns ms per category and the largest kernels.
    """
    import re
    import tempfile

    import jax

    hlo = fn.lower(*args).compile().as_text()
    op_name = dict(re.findall(
        r'%?([\w.\-]+) = [^\n]*?op_name="([^"]*)"', hlo))

    def category(hlo_op: str) -> str:
        op = op_name.get(hlo_op, "")
        if "encode" in op or "window_valid" in op:
            return "encode"
        if "sort" in op or "sort" in hlo_op:
            return "sort"
        return "other"

    tdir = tempfile.mkdtemp(prefix="trace_", dir=workdir)
    try:
        with jax.profiler.trace(tdir):
            jax.block_until_ready(fn(*args))
        pb = [os.path.join(r, f) for r, _, fs in os.walk(tdir) for f in fs
              if f.endswith(".xplane.pb")]
        pd = jax.profiler.ProfileData.from_file(pb[0])
        by_cat, by_op = {}, {}
        for plane in pd.planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                if not line.name.startswith("Stream"):
                    continue
                for ev in line.events:
                    st = dict(ev.stats)
                    h = str(st.get("hlo_op", ""))
                    c = category(h) if h else "copy/other"
                    by_cat[c] = by_cat.get(c, 0.0) + ev.duration_ns / 1e6
                    key = f"{h or ev.name} [{c}]"
                    by_op[key] = by_op.get(key, 0.0) + ev.duration_ns / 1e6
        total = sum(by_cat.values()) or 1e-9
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ms": round(total, 4),
                "share": {c: round(v / total, 4) for c, v in by_cat.items()},
                "ms": {c: round(v, 4) for c, v in by_cat.items()},
                "top_ms": {n: round(v, 4) for n, v in top}}
    finally:
        shutil.rmtree(tdir, ignore_errors=True)


def phase_four(d):
    """Sharded count and sharded index lookups on four cards against the
    single-card results."""
    import jax.numpy as jnp

    from kmer_hasher_tpu import api
    from kmer_hasher_tpu.parallel.mesh import make_mesh
    from kmer_hasher_tpu.parallel.sharded import ShardedKmerIndex

    mesh = make_mesh(4)
    single, t1 = timed(api.count_kmers_fq_sh_rp, d["fq"], K_COUNT,
                       min_q=MIN_Q)
    sh, t4 = timed(api.count_kmers_fq_sh_rp, d["fq"], K_COUNT, min_q=MIN_Q,
                   mesh=mesh)
    log(f"count from file, first call (compile included): one card "
        f"{t1:.2f} s, sharded on 4 cards {t4:.2f} s")
    check("sharded vs single n_unique",
          int(np.asarray(sh.n_unique).sum()) == single.n_unique)
    check("sharded vs single spectrum",
          np.array_equal(sh.spectrum(10000), single.spectrum(10000)))
    a, b = store_table(sh), store_table(single)
    check("sharded vs single key/count table",
          np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))

    k = 32
    seq = d["index_seq"]
    idx = api.make_kmer_hash(seq, k)
    sidx, ts = timed(ShardedKmerIndex, seq, k, mesh)
    log(f"ShardedKmerIndex build on 4 cards: {ts:.2f} s")
    q = seq[: QUERY_LEN + k - 1]
    qk = host_keys(q, k)
    q_hi = jnp.asarray((qk >> np.uint64(32)).astype(np.uint32))
    q_lo = jnp.asarray(qk.astype(np.uint32))
    got = sidx.lookup_counts(q_hi, q_lo)
    lb, ub = idx.lookup_range(q_hi, q_lo)
    check("ShardedKmerIndex.lookup_counts vs KmerIndex",
          np.array_equal(np.asarray(got), np.asarray(ub) - np.asarray(lb)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the sharded paths on four cards")
    a = p.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX found {devs[0].platform}", file=sys.stderr)
        return 2
    want = 4 if a.four else 1
    if len(devs) < want:
        print(f"need {want} GPUs, JAX found {len(devs)}", file=sys.stderr)
        return 2
    import kmer_hasher_tpu  # noqa: F401  (x64 mode, compile cache)

    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}")
    root = os.path.dirname(os.path.abspath(__file__))
    workdir = os.path.join(root, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    phases = Phases()
    try:
        d = phases.run("data", make_data, workdir, not a.four)
        if d is not None:
            if a.four:
                phases.run("four", phase_four, d)
            else:
                phases.run("index", phase_index, d)
                phases.run("count", phase_count, d, workdir)
                phases.run("fsm", phase_fsm, d)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if phases.failed:
        print(f"FAILED phases: {phases.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
