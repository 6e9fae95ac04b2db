"""Headline benchmark: k-mers indexed per second per chip at k=32.

Builds the flagship position index (position-parallel encode -> sort ->
segment group, kmer_hasher_tpu.index.build_index_arrays) over a random
sequence resident on-device, and reports steady-state throughput.

Reference baseline: ~4e6 k-mers/s inserted single-core (32-mer index of a
40 Mbp sequence in ~10 s, reference README.md:136-139; BASELINE.md).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}
"""
from __future__ import annotations

import json
import os
import sys
import time

BASELINE_KMERS_PER_S = 4.0e6  # reference single-core insert rate


def main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from kmer_hasher_tpu.index.position_index import build_index_arrays

    K = int(os.environ.get("BENCH_K", "32"))
    log_l = int(os.environ.get("BENCH_LOG_L", "25"))
    platform = jax.default_backend()
    L = 1 << log_l
    if platform == "cpu":  # keep CI-sized when no accelerator
        L = min(L, 1 << 20)

    NUC = jnp.asarray(np.frombuffer(b"ACGT", np.uint8))
    CHAIN = int(os.environ.get("BENCH_CHAIN", "8"))

    @jax.jit
    def gen(key):
        return NUC[jax.random.randint(key, (L,), 0, 4)]

    seq = gen(jax.random.PRNGKey(0))

    # Chain several builds inside one jit so per-dispatch host latency
    # amortises out of the steady-state rate; each iteration mutates one
    # base so no build can be CSE'd away.
    @jax.jit
    def run_chain(seq):
        def body(i, carry):
            seq, acc = carry
            seq = seq.at[i].set(NUC[i % 4])
            s_hi, s_lo, _s_pos, n_valid, _st, _sg = build_index_arrays(
                seq, K, L
            )
            # consume sort-dependent values from BOTH key lanes: for
            # k <= 16 s_hi is identically zero and an s_hi-only
            # accumulator lets XLA dead-code-eliminate the whole sort
            return seq, (acc + n_valid + s_hi[0].astype(jnp.int32)
                         + s_lo[0].astype(jnp.int32))
        _, acc = jax.lax.fori_loop(0, CHAIN, body, (seq, jnp.int32(0)))
        return acc

    def run():
        out = run_chain(seq)
        return jax.block_until_ready(out)

    run()  # compile
    profile_dir = os.environ.get("BENCH_PROFILE")
    if profile_dir:  # BENCH_PROFILE=1 -> default trace dir
        if profile_dir == "1":
            profile_dir = "/tmp/kmh_bench_trace"
        jax.profiler.start_trace(profile_dir)
    times = []
    for _ in range(int(os.environ.get("BENCH_ITERS", "3"))):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    if profile_dir:
        jax.profiler.stop_trace()
        print(f"profile trace -> {profile_dir}", file=sys.stderr)
    dt = min(times) / CHAIN
    kmers_per_s = L / dt
    print(
        json.dumps(
            {
                "metric": f"kmers indexed/s/chip (k={K}, L=2^{log_l}, "
                          f"{platform})",
                "value": round(kmers_per_s, 1),
                "unit": "kmers/s",
                "vs_baseline": round(kmers_per_s / BASELINE_KMERS_PER_S, 3),
            }
        )
    )


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # emit a parseable failure record
        print(json.dumps({"metric": "bench_error", "value": 0, "unit": str(e),
                          "vs_baseline": 0}))
        sys.exit(1)
