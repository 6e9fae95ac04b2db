"""Driver-contract smoke tests: bench.py must print exactly one JSON line
with the required keys; the graft entry must stay jittable."""
import json
import os
import subprocess
import sys


def test_bench_prints_one_json_line():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["BENCH_LOG_L"] = "16"
    env["BENCH_CHAIN"] = "2"
    env["BENCH_ITERS"] = "1"
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms','cpu');"
         "import runpy; runpy.run_path('bench.py', run_name='__main__')"],
        capture_output=True, text=True, timeout=500, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [l for l in r.stdout.strip().splitlines() if l.strip()]
    assert len(lines) == 1, r.stdout
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["value"] > 0 and rec["vs_baseline"] > 0


def test_graft_entry_jittable():
    import jax

    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert int(out[3]) > 0
