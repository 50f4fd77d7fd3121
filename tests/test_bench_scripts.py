"""End-to-end smoke of the benchmark SCRIPTS at toy sizes (CPU).

A crash anywhere in bench.py's staging/drain/verification path loses the
headline. These run the exact scripts as subprocesses with the documented
NNS_BENCH_* smoke overrides (the defaults are untouched) and assert the
JSON contract.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script: str, env_extra: dict[str, str]) -> dict:
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", **env_extra)
    r = subprocess.run(
        [sys.executable, script], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=480,
    )
    assert r.returncode == 0, f"{script} failed:\n{r.stderr[-2000:]}"
    line = r.stdout.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rec["unit"] == "queries/sec"
    assert rec["value"] > 0  # value 0 = recall/certificate failure
    return rec


def test_bench_headline_script_smoke():
    rec = _run("bench.py", {
        "NNS_BENCH_N": "4096", "NNS_BENCH_M": "64", "NNS_BENCH_W": "2",
    })
    assert rec["metric"] == "exact_1nn_qps_4096_refs_64_queries_k3_1chip"
    assert "vs_baseline" in rec


def test_bench_k16_script_smoke():
    rec = _run("benchmarks/bench_k16.py", {
        "NNS_BENCH_N": "2048", "NNS_BENCH_M": "64", "NNS_BENCH_K16_W": "2",
    })
    assert rec["metric"] == "exact_1nn_qps_2048_refs_64_queries_k16_1chip"


def test_bench_k16_clustered_script_smoke():
    rec = _run("benchmarks/bench_k16_clustered.py", {
        "NNS_BENCH_N": "2048", "NNS_BENCH_M": "64", "NNS_BENCH_K16_W": "2",
    })
    assert rec["metric"] == (
        "exact_1nn_qps_2048_refs_64_queries_k16_clustered_1chip"
    )
    assert rec["coverage"] > 0.9  # promoted beam covers the clustered drain
