"""Harness tests: the main.cu-analog protocol — seeded identical data per
version, build/query split, recall enforcement, CLI."""

import numpy as np

from nns.config import BenchConfig
from nns.data import make_dataset
from nns.harness import main, run, run_one


def test_run_one_records_fields():
    cfg = BenchConfig(check_recall=True, warmup_iters=1, timing_iters=1)
    rec = run_one(4, 3, 16, 1024, cfg)
    assert rec.version == "fused"
    assert rec.recall_at_1 == 1.0
    assert rec.build_ms >= 0 and rec.query_ms > 0 and rec.qps > 0


def test_identical_data_across_versions():
    # The reference reseeds before every version (main.cu:64) so all see the
    # same data; make_dataset must be deterministic per seed.
    q1, r1 = make_dataset(3, 8, 256, seed=1000)
    q2, r2 = make_dataset(3, 8, 256, seed=1000)
    np.testing.assert_array_equal(q1, q2)
    np.testing.assert_array_equal(r1, r2)


def test_run_grid(tmp_path):
    jsonl = tmp_path / "runs.jsonl"
    cfg = BenchConfig(
        versions=(0, 4),
        grid=((3, 4, 256), (16, 4, 256)),
        warmup_iters=1,
        timing_iters=1,
        jsonl_path=str(jsonl),
    )
    records = run(cfg, verbose=False)
    assert len(records) == 4
    assert all(r.recall_at_1 == 1.0 for r in records)
    assert len(jsonl.read_text().splitlines()) == 4


def test_cli_small(capsys):
    rc = main(["--versions", "0,4", "--grid", "small", "--warmup", "1", "--iters", "1"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "fused" in out and "cpu_scan" in out


def test_harness_clustered_distribution():
    from nns.config import BenchConfig
    from nns.harness import run

    cfg = BenchConfig(
        versions=(12, 14), grid=((3, 64, 4096),), clustered=True,
        warmup_iters=0, timing_iters=1,
    )
    recs = run(cfg, verbose=False)
    assert all(r.recall_at_1 == 1.0 for r in recs)
