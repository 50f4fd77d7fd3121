"""Benchmark harness — the main.cu analog (main.cu:62-139).

Reproduces the reference protocol: every requested version runs over the
seeded (k, m, n) config grid with identical data per version (main.cu:54,
64), timed end-to-end, one report line per (version, config) (main.cu:76).
Improvements over the reference (SURVEY.md §4-§5):

- correctness is *checked*, not assumed: every run's output is scored
  against the f64 oracle (recall@1 must be 1.0) on up to
  ``recall_check_queries`` queries;
- build time (tree construction / device staging) and query time are
  reported separately for ALL versions (the reference only split tree
  versions, core.cu:1158-1159);
- warm-up runs exclude compile cost (the core.cu:1900-1933 WarmUP analog)
  and timing takes the min over ``timing_iters`` repetitions;
- records are structured (JSONL + table), not printf lines.

CLI: ``python -m nns.harness --versions 0,4,8 --grid small``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from nns.api import NNEngine
from nns.config import REFERENCE_GRID, BenchConfig
from nns.data import make_dataset
from nns.kernels.oracle import nn_oracle_f64, recall_at_1
from nns.utils.report import ReportWriter, RunRecord, format_table
from nns.utils.timing import now_ns

# Scaled-down grid for quick runs / CI (same corners, smaller n).
SMALL_GRID = (
    (3, 1, 1024),
    (16, 1, 1024),
    (3, 256, 1024),
    (16, 256, 1024),
    (3, 256, 16384),
    (16, 256, 16384),
)

_oracle_cache: dict = {}


def _oracle_for(k: int, m: int, n: int, seed: int, cap: int,
                clustered: bool = False, cluster_shape: tuple = ()):
    """Cached oracle minima for a (config, seed), on a query subsample sized
    to bound the f64 scan cost."""
    key = (k, m, n, seed, cap, clustered, cluster_shape)
    if key not in _oracle_cache:
        queries, refs = make_dataset(k, m, n, seed, clustered=clustered,
                                     **dict(cluster_shape))
        budget = max(1, min(m, cap, (1 << 28) // max(n, 1)))
        sub = (
            np.arange(m)
            if budget >= m
            else np.random.default_rng(0).choice(m, size=budget, replace=False)
        )
        _, dmin = nn_oracle_f64(queries[sub], refs)
        _oracle_cache[key] = (sub, dmin)
    return _oracle_cache[key]


def run_one(
    version: int | str,
    k: int,
    m: int,
    n: int,
    cfg: BenchConfig,
) -> RunRecord:
    queries, refs = make_dataset(k, m, n, cfg.seed, clustered=cfg.clustered,
                                 **dict(cfg.cluster_shape))
    engine = NNEngine(version)

    # Warm the BUILD path too (the core.cu:1900-1933 compile-exclusion
    # analog, applied to builds the way the loop below applies it to
    # queries): an untimed throwaway build of the same data primes kernel
    # compiles and staging caches. Without this, a version's first build
    # absorbs first-compile of its staging kernels, which can dwarf the
    # build itself.
    if cfg.warmup_iters > 0:
        NNEngine(version).build(refs)

    t0 = now_ns()
    engine.build(refs)
    build_ms = (now_ns() - t0) / 1e6

    # Warm-up (compile) runs, then best-of timed runs.
    for _ in range(max(0, cfg.warmup_iters)):
        idx = engine.query(queries)
    query_ms = float("inf")
    idx = None
    for _ in range(max(1, cfg.timing_iters)):
        t0 = now_ns()
        idx = engine.query(queries)
        query_ms = min(query_ms, (now_ns() - t0) / 1e6)

    recall = None
    if cfg.check_recall:
        sub, dmin = _oracle_for(
            k, m, n, cfg.seed, cfg.recall_check_queries, cfg.clustered,
            cfg.cluster_shape,
        )
        recall = recall_at_1(np.asarray(idx)[sub], queries[sub], refs, oracle_dmin=dmin)

    return RunRecord(
        version=engine.spec.name,
        k=k,
        m=m,
        n=n,
        build_ms=build_ms,
        query_ms=query_ms,
        qps=m / (query_ms / 1e3) if query_ms > 0 else float("inf"),
        recall_at_1=recall,
    )


def run(cfg: BenchConfig, verbose: bool = True) -> list[RunRecord]:
    # Backend warm-up before anything is timed (the reference's pre-main
    # WarmUP analog, core.cu:1900-1933): without it the FIRST config's
    # build_ms absorbs ~10 s of device/runtime initialization.
    import jax
    import jax.numpy as jnp

    from nns.utils.timing import warmup

    warmup(lambda: jnp.ones((8, 128)) * 2.0)

    writer = ReportWriter(cfg.jsonl_path)
    try:
        for version in cfg.versions:
            for k, m, n in cfg.grid:
                rec = run_one(version, k, m, n, cfg)
                writer.add(rec)
                if verbose:
                    print(
                        f"[nns] {rec.version:<24} k={k:<3} m={m:<6} n={n:<8} "
                        f"build={rec.build_ms:9.2f}ms query={rec.query_ms:9.2f}ms "
                        f"qps={rec.qps:12.1f} recall={rec.recall_at_1}",
                        flush=True,
                    )
    finally:
        writer.close()
    return writer.records


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="nns.harness",
        description="Run NNS versions over the benchmark grid (main.cu analog).",
    )
    p.add_argument("--versions", default="all", help="comma-separated version ids/names, or 'all'")
    p.add_argument("--grid", default="reference", choices=["reference", "small"])
    p.add_argument("--seed", type=int, default=1000)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--no-recall", action="store_true", help="skip oracle recall check")
    p.add_argument(
        "--clustered", action="store_true",
        help="clustered Gaussian-mixture reference points (BASELINE config 5 domain)",
    )
    p.add_argument("--cluster-sigma", type=float, default=None,
                   help="blob sigma (default 0.01; clustered only)")
    p.add_argument("--cluster-count", type=int, default=None,
                   help="blob count (default ~sqrt(n)/4; clustered only)")
    p.add_argument("--cluster-anisotropy", type=float, default=None,
                   help="per-axis sigma stretch ratio (clustered only)")
    p.add_argument("--cluster-powerlaw", action="store_true",
                   help="Zipf-like blob populations (clustered only)")
    p.add_argument("--jsonl", default=None, help="append structured records to this JSONL file")
    p.add_argument(
        "--profile-dir", default=None,
        help="dump a jax.profiler trace of the whole run to this directory "
             "(the tracing subsystem the reference lacks, SURVEY.md §5)",
    )
    args = p.parse_args(argv)

    if args.versions == "all":
        versions: tuple = tuple(range(15))
    else:
        versions = tuple(
            int(v) if v.strip().isdigit() else v.strip() for v in args.versions.split(",")
        )
    cfg = BenchConfig(
        versions=versions,
        grid=REFERENCE_GRID if args.grid == "reference" else SMALL_GRID,
        seed=args.seed,
        warmup_iters=args.warmup,
        timing_iters=args.iters,
        check_recall=not args.no_recall,
        clustered=args.clustered,
        cluster_shape=tuple(
            (key, val)
            for key, val in (
                ("sigma", args.cluster_sigma),
                ("n_clusters", args.cluster_count),
                ("anisotropy", args.cluster_anisotropy),
                ("powerlaw", True if args.cluster_powerlaw else None),
            )
            if val is not None
        ),
        jsonl_path=args.jsonl,
    )
    if args.profile_dir:
        import jax

        with jax.profiler.trace(args.profile_dir):
            records = run(cfg)
    else:
        records = run(cfg)
    print()
    print(format_table(records))
    bad = [r for r in records if r.recall_at_1 is not None and r.recall_at_1 < 1.0]
    if bad:
        print(f"\nFAIL: {len(bad)} runs below recall@1 = 1.0", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
