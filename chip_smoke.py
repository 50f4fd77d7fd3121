"""Smoke run of the exact-NN engine on one NVIDIA GPU.

Drives the main path once through the entry points a user calls, at full
size, and checks every answer against the float64 oracle:

1. device: JAX must have found a GPU; prints the card's name and power
   limit (``nvidia-smi``) and the device as JAX reports it.
2. kernels: each compiled kernel at the main path's widths — the fused
   exact scan (10K x 1M at k = 3 and 16, and m = 1 in its reference-split
   mode) and v9's tensor-core phase 1 (10K x 1M x 16), whose measured
   error against the f64 expansion value is printed beside its certificate
   band ``delta`` — and the supercell scan (plain XLA, which beat its
   Triton kernel) on 1M uniform 3-D points: D = 14, R_max = 1280, QM = 16.
3. main path: ``NNEngine("auto")`` on 1M uniform 3-D points (supercell
   index: ``query``, ``query_many`` with a batch the certificate partly
   misses, ``query_topk``), on 1M uniform 16-D points (v9) and on 1M
   clustered 16-D points, queried past the high-k probe so that the
   chunk-scan promotion runs.
4. profile: the top device kernels of one supercell drain.
5. GPU-marked tests, run in this process.

Every phase checks recall@1 == 1.0 (tie-tolerant) on at least 512 queries.
Any failure ends the run with a non-zero exit and no result line; the last
line of a passing run is one JSON object naming the device.

``--four-cards`` runs only the multi-card path on four GPUs: the sharded
supercell engine (``NNEngine("auto")`` on 1M x 3), ``nns(version=8)`` and
``ring_argmin`` on 1M x 16, each against the oracle and the one-card answer.

Usage: python chip_smoke.py [--four-cards] [--seed N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

N_REFS = 1_000_000
M = 10_000
CHECK = 512  # oracle-checked queries per phase


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


class Log:
    """Prints each result line with the card it was measured on."""

    def __init__(self, card: str):
        self.card = card

    def __call__(self, msg: str) -> None:
        print(f"[smoke] {msg}  ({self.card})", flush=True)


def oracle_dmin(queries: np.ndarray, refs: np.ndarray) -> np.ndarray:
    """The f64 oracle's nearest distances, one thread per query slice (the
    oracle's numpy kernels release the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    from nns.kernels.oracle import nn_oracle_f64

    parts = np.array_split(np.arange(len(queries)), min(16, len(queries)))
    with ThreadPoolExecutor(len(parts)) as ex:
        outs = list(ex.map(lambda p: nn_oracle_f64(queries[p], refs)[1], parts))
    return np.concatenate(outs)


def recall(idx, queries, refs, rows=None) -> float:
    """recall@1 against the f64 oracle on ``rows`` (default: CHECK rows
    drawn at random)."""
    from nns.kernels.oracle import recall_at_1

    idx = np.asarray(idx)
    if rows is None:
        rows = np.random.default_rng(0).choice(
            len(queries), min(CHECK, len(queries)), replace=False)
    q = queries[rows]
    return recall_at_1(idx[rows], q, refs, oracle_dmin(q, refs))


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def _twice(fn):
    """(first output, first-call ms with compilation, warm ms)."""
    out, first = _timed(fn)
    _, warm = _timed(fn)
    return out, first, warm


# -- phases -------------------------------------------------------------------


def phase_kernels(log: Log, n: int, m: int, seed: int) -> None:
    """Each compiled kernel, and the supercell scan, at the main path's
    widths against the oracle."""
    import jax.numpy as jnp

    from nns.data import make_dataset
    from nns.kernels import mxu_expansion as mx
    from nns.kernels import pallas_fused as pf
    from nns.kernels.cell_list import CellListEngine

    for k in (3, 16):
        q, r = make_dataset(k, m, n, seed)
        fb = pf.FusedBruteForce(r)
        plan = pf.fused_plan(m, fb.r_dm.shape[1], k, fb.tile_m, fb.tile_n)
        idx, ms = _timed(lambda: np.asarray(fb.query(q)))
        rc = recall(idx, q, r)
        log(f"fused scan k={k} {m}x{n} plan={plan}: recall={rc} "
            f"wall={ms:.1f} ms (first call)")
        check(rc == 1.0, f"fused scan k={k} recall {rc}")
    # m = 1 (k = 16, the last fb above) takes the reference-split mode: one
    # query cannot fill the card.
    plan = pf.fused_plan(1, fb.r_dm.shape[1], 16, fb.tile_m, fb.tile_n)
    check(plan["splits"] > 1, f"m=1 plan has no reference split: {plan}")
    rows = np.random.default_rng(1).choice(m, min(CHECK, m), replace=False)
    idx1 = np.zeros(m, np.int32)
    for i in rows:
        idx1[i] = np.asarray(fb.query(q[i:i + 1]))[0]
    rc = recall(idx1, q, r, rows)
    log(f"fused scan k=16 m=1 x{len(rows)} plan={plan}: recall={rc}")
    check(rc == 1.0, f"fused scan m=1 recall {rc}")

    q, r = make_dataset(3, m, n, seed)
    eng = CellListEngine(r)
    (idx, ok), ms = _timed(lambda: eng.query_with_flags(q))
    cert = np.flatnonzero(ok)
    rows = np.random.default_rng(2).choice(cert, min(CHECK, len(cert)),
                                           replace=False)
    rc = recall(idx, q, r, rows)
    log(f"supercell scan D={eng.D} R_max={eng.R_max} G={eng.D ** 3}: "
        f"coverage={ok.mean():.6f} recall(certified)={rc} wall={ms:.1f} ms")
    check(rc == 1.0 and ok.mean() > 0.99, "supercell scan")

    q, r = make_dataset(16, m, n, seed)
    v9 = mx.MXUExpansion(r)
    st = v9.stage_queries(q)
    qp = jnp.pad(st.q_dev, ((0, 0), (0, v9.kp - 16)))
    min1 = np.asarray(mx._phase1(qp, v9.rc, v9.r2h, v9.kp, v9.tile_m,
                                 v9.tile_n, v9.ts, mx.interpret_mode())[0])
    rows = np.random.default_rng(3).choice(m, min(CHECK, m), replace=False)
    qs = q[rows].astype(np.float64)
    e64 = 0.5 * (oracle_dmin(q[rows], r) - (qs * qs).sum(axis=1))
    err = float(np.abs(min1[rows] - e64).max())
    log(f"v9 phase 1 {m}x{n}x16: max|e_gpu - e_f64|={err:.3e} "
        f"vs delta={st.delta:.3e}")
    check(err < st.delta, "v9 phase-1 error exceeds the certificate band")
    (_, idx, cert), ms = _timed(lambda: v9.query_min_idx_cert(q))
    rows = np.random.default_rng(4).choice(
        np.flatnonzero(cert), min(CHECK, int(cert.sum())), replace=False)
    rc = recall(idx, q, r, rows)
    log(f"v9 phases 1+2: certified={cert.mean():.5f} recall(certified)={rc}")
    check(rc == 1.0, f"v9 recall {rc}")


def _far_rows(batch: np.ndarray, count: int, rng) -> np.ndarray:
    """Replace ``count`` rows with points outside the data box, farther
    from every reference point than the supercell halo: the certificate
    cannot prove them, so they take the exact fallback."""
    rows = rng.choice(len(batch), count, replace=False)
    batch[rows] = 1.05 + 0.1 * rng.random((count, batch.shape[1]),
                                          dtype=np.float32)
    return rows


def phase_cells(log: Log, n: int, m: int, seed: int) -> None:
    """NNEngine("auto") on uniform 3-D points: the supercell index."""
    from nns.api import NNEngine
    from nns.data import make_dataset
    from nns.kernels.cell_list import CellListEngine
    from nns.kernels.oracle import _dists_f64

    q, r = make_dataset(3, m, n, seed)
    eng, ms = _timed(lambda: NNEngine("auto").build(r))
    cells = eng._built
    check(type(cells) is CellListEngine, f"auto built {type(cells).__name__}")
    log(f"cells build n={n}: D={cells.D} R_max={cells.R_max} "
        f"wall={ms:.0f} ms")
    idx, ms, warm = _twice(lambda: eng.query(q))
    rc = recall(idx, q, r)
    log(f"cells query {m}: recall={rc} wall={ms:.1f} ms first call, "
        f"{warm:.1f} ms warm")
    check(rc == 1.0, f"cells query recall {rc}")

    rng = np.random.default_rng(seed + 1)
    batches = [rng.random((m, 3), dtype=np.float32) for _ in range(3)]
    far = _far_rows(batches[1], 64, rng)
    _, ok = cells.query_with_flags(batches[1])
    check(not ok[far].any(), "far rows were certified")
    cov = float(ok.mean())
    outs, ms, warm = _twice(lambda: eng.query_many(batches))
    for b, (qb, idx) in enumerate(zip(batches, outs)):
        rows = np.random.default_rng(b).choice(m, CHECK, replace=False)
        if b == 1:
            rows = np.union1d(rows, far)
        rc = recall(idx, qb, r, rows)
        check(rc == 1.0, f"query_many batch {b} recall {rc}")
    log(f"cells query_many 3x{m} (batch 1: {len(far)} uncertified rows, "
        f"coverage {cov:.4f}): recall=1.0 wall={ms:.1f} ms first call, "
        f"{warm:.1f} ms warm")
    check(type(eng._built) is CellListEngine, "engine left the cell index")

    k_nn = 8
    (d2, idx), ms, warm = _twice(lambda: eng.query_topk(q, k_nn=k_nn))
    rows = np.random.default_rng(5).choice(m, CHECK, replace=False)
    worst = 0.0
    for lo in range(0, len(rows), 64):
        rr = rows[lo:lo + 64]
        d64 = _dists_f64(q[rr], r)
        want = np.sort(np.partition(d64, k_nn - 1, axis=1)[:, :k_nn], axis=1)
        got = np.sort(np.take_along_axis(d64, idx[rr].astype(np.int64), 1), 1)
        worst = max(worst, float(np.max(np.abs(got - want) / np.maximum(want, 1e-30))))
    band = 2.0 * (3 + 3) * 2.0 ** -24  # f32 arithmetic noise (oracle.py)
    log(f"cells query_topk k={k_nn} {m}: max rel dist error vs f64 top-{k_nn}"
        f"={worst:.2e} (band {band:.1e}) wall={ms:.1f} ms first call, "
        f"{warm:.1f} ms warm")
    check(worst <= band, "query_topk distances disagree with the f64 top-k")


def phase_high_k(log: Log, n: int, m: int, seed: int) -> None:
    """NNEngine("auto") on uniform 16-D points: the v9 engine."""
    from nns.api import NNEngine
    from nns.data import make_dataset
    from nns.kernels.mxu_expansion import MXUExpansion

    q, r = make_dataset(16, m, n, seed)
    eng, ms = _timed(lambda: NNEngine("auto").build(r))
    check(type(eng._built) is MXUExpansion, f"auto built {type(eng._built).__name__}")
    log(f"v9 build n={n} k=16: wall={ms:.0f} ms")
    idx, ms = _timed(lambda: eng.query(q))
    rc = recall(idx, q, r)
    log(f"v9 query {m}: recall={rc} wall={ms:.1f} ms (probe included)")
    check(rc == 1.0, f"v9 query recall {rc}")
    rng = np.random.default_rng(seed + 2)
    batches = [rng.random((m, 16), dtype=np.float32) for _ in range(3)]
    outs, ms, warm = _twice(lambda: eng.query_many(batches))
    for b, (qb, idx) in enumerate(zip(batches, outs)):
        rc = recall(idx, qb, r)
        check(rc == 1.0, f"v9 query_many batch {b} recall {rc}")
    log(f"v9 query_many 3x{m}: recall=1.0 wall={ms:.1f} ms first call, "
        f"{warm:.1f} ms warm ({m * 3 / warm * 1e3:,.0f} queries/s); engine "
        f"after the probe: {type(eng._built).__name__}")


def phase_clustered(log: Log, n: int, m: int, seed: int, config=None) -> None:
    """NNEngine("auto") on clustered 16-D points with in-distribution
    queries, past the high-k probe: promotion to the chunk scan."""
    from nns.api import NNEngine
    from nns.data import make_dataset
    from nns.trees.beam import BeamIndex

    _, r = make_dataset(16, 1, n, seed, clustered=True)
    rng = np.random.default_rng(seed + 3)

    def indist(count):
        base = r[rng.integers(0, n, size=count)]
        return (base + rng.normal(0, 0.01, size=base.shape)).astype(np.float32)

    eng = NNEngine("auto", config).build(r)
    q0 = indist(m)
    idx, ms = _timed(lambda: eng.query(q0))
    check(isinstance(eng._built, BeamIndex), "no promotion to the KD index")
    check(eng._hk_budget is not None, "promotion did not pick the chunk scan")
    rc = recall(idx, q0, r)
    log(f"clustered k=16 first query {m} (v9 + probe + KD build): "
        f"recall={rc} wall={ms:.0f} ms; promoted to chunk scan, "
        f"budget={eng._hk_budget}")
    check(rc == 1.0, f"clustered first batch recall {rc}")
    batches = [indist(m) for _ in range(3)]
    outs, ms, warm = _twice(lambda: eng.query_many(batches))
    for b, (qb, idx) in enumerate(zip(batches, outs)):
        rc = recall(idx, qb, r)
        check(rc == 1.0, f"chunk-scan batch {b} recall {rc}")
    check(isinstance(eng._built, BeamIndex), "chunk scan demoted")
    bi = eng._built  # base-pass coverage of the drain query_many staged
    _, ok = bi.query_staged_scan_with_flags(
        bi.stage_queries(np.concatenate(batches)), eng._hk_budget)
    log(f"clustered chunk-scan query_many 3x{m}: recall=1.0 "
        f"wall={ms:.1f} ms first call, {warm:.1f} ms warm "
        f"({m * 3 / warm * 1e3:,.0f} queries/s); chunk-scan coverage "
        f"{ok.mean():.5f}")


def phase_profile(log: Log, n: int, m: int, seed: int) -> None:
    """Top device kernels of one supercell drain."""
    from nns.data import make_dataset
    from nns.kernels.cell_list import CellListEngine
    from nns.utils.profiling import profile_device_ops

    _, r = make_dataset(3, 1, n, seed)
    eng = CellListEngine(r)
    rng = np.random.default_rng(seed + 4)
    batches = [rng.random((m, 3), dtype=np.float32) for _ in range(4)]
    eng.query_queue(batches)  # compile outside the trace
    rep = profile_device_ops(lambda: eng.query_queue(batches))
    top = ", ".join(f"{k} {t:.3f} ms x{c}" for k, c, t in rep.top(6))
    log(f"profile of one 4x{m} supercell drain: device busy "
        f"{rep.total_ms:.3f} ms on {rep.device or 'no device plane'}; top: "
        f"{top}")


def phase_gpu_tests(log: Log) -> None:
    """The tests marked ``gpu``, in this process, on this card."""
    import pytest

    os.environ["NNS_TESTS_ON_DEVICE"] = "1"
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")

    class Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                Count.passed += 1

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", tests],
                     plugins=[Count()])
    log(f"gpu-marked tests: exit {rc}, {Count.passed} passed")
    check(rc == 0 and Count.passed > 0, f"gpu-marked tests exit {rc}")


def phase_four_cards(log: Log, n: int, m: int, seed: int) -> None:
    """The multi-card path against the oracle and the one-card answers."""
    import jax

    from nns.api import NNEngine, nns
    from nns.data import make_dataset
    from nns.kernels.cell_list import CellListEngine
    from nns.kernels.pallas_fused import nns_fused
    from nns.parallel.mesh import make_mesh
    from nns.parallel.ring import ring_argmin
    from nns.parallel.sharded_cells import ShardedCellEngine

    check(len(jax.devices()) == 4, f"{len(jax.devices())} devices, need 4")
    q, r = make_dataset(3, m, n, seed)
    eng, ms = _timed(lambda: NNEngine("auto").build(r))
    check(type(eng._built) is ShardedCellEngine,
          f"auto built {type(eng._built).__name__}")
    idx4, ms_q = _timed(lambda: eng.query(q))
    idx1 = CellListEngine(r).query(q)
    rc4, rc1 = recall(idx4, q, r), recall(idx1, q, r)
    agree = float((idx4 == idx1).mean())
    log(f"4 cards: sharded cells 1M x 3: build {ms:.0f} ms, query {m} "
        f"{ms_q:.1f} ms; recall={rc4} (one card {rc1}), "
        f"agreement with one card={agree}")
    check(rc4 == 1.0 and rc1 == 1.0, "sharded cells recall")

    q, r = make_dataset(16, m, n, seed)
    one = np.asarray(nns_fused(q, r))
    v8, ms8 = _timed(lambda: nns(q, r, version=8))
    ring, msr = _timed(lambda: np.asarray(ring_argmin(q, r, make_mesh(4))))
    for name, idx, ms in (("nns(version=8)", v8, ms8), ("ring_argmin", ring, msr)):
        rc = recall(idx, q, r)
        same = bool(np.array_equal(np.asarray(idx), one))
        log(f"4 cards: {name} 1M x 16, {m} queries: recall={rc}, "
            f"same as one card={same}, wall={ms:.0f} ms (first call)")
        check(rc == 1.0 and same, f"{name} on four cards")


# -- entry point --------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card path (needs four GPUs)")
    ap.add_argument("--seed", type=int, default=1000)
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX's backend is "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 2
    from nns.utils.device import card_line, require_gpu

    dev = require_gpu()
    card = card_line()
    print(card, flush=True)
    log = Log(card.splitlines()[0])
    log(f"device: {dev}")
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(log, N_REFS, M, args.seed)
    else:
        for phase in (phase_kernels, phase_cells, phase_high_k,
                      phase_clustered, phase_profile):
            t = time.perf_counter()
            phase(log, N_REFS, M, args.seed)
            log(f"{phase.__name__} done in {time.perf_counter() - t:.1f} s")
        phase_gpu_tests(log)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
