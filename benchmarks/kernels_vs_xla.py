"""Each hand-written kernel against the plain JAX form XLA compiles for the
same job, at the shapes of the main path, on one GPU.

- fused exact scan (pallas_fused) vs v1's fused distance + argmin
  (xla_bruteforce._distance_matrix_idx), k = 3 and 16, m = 1 and 10K,
  n = 1M;
- the supercell scan (cell_list._cell_scan, a plain XLA reduction since a
  Triton kernel lost to it) on the index of 1M uniform 3-D points (D = 14,
  R_max = 1280, QM = 16);
- v9 phase 1 (mxu_expansion._phase1) vs a chunked f32 product at
  ``Precision.HIGHEST`` and at ``BF16_BF16_F32_X3``, each followed by a row
  min, 10K x 1M at k = 16; plus the whole v9 drain.

Every pair is checked for equal answers before it is timed. Times are the
median of ``--reps`` host-clock runs, each ending in ``block_until_ready``,
after one warm-up call (its time, compilation included, is printed as
``first_ms``). One JSON line per measurement, each with the card's name and
power limit.

Usage: python benchmarks/kernels_vs_xla.py [--only fused,cell,v9] [--reps N]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SEED = 1000
N = 1_000_000


def _time(fn, *args, reps: int):
    """(output, first-call ms, median wall ms, device ms per call, top
    device kernels). Device time is read from a profiler trace of ``reps``
    further calls (the sum of kernel durations on the card, per call), the
    wall time from the host clock around each blocked call."""
    import jax

    from nns.utils.profiling import profile_device_ops

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    rep = profile_device_ops(
        lambda: [jax.block_until_ready(fn(*args)) for _ in range(reps)])
    return (out, first * 1e3, statistics.median(ts) * 1e3,
            rep.total_ms / reps, [(k, round(t / reps, 4)) for k, _, t in rep.top(3)])


def _emit(card: str, **rec) -> None:
    print(json.dumps({"card": card, **rec}), flush=True)


# -- plain forms --------------------------------------------------------------


def phase1_xla(q, refs, r2h, precision, chunk: int):
    """v9 phase 1's ranking as plain JAX: per-chunk f32 product q . r at
    ``precision``, written out by the library GEMM, then e = |r|^2/2 - q.r
    and a running row min."""
    import jax
    import jax.numpy as jnp

    def step(best, xs):
        rc, r2c = xs
        cross = jax.lax.dot_general(
            q, rc, (((1,), (1,)), ((), ())), precision=precision,
            preferred_element_type=jnp.float32)
        return jnp.minimum(best, jnp.min(r2c[None, :] - cross, axis=1)), None

    kp = refs.shape[1]
    best, _ = jax.lax.scan(
        step, jnp.full((q.shape[0],), jnp.inf, jnp.float32),
        (refs.reshape(-1, chunk, kp), r2h.reshape(-1, chunk)))
    return best


# -- measurements -------------------------------------------------------------


def run_fused(card: str, reps: int) -> None:
    import jax
    import jax.numpy as jnp

    from nns.data import make_dataset
    from nns.kernels import pallas_fused as pf
    from nns.kernels.xla_bruteforce import _distance_matrix_idx

    for k, m in ((3, 10_000), (16, 10_000), (3, 1), (16, 1)):
        q, r = make_dataset(k, m, N, SEED)
        qd, rd = jax.device_put(q), jax.device_put(r)
        r_dm, tn = pf.prepare_refs(rd)
        plan = pf.fused_plan(m, r_dm.shape[1], k)
        (_, idx_k), first_k, ms_k, dev_k, top_k = _time(
            functools.partial(pf._fused_on_prepared, tile_m=pf._TILE_M,
                              tile_n=tn, interpret=pf.interpret_mode()),
            qd, r_dm, reps=reps)
        idx_x, first_x, ms_x, dev_x, top_x = _time(_distance_matrix_idx, qd, rd,
                                                  reps=reps)
        same = bool(np.array_equal(np.asarray(idx_k), np.asarray(idx_x)))
        _emit(card, kernel="fused_scan", k=k, m=m, n=N, plan=plan,
              kernel_ms=ms_k, kernel_first_ms=first_k, kernel_device_ms=dev_k,
              kernel_top=top_k, xla_ms=ms_x, xla_first_ms=first_x,
              xla_device_ms=dev_x, xla_top=top_x, same_answers=same)


def run_cell(card: str, reps: int) -> None:
    """The supercell scan is the plain XLA form (cell_list._cell_scan): a
    Triton kernel with the halo loop inside the block lost to it (PERF.md),
    so only the form that runs is timed here."""
    import jax
    import jax.numpy as jnp

    from nns.data import make_dataset
    from nns.kernels import cell_list as cl

    q, r = make_dataset(3, 10_000, N, SEED)
    eng = cl.CellListEngine(r)
    packed, _, q_max = eng.stage(q)
    dense, _ = eng._dense_scatter(packed, q_max)
    dense = jax.device_put(dense)
    halo2 = jnp.float32(eng.halo) ** 2
    _, first_x, ms_x, dev_x, top_x = _time(
        jax.jit(cl._cell_scan), dense, eng.halo_dm, eng.halo_ids_dev, halo2,
        reps=reps)
    _emit(card, kernel="cell_scan", G=eng.D ** 3, QM=q_max, R_max=eng.R_max,
          xla_ms=ms_x, xla_first_ms=first_x, xla_device_ms=dev_x,
          xla_top=top_x)


def run_v9(card: str, reps: int) -> None:
    import jax
    import jax.numpy as jnp

    from nns.data import make_dataset
    from nns.kernels import mxu_expansion as mx

    m, k = 10_000, 16
    q, r = make_dataset(k, m, N, SEED)
    eng = mx.MXUExpansion(r)
    st = eng.stage_queries(q)
    qp = jnp.pad(st.q_dev, ((0, 0), (0, eng.kp - k)))
    p1 = jax.jit(functools.partial(
        mx._phase1, kp=eng.kp, tile_m=eng.tile_m, tile_n=eng.tile_n,
        ts=eng.ts, interpret=mx.interpret_mode()))
    outs, first_k, ms_k, dev_k, top_k = _time(p1, qp, eng.rc, eng.r2h,
                                               reps=reps)
    min1 = np.asarray(outs[0])[:q.shape[0]]
    refs_flat = eng.refs_t.reshape(-1, eng.kp)
    n_pad = refs_flat.shape[0]
    chunk = next(c for c in (143_360, 131_072, 65_536, 4096) if n_pad % c == 0)
    rec = dict(kernel="v9_phase1", m=m, n=N, k=k, kernel_ms=ms_k,
               kernel_first_ms=first_k, kernel_device_ms=dev_k,
               kernel_top=top_k, delta=st.delta,
               plan=mx.phase1_plan(m, n_pad, eng.kp, eng.tile_m, eng.tile_n,
                                   eng.ts))
    for name, prec in (("highest", jax.lax.Precision.HIGHEST),
                       ("bf16x3", jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3)):
        try:
            fx = jax.jit(functools.partial(phase1_xla, precision=prec,
                                           chunk=chunk))
            bx, first_x, ms_x, dev_x, top_x = _time(fx, qp, refs_flat,
                                                    eng.r2h, reps=reps)
            rec[f"xla_{name}_ms"] = ms_x
            rec[f"xla_{name}_device_ms"] = dev_x
            rec[f"xla_{name}_top"] = top_x
            rec[f"xla_{name}_first_ms"] = first_x
            rec[f"xla_{name}_max_abs_diff"] = float(
                np.max(np.abs(np.asarray(bx) - min1)))
        except Exception as e:  # a preset the card refuses is a result too
            rec[f"xla_{name}_error"] = repr(e)[:300]
    drain = lambda: eng._drain_staged(st)  # noqa: E731
    _, first_d, ms_d, dev_d, top_d = _time(drain, reps=reps)
    rec.update(drain_ms=ms_d, drain_first_ms=first_d, drain_device_ms=dev_d,
               drain_top=top_d)
    _emit(card, **rec)


def main() -> int:
    from nns.utils.device import card_line, require_gpu

    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="fused,cell,v9")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    dev = require_gpu()
    card = card_line()
    print(f"card: {card}; device: {dev}", flush=True)
    runs = {"fused": run_fused, "cell": run_cell, "v9": run_v9}
    for name in args.only.split(","):
        runs[name](card, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
