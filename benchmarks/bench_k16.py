"""k=16 serving benchmark: exact 1-NN, 1M 16-D reference points, W x 10K
distinct query batches drained through the v9 two-phase tensor-core
expansion engine in ONE dispatch + ONE fetch (NNEngine.query_many protocol).

Not the headline (that is bench.py's k=3 supercell drain); this is the
high-k uniform companion. Protocol mirrors bench.py: seeded data, staging
untimed (prepare-once engine), adaptive trial budget with the spread
logged, recall@1 verified on a 512-query f64-oracle subsample, and the
engine's certificate+exact-refine contract exercised end-to-end (the
timed path is the full query(), refines included).

Usage (on a GPU): python benchmarks/bench_k16.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N_REFS = int(os.environ.get("NNS_BENCH_N", str(1 << 20)))
N_QUERIES = int(os.environ.get("NNS_BENCH_M", str(10_000)))
K = 16
SEED = 1000
# Backlog width: batches drained per dispatch + fetch.
W = int(os.environ.get("NNS_BENCH_K16_W", "64"))
MIN_TRIALS = 6
MAX_TRIALS = 48
PATIENCE = 6
TIME_CAP_S = 180.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> int:
    import jax

    from nns.data import make_dataset
    from nns.kernels.mxu_expansion import MXUExpansion
    from nns.kernels.oracle import recall_at_1

    log(f"[bench_k16] backend={jax.default_backend()}")
    queries, refs = make_dataset(K, N_QUERIES, N_REFS, SEED)
    rng = np.random.default_rng(SEED + 1)
    batches = [queries] + [
        rng.random((N_QUERIES, K), dtype=np.float32) for _ in range(W - 1)
    ]
    allq = np.concatenate(batches, axis=0)

    t0 = time.perf_counter()
    eng = MXUExpansion(refs)
    log(f"[bench_k16] staging: {time.perf_counter()-t0:.2f}s "
        f"(tiles {eng.tile_m}x{eng.tile_n}, ts={eng.ts})")

    # Queries pre-staged on device, untimed — the same prepare-once serving
    # protocol as bench.py's k=3 drain (stage_queue): the upload is
    # protocol overhead, not engine work. A serial upload-included number
    # is logged secondarily.
    st = eng.stage_queries(allq)
    idx0 = eng.query_staged(st)  # compile + correctness capture
    _, _, cert0 = eng.query_min_idx_cert(batches[0])
    times: list[float] = []
    best = float("inf")
    since = 0
    t_start = time.perf_counter()
    while len(times) < MAX_TRIALS:
        t0 = time.perf_counter()
        idx0 = eng.query_staged(st)  # 1 dispatch + 1 fetch (+ rare refine)
        per_batch = (time.perf_counter() - t0) / W
        times.append(per_batch * 1e3)
        since = 0 if per_batch < best * 0.995 else since + 1
        best = min(best, per_batch)
        if len(times) >= MIN_TRIALS and (
            since >= PATIENCE or time.perf_counter() - t_start > TIME_CAP_S
        ):
            break
    a = np.asarray(times)
    qps = N_QUERIES / best
    log(f"[bench_k16] staged drain (W={W} distinct 10K batches, 1 dispatch): "
        f"best {a.min():.1f} / p50 {np.percentile(a, 50):.1f} / "
        f"max {a.max():.1f} ms/batch over {len(a)} trials -> {qps:,.0f} qps")

    b_ser = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        idx_ser = eng.query(allq)  # upload + q2 bound inside the region
        b_ser = min(b_ser, (time.perf_counter() - t0) / W)
    log(f"[bench_k16] upload-included drain: {b_ser*1e3:.1f} ms/batch "
        f"-> {N_QUERIES/b_ser:,.0f} qps")
    del idx_ser

    sub = np.random.default_rng(0).choice(
        N_QUERIES, min(512, N_QUERIES), replace=False
    )
    recall = recall_at_1(np.asarray(idx0)[:N_QUERIES][sub],
                         batches[0][sub], refs)
    log(f"[bench_k16] recall@1 (512-query f64 oracle subsample): {recall}; "
        f"certificate fraction (batch 0): {np.asarray(cert0).mean():.4f}")

    value = qps if recall == 1.0 else 0.0
    metric = "exact_1nn_qps_1M_refs_10k_queries_k16_1chip"
    if (N_REFS, N_QUERIES) != (1 << 20, 10_000):  # smoke-test override
        metric = f"exact_1nn_qps_{N_REFS}_refs_{N_QUERIES}_queries_k16_1chip"
    print(json.dumps({
        "metric": metric,
        "value": round(value, 1),
        "unit": "queries/sec",
    }))
    return 0 if recall == 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
