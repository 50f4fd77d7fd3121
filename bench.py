"""Headline benchmark: exact 1-NN, 1M 3-D reference points x 10K queries,
one device, flagship supercell engine (build once, staged query batches).

Prints ONE JSON line:
  {"metric": ..., "value": qps, "unit": "queries/sec", "vs_baseline": ...}

vs_baseline normalizes against the BASELINE.md north-star target of
2,000,000 qps (= 5x an estimated ~400K qps for the reference's V9 on its
4-GPU sm_70 setup at this workload; the reference publishes no numbers —
BASELINE.md "published: none" — so the 5x goal IS the baseline).
vs_baseline >= 1.0 means the north star is met.

Protocol (mirrors the reference's, SURVEY.md §6): seeded data (seed 1000),
index build + query staging timed separately (the reference prints tree
build time separately, core.cu:1158-1159), warm-up excluded
(core.cu:1900-1933 analog). The headline is the throughput of the
STAGED-QUEUE drain: W DISTINCT 10K-query batches, staged and uploaded
upfront as a serving front-end holds an accumulated backlog, are drained by
ONE device program, and the timed region ends when the host holds the
final batch's result. Staging is RAGGED: each batch keeps its own pow2
q_max, so one skewed batch cannot inflate every batch's winner table.
Full-queue result download and per-request serial latency are measured and
logged alongside — neither is the headline, and every quote of the headline
must name the staged-queue protocol.

The trial budget is adaptive: trials continue until the best stops
improving for PATIENCE consecutive trials (or a hard trial/time cap), and
the spread (best / p50 / p90 / max) is logged so a noisy capture is
visible.

recall@1 is verified against the f64 oracle on a 512-query subsample and
the engine's own exactness certificate must hold for every query of the
seeded batch (else the benchmark reports value 0).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

# Workload (env-overridable only for smoke tests — e.g. a tiny CPU run of
# this exact script).
N_REFS = int(os.environ.get("NNS_BENCH_N", str(1_000_000)))
N_QUERIES = int(os.environ.get("NNS_BENCH_M", str(10_000)))
K = 3
SEED = 1000
BASELINE_QPS = 2_000_000.0  # north-star target (see module docstring)

# Distinct staged batches, drained by one device program (env-overridable
# for smoke tests).
W = int(os.environ.get("NNS_BENCH_W", "768"))
MIN_TRIALS = 12
MAX_TRIALS = 96
PATIENCE = 10     # stop when the best hasn't improved for this many trials
TIME_CAP_S = 150.0
# Soft deadline for the SECONDARY stages (full download / serial), measured
# from script start. The headline drain and the correctness gate always run
# to completion; once past this budget the secondaries shrink to their
# 1-trial minimum.
SOFT_DEADLINE_S = float(os.environ.get("NNS_BENCH_DEADLINE", "420"))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _spread(ms: list[float]) -> str:
    a = np.asarray(ms)
    return (
        f"best {a.min():.2f} / p50 {np.percentile(a, 50):.2f} / "
        f"p90 {np.percentile(a, 90):.2f} / max {a.max():.2f} ms/batch "
        f"over {len(a)} trials"
    )


def main() -> int:
    t_script0 = time.perf_counter()
    import jax

    from nns.data import make_dataset
    from nns.kernels.cell_list import CellListEngine
    from nns.kernels.oracle import recall_at_1

    log(f"[bench] backend={jax.default_backend()} devices={jax.devices()}")
    queries, refs = make_dataset(K, N_QUERIES, N_REFS, SEED)

    t0 = time.perf_counter()
    engine = CellListEngine(refs)
    build_s = time.perf_counter() - t0
    log(
        f"[bench] index build: {build_s*1e3:.1f} ms "
        f"(D={engine.D}, R_max={engine.R_max}, avg_cand={engine.avg_candidates:.0f})"
    )

    # W DISTINCT query batches (fresh uniform draws over the data box),
    # staged upfront as a serving front-end holds an accumulated queue.
    rng = np.random.default_rng(SEED + 1)
    lo, hi = refs.min(axis=0), refs.max(axis=0)
    batches = [queries] + [
        (rng.random((N_QUERIES, K), dtype=np.float32) * (hi - lo) + lo).astype(np.float32)
        for _ in range(W - 1)
    ]
    denses, fslots, orders = engine.stage_queue_ragged(batches)
    assert denses is not None, "benchmark batch unexpectedly exceeded q_max_limit"
    # Per-batch device arrays: the tuple drain skips the per-batch
    # dynamic-slice the stacked form pays, and ragged staging keeps each
    # batch at its OWN pow2 q_max (one skewed batch cannot double every
    # batch's winner table).
    dq = tuple(jax.device_put(denses))
    jax.block_until_ready(dq)
    row_sizes = [d.shape[0] * d.shape[1] for d in denses]
    offs = np.concatenate([[0], np.cumsum(row_sizes)])

    # Warm-up: compile + settle, and ONE full result download (untimed) to
    # identify the queue's uncertified slots. A seeded 768-batch queue is
    # NOT fully certificate-covered (a
    # handful of far-tail queries per ~million exceed the halo), so the
    # timed program must include the exact re-answering the serving path
    # (query_queue) performs — otherwise the headline times a drain whose
    # answers are not final.
    import jax.numpy as jnp

    from nns.kernels.pallas_fused import FusedBruteForce

    out = engine.query_queue_staged(dq)
    full_np = np.asarray(jnp.concatenate([r.reshape(-1) for r in out]))
    uncert: list[tuple[int, np.ndarray]] = []  # (batch, original rows)
    n_occupied = 0
    for w in range(W):
        idx_w, ok_w = engine.unscatter_queue(
            full_np[offs[w]:offs[w + 1]], fslots[w], orders[w])
        risk = engine._sentinel_risk(batches[w])
        if risk is not None:
            ok_w &= ~risk
        n_occupied += len(ok_w)
        if not ok_w.all():
            uncert.append((w, np.flatnonzero(~ok_w)))
    n_uncert = int(sum(len(rows) for _, rows in uncert))
    log(f"[bench] certificate coverage: {n_occupied - n_uncert}/{n_occupied} "
        f"queries certified ({n_uncert} uncertified across "
        f"{len(uncert)} of {W} batches) — uncertified rows are exactly "
        f"re-answered INSIDE the timed program (serving parity)")
    if n_uncert:
        from nns.kernels.layouts import pow2_at_least

        q_uncert = np.concatenate(
            [batches[w][rows] for w, rows in uncert], axis=0)
        bucket = pow2_at_least(max(n_uncert, 8))
        q_pad = np.zeros((bucket, K), np.float32)
        q_pad[:n_uncert] = q_uncert
        fb = FusedBruteForce(refs)
        q_uncert_dev = jax.device_put(q_pad)
        patch_np = np.asarray(fb.query(q_uncert_dev))[:n_uncert]  # warm
    else:
        fb = q_uncert_dev = None
        patch_np = np.zeros(0, np.int32)

    # Headline: one device program drains all W batches PLUS the exact
    # re-answer of the uncertified tail; adaptive trial budget. The sync
    # fetch rides the patch result when one exists (issued last, so its
    # arrival implies the drain completed).
    times: list[float] = []
    best = float("inf")
    since_improve = 0
    t_start = time.perf_counter()
    while len(times) < MAX_TRIALS:
        t0 = time.perf_counter()
        out = engine.query_queue_staged(dq)
        if fb is not None:
            patch_np = np.asarray(fb.query(q_uncert_dev))[:n_uncert]  # sync
        else:
            _ = np.asarray(out[-1])  # sync: final batch's winner table
        per_batch = (time.perf_counter() - t0) / W
        times.append(per_batch * 1e3)
        # best always tracks the true minimum (the reported headline must
        # equal the spread line's "best"); the 0.5% threshold only gates
        # the patience counter.
        if per_batch < best * 0.995:
            since_improve = 0
        else:
            since_improve += 1
        best = min(best, per_batch)
        if (
            len(times) >= MIN_TRIALS
            and (since_improve >= PATIENCE
                 or time.perf_counter() - t_start > TIME_CAP_S)
        ):
            break
    qps = N_QUERIES / best
    log(
        f"[bench] staged-queue drain ({W} distinct batches, 1 dispatch, "
        f"sync fetch): {_spread(times)} -> {qps:,.0f} qps"
    )

    # Correctness gates + the JSON line, BEFORE the remaining secondary
    # measurements, so that an external time cap on this script cannot
    # take the result with it. The gates check the SERVING answers the
    # timed program actually produces: drain winners with the uncertified
    # tail patched by the in-program exact rescan (the drain reports W
    # batches, so its evidence must cover W batches, not batch 0 alone).
    def served_batch(w: int) -> np.ndarray:
        """Final serving answers of batch w: unscattered winners with this
        batch's uncertified rows patched from the timed exact rescan."""
        idx_w, _ = engine.unscatter_queue(
            full_np[offs[w]:offs[w + 1]], fslots[w], orders[w])
        off = 0
        for wu, rows in uncert:
            if wu == w:
                idx_w[rows] = patch_np[off : off + len(rows)]
                break
            off += len(rows)
        return idx_w

    sub = np.random.default_rng(0).choice(
        N_QUERIES, size=min(512, N_QUERIES), replace=False
    )
    recall = recall_at_1(served_batch(0)[sub], queries[sub], refs)
    log(f"[bench] recall@1 (batch 0, 512-query f64 oracle subsample): {recall}")
    # A RANDOM mid-queue batch gets the same oracle treatment as batch 0.
    rb = int(np.random.default_rng(1).integers(1, W)) if W > 1 else 0
    sub_rb = np.random.default_rng(2).choice(
        len(batches[rb]), size=min(512, len(batches[rb])), replace=False
    )
    recall_rb = recall_at_1(served_batch(rb)[sub_rb], batches[rb][sub_rb], refs)
    log(f"[bench] recall@1 (batch {rb}, 512-query f64 oracle subsample): "
        f"{recall_rb}")
    # Every patched row is oracle-checked (there are few; all of them, up
    # to 512, against the f64 oracle).
    if n_uncert:
        qs = np.concatenate([batches[w][rows] for w, rows in uncert], axis=0)
        nchk = min(512, n_uncert)
        sub_u = np.random.default_rng(3).choice(n_uncert, nchk, replace=False)
        recall_u = recall_at_1(patch_np[sub_u], qs[sub_u], refs)
    else:
        recall_u = 1.0
    log(f"[bench] recall@1 (all {min(512, n_uncert)} checked of {n_uncert} "
        f"patched uncertified rows): {recall_u}")

    value = qps if (
        recall == 1.0 and recall_rb == 1.0 and recall_u == 1.0
    ) else 0.0
    metric = "exact_1nn_qps_1M_refs_10k_queries_k3_1chip"
    if (N_REFS, N_QUERIES) != (1_000_000, 10_000):  # smoke-test override
        metric = f"exact_1nn_qps_{N_REFS}_refs_{N_QUERIES}_queries_k3_1chip"
    print(
        json.dumps(
            {
                "metric": metric,
                "value": round(value, 1),
                "unit": "queries/sec",
                "vs_baseline": round(value / BASELINE_QPS, 4),
            }
        ),
        flush=True,
    )

    # Secondary: full-queue results downloaded to host (in a pipelined
    # server this transfer overlaps the next drain, so it is reported but
    # not the headline). One device-side concat of flattened rows -> ONE
    # fetch instead of W; rows are ragged in QM, so concat, not stack.
    # Trials stop at the soft deadline; the warm-up download already proved
    # the path, so zero timed trials is tolerable.
    full_times = []
    for _ in range(6):
        if full_times and time.perf_counter() - t_script0 > SOFT_DEADLINE_S:
            log("[bench] soft deadline reached; truncating full-download trials")
            break
        t0 = time.perf_counter()
        out = engine.query_queue_staged(dq)
        full_np = np.asarray(jnp.concatenate([r.reshape(-1) for r in out]))
        full_times.append((time.perf_counter() - t0) / W * 1e3)
    full_best = min(full_times)
    log(
        f"[bench] with full {full_np.nbytes/1e6:.1f} MB result download: "
        f"{full_best:.2f} ms/batch -> {N_QUERIES/full_best*1e3:,.0f} qps"
    )
    # Answers of every drained batch must match the per-batch path (the
    # queue result is the serving answer, not a timing artifact). The
    # checked batch is drawn fresh each run so no fixed position can
    # mask a positional staging bug.
    b = int(np.random.default_rng().integers(W))
    idx_b, ok_b = engine.unscatter_queue(
        full_np[offs[b]:offs[b + 1]], fslots[b], orders[b])
    chk, okc = engine.query_with_flags(batches[b])
    assert np.array_equal(idx_b[ok_b], np.asarray(chk)[ok_b]), "queue/batch mismatch"

    # Secondary: serial per-request latency (staging + upload + single-batch
    # dispatch + fetch, nothing overlapped — the honest single-request number).
    serial_best = float("inf")
    for qb in batches[:4]:
        if (serial_best < float("inf")
                and time.perf_counter() - t_script0 > SOFT_DEADLINE_S):
            log("[bench] soft deadline reached; truncating serial trials")
            break
        t0 = time.perf_counter()
        packed, order, qm = engine.stage(qb)
        out = np.asarray(engine.query_staged(packed, qm))
        serial_best = min(serial_best, time.perf_counter() - t0)
    log(
        f"[bench] serial (staging incl): {serial_best*1e3:.2f} ms/batch "
        f"-> {N_QUERIES/serial_best:,.0f} qps"
    )

    return 0 if recall == 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
