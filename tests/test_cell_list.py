"""Supercell engine tests: exactness on uniform + adversarial data, fallback
certificate, dispatch contract."""

import numpy as np
import pytest

from conftest import assert_exact
from nns.data import make_dataset
from nns.kernels.cell_list import CellListEngine, nns_cell_list


@pytest.mark.parametrize("m,n", [(64, 8192), (200, 32768), (1, 8192)])
def test_cell_list_exact(m, n):
    q, r = make_dataset(3, m, n, seed=1000)
    assert_exact(nns_cell_list(q, r), q, r)


def test_cell_list_engine_reuse():
    q, r = make_dataset(3, 128, 16384, seed=1)
    eng = CellListEngine(r)
    assert_exact(eng.query(q), q, r)
    assert_exact(eng.query(q[:16]), q[:16], r)


def test_cell_list_far_query_fallback():
    # Query far outside the data cloud: certificate fails (best > halo),
    # exact fallback must kick in.
    _, r = make_dataset(3, 1, 8192, seed=2)
    r = r * np.float32(0.1)  # compress cloud
    q = np.array([[0.95, 0.95, 0.95]], dtype=np.float32)
    eng = CellListEngine(r)
    idx, ok = eng.query_with_flags(q)
    assert not ok.all()  # certificate correctly rejects
    assert_exact(eng.query(q), q, r)


def test_cell_list_empty_supercell():
    # Points only in one corner; queries in empty regions still exact.
    rng = np.random.default_rng(3)
    r = (rng.random((8192, 3)) * 0.3).astype(np.float32)
    q = rng.random((32, 3)).astype(np.float32)
    assert_exact(nns_cell_list(q, r), q, r)


def test_cell_list_duplicate_lowest_index():
    rng = np.random.default_rng(4)
    r = rng.random((8192, 3), dtype=np.float32)
    target = np.array([0.5, 0.5, 0.5], dtype=np.float32)
    for w in (11, 4000, 8000):
        r[w] = target
    q = target[None, :]
    assert CellListEngine(r).query(q)[0] == 11


def test_cell_list_clustered_overflow_guard():
    # Extremely clustered data must either work exactly or raise the
    # overflow guard (and the wrapper falls back to the fused kernel).
    rng = np.random.default_rng(5)
    r = (rng.normal(0, 0.001, (8192, 3)) + 0.5).astype(np.float32)
    q = rng.random((16, 3)).astype(np.float32)
    assert_exact(nns_cell_list(q, r), q, r)


def test_cell_list_non_3d_routes_to_fused():
    q, r = make_dataset(5, 16, 8192, seed=6)
    assert_exact(nns_cell_list(q, r), q, r)


def test_cell_list_save_load(tmp_path):
    from nns.kernels.cell_list import CellListEngine

    q, r = make_dataset(3, 32, 8192, seed=7)
    eng = CellListEngine(r)
    path = str(tmp_path / "cells.npz")
    eng.save(path)
    loaded = CellListEngine.load(path)
    np.testing.assert_array_equal(eng.query(q), loaded.query(q))


def test_cell_list_oversized_halo_clamped_stays_exact():
    # halo > supercell width would make the halo-set enumeration skip
    # middle cells; the engine must clamp it and stay exact (certificate
    # rejects what it cannot prove).
    from nns.kernels.cell_list import CellListEngine

    q, r = make_dataset(3, 64, 8192, seed=9)
    eng = CellListEngine(r, d_per_dim=12, halo=0.5)
    assert eng.halo <= eng.W.min() + 1e-12
    assert_exact(eng.query(q), q, r)


def test_cell_list_skewed_batch_guard():
    # All queries in one supercell: q_max would exceed q_max_limit();
    # stage() must refuse and query() must fall back exactly.
    from nns.kernels.cell_list import CellListEngine

    rng = np.random.default_rng(10)
    r = rng.random((32768, 3), dtype=np.float32)
    eng = CellListEngine(r)
    m = eng.q_max_limit() * 2
    q = (np.float32(0.5) + rng.random((m, 3), dtype=np.float32) * np.float32(1e-4))
    packed, order, q_max = eng.stage(q)
    assert packed is None and q_max is None
    idx = eng.query(q)
    assert_exact(idx[:64], q[:64], r)  # subsample keeps the oracle cheap


def test_query_dist_upper_bounds_true_nn():
    # best_d2 from the scan kernel must upper-bound each query's true NN
    # distance whenever its halo set is nonempty (downstream consumers size
    # adaptive structures from it).
    from nns.kernels.cell_list import CellListEngine

    q, r = make_dataset(3, 128, 16384, seed=14)
    eng = CellListEngine(r)
    idx, ok, d2 = eng.query_with_flags_dist(q)
    true_d2 = np.min(
        np.sum((q[:, None, :].astype(np.float64) - r[None].astype(np.float64)) ** 2, axis=-1),
        axis=1,
    )
    finite = np.isfinite(d2)
    assert finite.any()
    assert (d2[finite] >= true_d2[finite] - 1e-9).all()


def test_cell_list_topk_matches_oracle():
    from nns.kernels.cell_list import CellListEngine

    q, r = make_dataset(3, 64, 16384, seed=16)
    eng = CellListEngine(r)
    d2, idx = eng.query_topk(q, 8)
    d_oracle = np.sort(
        np.sum((q[:, None, :].astype(np.float64) - r[None].astype(np.float64)) ** 2, axis=-1),
        axis=1,
    )[:, :8]
    d_ours = np.sum((q[:, None, :].astype(np.float64) - r[idx].astype(np.float64)) ** 2, axis=-1)
    np.testing.assert_allclose(np.sort(d_ours, axis=1), d_oracle, rtol=1e-5, atol=1e-9)
    assert (np.diff(d2, axis=1) >= 0).all()


def test_cell_list_topk_fallback_when_k_exceeds_halo():
    from nns.kernels.cell_list import CellListEngine

    q, r = make_dataset(3, 16, 8192, seed=17)
    eng = CellListEngine(r)
    k = 64  # k-th NN far beyond the halo radius -> certificate fails
    d2, idx = eng.query_topk(q, k)
    d_oracle = np.sort(
        np.sum((q[:, None, :].astype(np.float64) - r[None].astype(np.float64)) ** 2, axis=-1),
        axis=1,
    )[:, :k]
    d_ours = np.sum((q[:, None, :].astype(np.float64) - r[idx].astype(np.float64)) ** 2, axis=-1)
    np.testing.assert_allclose(np.sort(d_ours, axis=1), d_oracle, rtol=1e-5, atol=1e-9)


def test_beam_promotion_clustered_coverage():
    """VERDICT r1 #3: uniform queries over clustered refs defeat the fixed
    halo certificate (~18% coverage at 1M); the adaptive-depth octree beam
    index must certify >= 95% of them."""
    from nns.trees.beam import octree_beam_index
    from nns.trees.octree import Octree

    _, r = make_dataset(3, 1, 120_000, seed=5, clustered=True)
    rng = np.random.default_rng(42)
    q = (rng.random((512, 3), dtype=np.float32) * (r.max(0) - r.min(0)) + r.min(0)).astype(np.float32)
    bi = octree_beam_index(Octree.build(r))
    idx, cov = bi.query_with_coverage(q)
    assert_exact(idx, q, r)
    assert cov >= 0.95, f"beam coverage {cov} < 0.95"


def test_nnengine_promotes_to_beam_on_clustered():
    """NNEngine(v14) must promote CellListEngine -> octree BeamIndex when
    the fixed-halo certificate misses a batch, and stay exact throughout."""
    from nns.api import NNEngine
    from nns.trees.beam import BeamIndex

    _, r = make_dataset(3, 1, 120_000, seed=6, clustered=True)
    rng = np.random.default_rng(7)
    q = (rng.random((256, 3), dtype=np.float32) * (r.max(0) - r.min(0)) + r.min(0)).astype(np.float32)
    eng = NNEngine(14).build(r)
    idx1 = eng.query(q)
    assert_exact(idx1, q, r)
    assert isinstance(eng._built, BeamIndex)  # promoted after batch 1
    q2 = (rng.random((256, 3), dtype=np.float32) * (r.max(0) - r.min(0)) + r.min(0)).astype(np.float32)
    idx2 = eng.query(q2)
    assert_exact(idx2, q2, r)
    _, cov = eng._built.query_with_coverage(q2)
    assert cov >= 0.95


def test_beam_topk_clustered_matches_oracle():
    # Exact k-NN through the promoted beam index (the clustered-workload
    # k-NN path; certificate-gated with chunked-scan fallback).
    from nns.trees.beam import octree_beam_index
    from nns.trees.octree import Octree

    _, r = make_dataset(3, 1, 50_000, seed=8, clustered=True)
    rng = np.random.default_rng(9)
    q = (rng.random((64, 3), dtype=np.float32) * (r.max(0) - r.min(0)) + r.min(0)).astype(np.float32)
    bi = octree_beam_index(Octree.build(r))
    d2, idx = bi.query_topk(q, 8)
    d_oracle = np.sort(
        np.sum((q[:, None, :].astype(np.float64) - r[None].astype(np.float64)) ** 2, axis=-1),
        axis=1,
    )[:, :8]
    d_ours = np.sum((q[:, None, :].astype(np.float64) - r[idx].astype(np.float64)) ** 2, axis=-1)
    np.testing.assert_allclose(np.sort(d_ours, axis=1), d_oracle, rtol=1e-5, atol=1e-9)
    assert (np.diff(d2, axis=1) >= 0).all()
    # No duplicate ids within a row (pad replicas must be masked out).
    for row in idx:
        assert len(set(row.tolist())) == len(row)


def test_query_queue_matches_single_batch():
    # The W-batch queue dispatch must agree exactly with per-batch queries.
    from nns.kernels.cell_list import CellListEngine

    rng = np.random.default_rng(30)
    r = rng.random((32768, 3), dtype=np.float32)
    eng = CellListEngine(r)
    batches = [rng.random((500, 3), dtype=np.float32) for _ in range(3)]
    dstack, fstack, orders = eng.stage_queue(batches)
    out = np.asarray(eng.query_queue_staged(dstack))
    # The slice-free tuple drain (the bench headline path) must produce
    # identical rows to the stacked drain.
    out_t = eng.query_queue_staged(tuple(dstack))
    assert isinstance(out_t, tuple) and len(out_t) == len(batches)
    np.testing.assert_array_equal(out, np.stack([np.asarray(o) for o in out_t]))
    for w, qb in enumerate(batches):
        idx_q, ok_q = eng.unscatter_queue(out[w], fstack[w], orders[w])
        idx_single, ok_single = eng.query_with_flags(qb)
        np.testing.assert_array_equal(ok_q, ok_single)
        np.testing.assert_array_equal(idx_q[ok_q], idx_single[ok_single])
        assert_exact(idx_q[ok_q], qb[ok_q], r)


def test_ragged_queue_mixed_q_max_matches_single_batch():
    # stage_queue_ragged keeps per-batch pow2 q_max: a skewed batch (a
    # concentrated cluster forcing a larger q_max) must not inflate the
    # other batches' tensors, and the mixed-shape tuple drain must agree
    # exactly with per-batch queries.
    from nns.kernels.cell_list import CellListEngine

    rng = np.random.default_rng(31)
    r = rng.random((32768, 3), dtype=np.float32)
    eng = CellListEngine(r)
    uniform = [rng.random((400, 3), dtype=np.float32) for _ in range(2)]
    # One batch concentrated in a tiny corner box -> many queries share a
    # supercell -> q_max far above the uniform batches'.
    skewed = (rng.random((400, 3), dtype=np.float32) * 0.02).astype(np.float32)
    batches = [uniform[0], skewed, uniform[1]]
    denses, fslots, orders = eng.stage_queue_ragged(batches)
    assert denses is not None
    qms = [d.shape[1] for d in denses]
    assert qms[1] > qms[0], "skewed batch should need a larger q_max"
    assert qms[0] == qms[2], "uniform batches must keep their small q_max"
    out = eng.query_queue_staged(tuple(denses))
    assert isinstance(out, tuple) and len(out) == 3
    for w, qb in enumerate(batches):
        idx_q, ok_q = eng.unscatter_queue(np.asarray(out[w]), fslots[w], orders[w])
        idx_single, ok_single = eng.query_with_flags(qb)
        np.testing.assert_array_equal(ok_q, ok_single)
        np.testing.assert_array_equal(idx_q[ok_q], idx_single[ok_single])
        assert_exact(idx_q[ok_q], qb[ok_q], r)


def test_query_queue_serving_path_with_skewed_batch():
    # The public serving drain (query_queue) now stages ragged: a skewed
    # batch in the queue must still produce EXACT answers for every batch
    # and sane coverage, without falling back to per-batch querying.
    from nns.kernels.cell_list import CellListEngine

    rng = np.random.default_rng(32)
    r = rng.random((32768, 3), dtype=np.float32)
    eng = CellListEngine(r)
    batches = [
        rng.random((300, 3), dtype=np.float32),
        (rng.random((300, 3), dtype=np.float32) * 0.02).astype(np.float32),
        rng.random((300, 3), dtype=np.float32),
    ]
    results, covs = eng.query_queue(batches, return_coverage=True)
    assert len(results) == 3 and len(covs) == 3
    for qb, idx in zip(batches, results):
        assert_exact(idx, qb, r)
    for cov in covs:
        assert 0.0 <= cov <= 1.0


def test_query_queue_canonical_drain_bounds_traces():
    """Serving safety (VERDICT round 3 item 2): two queues with the same
    q_max multiset in different orders must reuse the same compiled
    programs (zero new traces), and a NOVEL composition must also add no
    trace once its tiers' chunk programs exist — the compiled-program
    universe is bounded by tiers x _CHUNK_LADDER, never by queue
    composition or order. (Reference analog: core.cu:1900-1933's warm-up
    exists so steady-state serving never pays init cost; a minutes-long
    mid-serving recompile violates that contract.)"""
    from nns.kernels.cell_list import (
        CellListEngine,
        _device_query_queue_seq,
    )

    rng = np.random.default_rng(33)
    r = rng.random((32768, 3), dtype=np.float32)
    eng = CellListEngine(r)

    def uni(m=200):
        return rng.random((m, 3), dtype=np.float32)

    def skew(m=200):
        return (rng.random((m, 3), dtype=np.float32) * 0.02).astype(np.float32)

    # Warm every sub-8 ladder size (8+4+2+1 = 15 batches) for BOTH tiers:
    # after this, any queue whose per-tier counts are <= 15 decomposes
    # into already-traced chunk programs. Later queues REUSE these pool
    # arrays — a batch's qm tier depends on its content (slot occupancy),
    # so fresh draws could mint a new tier and make the zero-trace
    # assertion flaky.
    pool_u = [uni() for _ in range(15)]
    pool_s = [skew() for _ in range(15)]
    eng.query_queue(pool_u + pool_s)
    size_warm = _device_query_queue_seq._cache_size()

    queue_a = [pool_u[0], pool_u[1], pool_s[0], pool_u[2], pool_u[3]]
    res_a = eng.query_queue(queue_a)
    assert _device_query_queue_seq._cache_size() == size_warm
    # Same multiset, permuted order: zero new traces, identical answers.
    perm = [2, 0, 4, 1, 3]
    res_b = eng.query_queue([queue_a[i] for i in perm])
    assert _device_query_queue_seq._cache_size() == size_warm
    for i, j in enumerate(perm):
        np.testing.assert_array_equal(res_b[i], res_a[j])
    # A novel mix (different per-tier counts): still zero new traces,
    # still exact.
    queue_c = [pool_u[4], pool_s[1], pool_s[2], pool_u[5], pool_u[6],
               pool_u[7], pool_u[8]]
    res_c = eng.query_queue(queue_c)
    assert _device_query_queue_seq._cache_size() == size_warm
    for qb, idx in zip(queue_c, res_c):
        assert_exact(idx, qb, r)
    # A DIFFERENT batch size is its own tier family: its ladder warms
    # once (8+4+2+1), after which any count <= 15 adds nothing.
    pool_d = [uni(100) for _ in range(15)]
    eng.query_queue(pool_d)
    size_after_d = _device_query_queue_seq._cache_size()
    eng.query_queue(pool_d[:9])
    eng.query_queue(pool_d[2:12])
    assert _device_query_queue_seq._cache_size() == size_after_d


def test_beam_checkpoint_roundtrip(tmp_path):
    # A clustered-promoted v14 engine must checkpoint as a beam index and
    # load back through NNEngine.load's format sniffing.
    from nns.api import NNEngine
    from nns.trees.beam import BeamIndex

    _, r = make_dataset(3, 1, 120_000, seed=9, clustered=True)
    rng = np.random.default_rng(11)
    q = (rng.random((128, 3), dtype=np.float32) * (r.max(0) - r.min(0)) + r.min(0)).astype(np.float32)
    eng = NNEngine(14).build(r)
    idx1 = eng.query(q)           # promotes to BeamIndex
    assert isinstance(eng._built, BeamIndex)
    path = str(tmp_path / "v14_beam.npz")
    eng.save(path)
    eng2 = NNEngine.load(path, version=14)
    assert isinstance(eng2._built, BeamIndex)
    idx2 = eng2.query(q)
    np.testing.assert_array_equal(np.asarray(idx1), np.asarray(idx2))
    assert_exact(idx2, q, r)


def test_ids_above_2_24_transit_exactly():
    # n >= 2^24 support (VERDICT round 3 item 7): ids ride the packed f32
    # result as hi/lo 12-bit columns. Simulate a big-n id space by offsetting
    # the halo id table past 2^24 — every certified answer must come back
    # with the exact offset id (a plain f32 astype would corrupt these).
    import jax
    import jax.numpy as jnp

    from nns.kernels.cell_list import CellListEngine

    rng = np.random.default_rng(77)
    r = rng.random((8192, 3), dtype=np.float32)
    eng = CellListEngine(r)
    q = rng.random((256, 3), dtype=np.float32)
    idx1, ok1 = eng.query_with_flags(q)
    OFF = (1 << 24) + 12345
    eng.halo_ids_dev = jax.device_put(jnp.asarray(eng.halo_ids + OFF))
    idx2, ok2 = eng.query_with_flags(q)
    np.testing.assert_array_equal(ok1, ok2)
    np.testing.assert_array_equal(
        idx2[ok2].astype(np.int64) - OFF, idx1[ok1].astype(np.int64)
    )
    # Queue path: dense i32 winners carry the same offset ids exactly.
    batches = [q, rng.random((256, 3), dtype=np.float32)]
    dstack, fstack, orders = eng.stage_queue(batches)
    out = np.asarray(eng.query_queue_staged(dstack))
    idx_q, ok_q = eng.unscatter_queue(out[0], fstack[0], orders[0])
    np.testing.assert_array_equal(
        idx_q[ok_q].astype(np.int64) - OFF, idx1[ok1].astype(np.int64)
    )


def test_odd_d_engine_group_batch_divisor():
    # D odd means G = D^3 is odd (no power-of-two factor at all): the scan
    # must cover every supercell, one winner per (supercell, slot), and stay
    # exact on both the per-batch and the queue-drain paths.
    from nns.kernels import cell_list as cl

    rng = np.random.default_rng(31)
    r = rng.random((20000, 3), dtype=np.float32)
    eng = cl.CellListEngine(r, d_per_dim=9)
    assert eng.D == 9  # G = 729 = 3^6
    q = rng.random((400, 3), dtype=np.float32)
    idx, ok = eng.query_with_flags(q)
    assert_exact(idx[ok], q[ok], r)
    denses, _, _ = eng.stage_queue_ragged([q])
    (rows,) = eng.query_queue_staged(tuple(denses))
    assert rows.shape == (729, denses[0].shape[1])
    (idx_q,) = eng.query_queue([q])
    assert_exact(idx_q, q, r)
