"""Sharded supercell engine tests on the virtual 8-device mesh."""

import jax as _jax
import pytest as _pytest

pytestmark = _pytest.mark.skipif(
    len(_jax.devices()) < 2, reason="needs a multi-device mesh (virtual CPU devices)"
)

import numpy as np
import pytest

from conftest import assert_exact
from nns.data import make_dataset
from nns.parallel.mesh import make_mesh
from nns.parallel.sharded_cells import ShardedCellEngine, nns_sharded_cells


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_cells_exact(n_dev):
    q, r = make_dataset(3, 128, 16384, seed=1000)
    eng = ShardedCellEngine(r, make_mesh(n_dev))
    assert_exact(eng.query(q), q, r)


def test_sharded_cells_matches_single_chip():
    from nns.kernels.cell_list import CellListEngine

    q, r = make_dataset(3, 64, 8192, seed=2)
    single = CellListEngine(r).query(q)
    multi = ShardedCellEngine(r, make_mesh(8)).query(q)
    np.testing.assert_array_equal(single, multi)


def test_sharded_cells_group_padding():
    # D^3 typically not divisible by 8 — sentinel group padding must hold.
    q, r = make_dataset(3, 32, 8192, seed=3)
    eng = ShardedCellEngine(r, make_mesh(8), d_per_dim=3)  # G = 27
    assert eng.g_pad % 8 == 0
    assert_exact(eng.query(q), q, r)


def test_sharded_cells_certificate_fallback():
    _, r = make_dataset(3, 1, 8192, seed=4)
    r = r * np.float32(0.1)
    q = np.array([[0.9, 0.9, 0.9]], dtype=np.float32)
    eng = ShardedCellEngine(r, make_mesh(4))
    idx, ok = eng.query_with_flags(q)
    assert not ok.all()
    assert_exact(eng.query(q), q, r)


def test_nns_sharded_cells_wrapper():
    q, r = make_dataset(3, 64, 8192, seed=5)
    assert_exact(nns_sharded_cells(q, r, mesh=make_mesh(8)), q, r)
    # non-3-D routes to brute force
    q2, r2 = make_dataset(5, 16, 4096, seed=6)
    assert_exact(nns_sharded_cells(q2, r2, mesh=make_mesh(8)), q2, r2)


def test_sharded_queue_drain_matches_per_batch():
    # The sharded queue drain (one sharded program for W batches) must
    # agree with per-batch sharded queries and stay exact.
    import jax

    from nns.parallel.mesh import make_mesh
    from nns.parallel.sharded_cells import ShardedCellEngine

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    rng = np.random.default_rng(55)
    r = rng.random((32768, 3), dtype=np.float32)
    eng = ShardedCellEngine(r, make_mesh(8))
    batches = [rng.random((400, 3), dtype=np.float32) for _ in range(3)]
    out = eng.query_queue(batches)
    for qb, idx in zip(batches, out):
        np.testing.assert_array_equal(idx, eng.query(qb))
        assert_exact(idx, qb, r)
    # Mixed q_max at W >= 8 (VERDICT r3 item 3): skewed batches force a
    # different pow2 q_max tier; the canonical ragged drain must split the
    # queue into per-tier sub-drains (one all-gather each) and stay exact
    # per batch — a skewed batch can no longer inflate the uniform tier.
    # 10 uniform batches make the uniform tier decompose 8+2, so the
    # MULTI-BATCH stacked mesh program (w=8: jnp.stack + one tiled
    # all-gather + per-batch out[wi, :G] slicing) is what actually runs.
    def skew(m=400):
        return (rng.random((m, 3), dtype=np.float32) * 0.02).astype(np.float32)

    queue = [rng.random((400, 3), dtype=np.float32) for _ in range(10)]
    queue.insert(2, skew())
    queue.insert(5, skew())
    out2 = eng.query_queue(queue)
    for qb, idx in zip(queue, out2):
        np.testing.assert_array_equal(idx, eng.query(qb))
        assert_exact(idx, qb, r)


def test_sharded_submit_collect_pipeline():
    # Two tokens in flight (host staging of batch 2 overlaps batch 1's
    # device scan) must agree with the synchronous path and stay exact.
    rng = np.random.default_rng(60)
    r = rng.random((16384, 3), dtype=np.float32)
    eng = ShardedCellEngine(r, make_mesh(8))
    q1 = rng.random((300, 3), dtype=np.float32)
    q2 = rng.random((300, 3), dtype=np.float32)
    t1 = eng.query_submit(q1)
    t2 = eng.query_submit(q2)
    idx1, ok1 = eng.query_collect(t1)
    idx2, ok2 = eng.query_collect(t2)
    ref1, rok1 = eng.query_with_flags(q1)
    np.testing.assert_array_equal(idx1, ref1)
    np.testing.assert_array_equal(ok1, rok1)
    assert_exact(idx1[ok1], q1[ok1], r)
    assert_exact(idx2[ok2], q2[ok2], r)
    # Skewed batch: submit returns a no-certificate token, collect is all-bad.
    qs = (rng.random((2100, 3), dtype=np.float32) * 1e-4).astype(np.float32)
    ts = eng.query_submit(qs)
    _, oks = eng.query_collect(ts)
    assert not oks.any()


def test_sharded_save_load_roundtrip(tmp_path):
    # The sharded checkpoint is placement-free: it restores onto a
    # DIFFERENT mesh size and as a single-chip engine, bit-identically.
    from nns.kernels.cell_list import CellListEngine

    rng = np.random.default_rng(61)
    r = rng.random((16384, 3), dtype=np.float32)
    q = rng.random((256, 3), dtype=np.float32)
    eng = ShardedCellEngine(r, make_mesh(4))
    want = eng.query(q)
    p = str(tmp_path / "cells.npz")
    eng.save(p)
    re8 = ShardedCellEngine.load(p, make_mesh(8))
    assert re8.g_pad % 8 == 0
    np.testing.assert_array_equal(re8.query(q), want)
    single = CellListEngine.load(p)
    np.testing.assert_array_equal(single.query(q), want)
    assert_exact(want, q, r)


def test_sharded_query_topk_inherited_exact():
    # query_topk is inherited from the single-chip engine: the jitted
    # device path consumes the mesh-sharded halo tensors through GSPMD
    # (XLA inserts the gather), and the padded sentinel groups past G are
    # never indexed (the dense scatter and grid are sized by G = D^3).
    # Pin exactness on a padded mesh (G=27, g_pad=32).
    rng = np.random.default_rng(62)
    r = rng.random((16384, 3), dtype=np.float32)
    q = rng.random((64, 3), dtype=np.float32)
    eng = ShardedCellEngine(r, make_mesh(8), d_per_dim=3)
    assert eng.g_pad != eng.D ** 3
    d2, idx = eng.query_topk(q, 4)
    dd = ((q[:, None, :].astype(np.float64) - r[None].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_allclose(
        np.sort(d2, axis=1), np.sort(dd, axis=1)[:, :4], rtol=1e-5, atol=1e-7
    )
    rows = np.arange(q.shape[0])[:, None]
    got = dd[rows, idx]
    np.testing.assert_allclose(np.sort(got, 1), np.sort(dd, 1)[:, :4], rtol=1e-5, atol=1e-7)


def test_sharded_collect_dist_matches_single_chip():
    from nns.kernels.cell_list import CellListEngine

    q, r = make_dataset(3, 128, 16384, seed=11)
    s_idx, s_ok, s_d2 = CellListEngine(r).query_with_flags_dist(q)
    m_idx, m_ok, m_d2 = ShardedCellEngine(r, make_mesh(8)).query_with_flags_dist(q)
    s_ok, s_idx, s_d2 = np.asarray(s_ok), np.asarray(s_idx), np.asarray(s_d2)
    np.testing.assert_array_equal(s_ok, m_ok)
    np.testing.assert_array_equal(s_idx[s_ok], m_idx[s_ok])
    np.testing.assert_allclose(m_d2[s_ok], s_d2[s_ok], rtol=1e-5)
    # Every sharded d2 — certified or not — upper-bounds the true NN
    # distance (it is the f32 distance to a real reference point).
    d_true = (
        ((q[:, None, :].astype(np.float64) - r[None].astype(np.float64)) ** 2)
        .sum(-1)
        .min(1)
    )
    assert (m_d2.astype(np.float64) >= d_true - 1e-7).all()


def test_sharded_collect_dist_uncertified_rows():
    # Far-out-of-box query: uncertified, but d2 must still bound the truth
    # and idx must come back decoded (never sign-encoded).
    _, r = make_dataset(3, 1, 8192, seed=4)
    r = r * np.float32(0.1)
    q = np.array([[0.9, 0.9, 0.9]], dtype=np.float32)
    idx, ok, d2 = ShardedCellEngine(r, make_mesh(4)).query_with_flags_dist(q)
    assert not ok.all()
    assert (idx >= 0).all()
    d_true = ((q.astype(np.float64) - r.astype(np.float64)) ** 2).sum(-1).min()
    assert d2[0] >= d_true - 1e-9


def test_sharded_queue_drain_bounds_traces():
    """Sharded twin of test_query_queue_canonical_drain_bounds_traces
    (VERDICT r4 #6): the canonical drain's compiled-program universe —
    q_max tiers x _CHUNK_LADDER, at most 45 keys per engine geometry —
    must fit _build_scan_queue's cache with headroom, and a mixed-q_max,
    ladder-crossing queue permuted two ways must mint ZERO new mesh
    programs on later passes (an LRU eviction here re-traces a
    minutes-long sharded program mid-serving)."""
    from nns.kernels.cell_list import CellListEngine
    from nns.parallel.sharded_cells import _build_scan_queue

    ladder = len(CellListEngine._CHUNK_LADDER)
    assert _build_scan_queue.cache_parameters()["maxsize"] >= 9 * ladder * 2

    rng = np.random.default_rng(77)
    r = rng.random((8192, 3), dtype=np.float32)
    eng = ShardedCellEngine(r, make_mesh(4))

    def uni(m=64):
        return rng.random((m, 3), dtype=np.float32)

    def skew(m=64):
        return (rng.random((m, 3), dtype=np.float32) * 0.02).astype(np.float32)

    # Warm the sub-8 ladder (8+4+2+1 = 15 batches) for both tiers; later
    # queues REUSE these pool arrays so no fresh draw can mint a new tier.
    pool_u = [uni() for _ in range(15)]
    pool_s = [skew() for _ in range(15)]
    eng.query_queue(pool_u + pool_s)
    warm = _build_scan_queue.cache_info().currsize

    queue_a = [pool_u[0], pool_s[0], pool_u[1], pool_u[2], pool_s[1]]
    res_a = eng.query_queue(queue_a)
    assert _build_scan_queue.cache_info().currsize == warm
    # Same multiset, permuted: zero new programs, identical answers.
    perm = [4, 1, 0, 3, 2]
    res_b = eng.query_queue([queue_a[i] for i in perm])
    assert _build_scan_queue.cache_info().currsize == warm
    for i, j in enumerate(perm):
        np.testing.assert_array_equal(res_b[i], res_a[j])
    # A novel per-tier composition: still zero new programs, still exact.
    queue_c = [pool_u[3], pool_s[2], pool_s[3], pool_u[4], pool_u[5]]
    res_c = eng.query_queue(queue_c)
    assert _build_scan_queue.cache_info().currsize == warm
    for qb, idx in zip(queue_c, res_c):
        assert_exact(idx, qb, r)
