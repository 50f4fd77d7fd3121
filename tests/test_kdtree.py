"""KD-tree tests (v10/v11 analogs): build invariants, exactness vs the f64
oracle, host/device agreement, persistence (SURVEY.md §4 items 3-4)."""

import numpy as np
import pytest

from conftest import assert_exact
from nns.data import make_dataset
from nns.trees.kdtree import KDTree, nns_kdtree_host
from nns.trees.kdtree_device import nns_kdtree_device


def test_build_invariants():
    q, r = make_dataset(k=3, m=1, n=1000, seed=2)
    tree = KDTree.build(r)
    np_, nd = tree.node_point, tree.node_dim
    # Every reference point appears exactly once in the heap.
    stored = np_[np_ >= 0]
    assert sorted(stored.tolist()) == list(range(1000))
    # Median property: left subtree <= node value, right subtree >= node
    # value along the split dim, for every internal node.
    def collect(rt):
        if rt >= len(np_) or np_[rt] < 0:
            return []
        return [np_[rt]] + collect(2 * rt) + collect(2 * rt + 1)

    def check(rt):
        if rt >= len(np_) or np_[rt] < 0:
            return
        d, v = nd[rt], r[np_[rt], nd[rt]]
        left, right = collect(2 * rt), collect(2 * rt + 1)
        assert all(r[i, d] <= v + 1e-7 for i in left), f"node {rt}"
        assert all(r[i, d] >= v - 1e-7 for i in right), f"node {rt}"
        check(2 * rt)
        check(2 * rt + 1)

    check(1)


@pytest.mark.parametrize("k,m,n", [(3, 1, 1024), (3, 200, 4096), (16, 64, 2048), (2, 50, 333)])
def test_kdtree_host_exact(k, m, n):
    q, r = make_dataset(k, m, n, seed=1000)
    assert_exact(nns_kdtree_host(q, r), q, r)


@pytest.mark.parametrize("k,m,n", [(3, 1, 1024), (3, 200, 4096), (16, 64, 2048)])
def test_kdtree_device_exact(k, m, n):
    q, r = make_dataset(k, m, n, seed=1000)
    assert_exact(nns_kdtree_device(q, r), q, r)


def test_kdtree_clustered_data():
    q, r = make_dataset(3, 128, 8192, seed=4, clustered=True)
    assert_exact(nns_kdtree_host(q, r), q, r)
    assert_exact(nns_kdtree_device(q, r), q, r)


def test_kdtree_duplicate_points():
    rng = np.random.default_rng(0)
    r = np.repeat(rng.random((64, 3), dtype=np.float32), 4, axis=0)
    q = rng.random((32, 3), dtype=np.float32).astype(np.float32)
    assert_exact(nns_kdtree_host(q, r), q, r)
    assert_exact(nns_kdtree_device(q, r), q, r)


def test_kdtree_k_fallback():
    # k > 16 falls back to the linear scan (core.cu:1148-1149 contract).
    q, r = make_dataset(20, 16, 512, seed=6)
    assert_exact(nns_kdtree_host(q, r), q, r)
    assert_exact(nns_kdtree_device(q, r), q, r)


def test_kdtree_save_load(tmp_path):
    q, r = make_dataset(3, 32, 1024, seed=8)
    tree = KDTree.build(r)
    path = str(tmp_path / "kd.npz")
    tree.save(path)
    loaded = KDTree.load(path)
    np.testing.assert_array_equal(tree.query_host(q), loaded.query_host(q))


def test_kdtree_tiny():
    r = np.array([[0.5, 0.5, 0.5]], dtype=np.float32)
    q = np.array([[0.1, 0.9, 0.3]], dtype=np.float32)
    assert nns_kdtree_host(q, r)[0] == 0
    assert nns_kdtree_device(q, r)[0] == 0


def test_kdtree_device_tiny_beam_fallback_exact():
    # A beam of 1 bucket leaves most queries uncertified; results must stay
    # exact via the wider-retry / brute-force fallback chain.
    from nns.trees.kdtree import KDTree
    from nns.trees.kdtree_device import kd_query_device

    q, r = make_dataset(3, 32, 2048, seed=11)
    tree = KDTree.build(r)
    idx = kd_query_device(tree, q, beam=1)
    assert_exact(idx, q, r)


def test_beam_staged_chunked_drain():
    # The serving drain: a query set wider than one chunk must run as ONE
    # device program (lax.map over staged chunks, not one dispatch per
    # chunk), with certified rows
    # matching the oracle and query_exact unconditionally exact.
    q, r = make_dataset(3, 2500, 20000, seed=8)
    bi = KDTree.build(r).device_index()
    st = bi.stage_queries(q)
    assert st.q_dev.shape[0] > 1  # genuinely multi-chunk
    idx, ok = bi.query_staged_with_flags(st)
    assert ok.mean() > 0.9
    d_got = ((q.astype(np.float64) - r[idx].astype(np.float64)) ** 2).sum(1)
    d_true = (
        (q[:, None, :].astype(np.float64) - r[None].astype(np.float64)) ** 2
    ).sum(-1).min(1)
    assert (d_got[ok] == d_true[ok]).all()  # certified rows are true NNs
    # The one-dispatch form agrees with the unstaged public surface.
    idx2, ok2 = bi.query_with_flags(q)
    np.testing.assert_array_equal(idx, idx2)
    np.testing.assert_array_equal(ok, ok2)
    assert_exact(bi.query_exact(q), q, r)


def _clustered_16d(seed: int, n: int, m: int):
    rng = np.random.default_rng(seed)
    _, r = make_dataset(16, 1, n, seed=seed, clustered=True)
    base = r[rng.integers(0, n, size=m)]
    q = (base + rng.normal(0, 0.01, size=base.shape)).astype(np.float32)
    return q, r


def test_beam_chunk_scan_certified_rows_exact():
    # The round-5 chunk-scan drain: one shared budget-bucket candidate set
    # per locality-sorted chunk + the exact fused scan. Certified rows must
    # be true NNs (f64 oracle), the staging sort must be invisible (answers
    # in caller order), and coverage must be high in-distribution.
    q, r = _clustered_16d(11, 32768, 3000)
    bi = KDTree.build(r).device_index()
    assert bi.desc_dim is not None
    st = bi.stage_queries(q)
    assert st.perm is not None  # locality sort engaged
    budget = min(32, bi.lo.shape[0] // 2)
    idx, ok = bi.query_staged_scan_with_flags(st, budget)
    assert ok.mean() > 0.9
    d_got = ((q.astype(np.float64) - r[idx].astype(np.float64)) ** 2).sum(1)
    d_true = (
        (q[:, None, :].astype(np.float64) - r[None].astype(np.float64)) ** 2
    ).sum(-1).min(1)
    assert (d_got[ok] == d_true[ok]).all()
    # The full serving path (scan base + beam retry + exact fallback) is
    # unconditionally exact.
    idx2, cov = bi.query_staged_with_coverage(st, beam=16, budget=budget)
    assert cov > 0.9
    assert_exact(idx2, q, r)


def test_beam_chunk_scan_tiny_budget_stays_exact():
    # A starved budget collapses coverage, never correctness: uncertified
    # rows flow through the beam retry and the exact fallback.
    q, r = _clustered_16d(13, 16384, 700)
    bi = KDTree.build(r).device_index()
    idx, cov = bi.query_staged_with_coverage(
        bi.stage_queries(q), beam=8, budget=2
    )
    assert_exact(idx, q, r)


def test_beam_home_buckets_follow_descent():
    # Every point's home bucket must contain... at minimum be a valid
    # frontier id, and in-distribution queries of one blob should land in
    # few distinct buckets (the locality the chunk-scan sort relies on).
    q, r = _clustered_16d(17, 16384, 400)
    bi = KDTree.build(r).device_index()
    hb = bi.home_buckets(q)
    assert hb.min() >= 0 and hb.max() < bi.lo.shape[0]
    # points of the same blob (queries are blob samples) concentrate:
    # far fewer distinct home buckets than queries.
    assert len(np.unique(hb)) < len(q) // 2


def test_kdtree_beam_certificate_coverage():
    # On uniform data the default beam should certify nearly every query
    # (the perf contract: fallback scans must be the rare path).
    from nns.trees.kdtree import KDTree

    q, r = make_dataset(3, 256, 65536, seed=12)
    tree = KDTree.build(r)
    idx, ok = tree.device_index().query_with_flags(q, beam=8)
    assert ok.mean() >= 0.95
    assert_exact(tree.device_index().query_exact(q), q, r)
