"""Native C++ layer tests: build, agreement with numpy implementations,
exactness through the tree machinery."""

import numpy as np
import pytest

from conftest import assert_exact
from nns.data import make_dataset
from nns.native import (
    ensure_built,
    native_available,
    native_kd_build,
    native_linear_scan,
    native_octree_build,
)


pytestmark = pytest.mark.skipif(
    not (ensure_built() and native_available()), reason="native lib unavailable"
)


def test_native_scan_matches_numpy():
    from nns.kernels.oracle import _linear_scan_numpy

    q, r = make_dataset(3, 100, 4096, seed=1)
    np.testing.assert_array_equal(native_linear_scan(q, r), _linear_scan_numpy(q, r))


def test_native_scan_exact_16d():
    q, r = make_dataset(16, 64, 2048, seed=2)
    assert_exact(native_linear_scan(q, r), q, r)


def test_native_kd_build_queries_exact():
    from nns.trees.kdtree import KDTree, _heap_size

    q, r = make_dataset(3, 128, 4096, seed=3)
    native = native_kd_build(r)
    assert native is not None
    perm, dims = native
    heap_len = _heap_size(r.shape[0])
    node_point = np.full(heap_len, -1, dtype=np.int32)
    node_dim = np.zeros(heap_len, dtype=np.int32)
    node_point[: len(perm)] = perm
    node_dim[: len(dims)] = dims
    stored = node_point[node_point >= 0]
    assert sorted(stored.tolist()) == list(range(r.shape[0]))
    tree = KDTree(r, node_point, node_dim, depth=16)
    assert_exact(tree.query_host(q), q, r)
    assert_exact(tree.query_device(q), q, r)


def test_native_octree_build_queries_exact():
    from nns.trees.octree import Octree

    q, r = make_dataset(3, 128, 4096, seed=4)
    tree = Octree.build(r)  # routes through native when available
    assert_exact(tree.query_host(q), q, r)
    assert_exact(tree.query_device(q), q, r)
    # Leaf ranges still partition all points.
    is_leaf = tree.children.max(axis=1) < 0
    assert tree.count[is_leaf].sum() == r.shape[0]


def test_native_vs_numpy_octree_same_leaf_partition():
    from nns.trees.octree import Octree

    _, r = make_dataset(3, 1, 2048, seed=5)
    nat = Octree.build(r)
    ref = Octree._build_numpy(r)
    # Same total leaf mass and same point-containment invariant; node ids
    # may differ (DFS vs BFS numbering).
    for t in (nat, ref):
        for nid in range(len(t.radius)):
            s, c = t.start[nid], t.count[nid]
            pts = t.refs[t.order[s : s + c]]
            assert (np.abs(pts - t.center[nid]) <= t.radius[nid] + 1e-5).all()


def test_native_cells_build_same_halo_sets():
    # Native and numpy builds may order slots within a group differently;
    # the SETS per group must match exactly.
    from nns.data import make_dataset
    from nns.kernels.cell_list import CellListEngine

    _, r = make_dataset(3, 1, 20000, seed=7)
    eng = CellListEngine(r, device_place=False)  # native path (lib built)
    hp, hi, cnt = eng._build_numpy_halos(np.ascontiguousarray(r, np.float32), 200_000)
    native_pts = np.swapaxes(np.asarray(eng.halo_dm), 1, 2)
    assert native_pts.shape == hp.shape
    for g in range(0, hp.shape[0], max(1, hp.shape[0] // 64)):
        n_real = int(cnt[g])
        ids_numpy = sorted(hi[g, :n_real].tolist())
        ids_native = sorted(eng.halo_ids[g, :n_real].tolist())
        assert ids_numpy == ids_native, f"group {g}"


def test_native_cells_build_query_exact():
    from conftest import assert_exact
    from nns.data import make_dataset
    from nns.kernels.cell_list import CellListEngine

    q, r = make_dataset(3, 64, 16384, seed=8)
    eng = CellListEngine(r)
    assert_exact(eng.query(q), q, r)
    d2, idx = eng.query_topk(q, 8)
    assert_exact(idx[:, 0], q, r)
