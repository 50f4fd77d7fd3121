"""Octree tests (v12/v13 analogs): build invariants (octant containment),
exactness incl. the corner cases the reference's 3-face-neighbor heuristic
would miss, host/device agreement, persistence."""

import numpy as np
import pytest

from conftest import assert_exact
from nns.data import make_dataset
from nns.trees.octree import Octree, nns_octree_host
from nns.trees.octree_device import nns_octree_device


def test_build_invariants():
    _, r = make_dataset(k=3, m=1, n=2000, seed=3)
    tree = Octree.build(r)
    # Points of every node's range lie inside its cube (closed boundary).
    for nid in range(len(tree.radius)):
        s, c = tree.start[nid], tree.count[nid]
        pts = tree.refs[tree.order[s : s + c]]
        assert (np.abs(pts - tree.center[nid]) <= tree.radius[nid] + 1e-5).all(), nid
    # Leaf ranges partition all points.
    is_leaf = tree.children.max(axis=1) < 0
    total = tree.count[is_leaf].sum()
    assert total == r.shape[0]
    # Children partition the parent's range.
    for nid in np.flatnonzero(~is_leaf):
        ch = tree.children[nid][tree.children[nid] >= 0]
        assert tree.count[ch].sum() == tree.count[nid]


@pytest.mark.parametrize("m,n", [(1, 1024), (200, 4096), (64, 513)])
def test_octree_host_exact(m, n):
    q, r = make_dataset(3, m, n, seed=1000)
    assert_exact(nns_octree_host(q, r), q, r)


@pytest.mark.parametrize("m,n", [(1, 1024), (128, 4096)])
def test_octree_device_exact(m, n):
    q, r = make_dataset(3, m, n, seed=1000)
    assert_exact(nns_octree_device(q, r), q, r)


def test_octree_clustered():
    # The octree's home turf (BASELINE.md: clustered refs) — deep leaves.
    q, r = make_dataset(3, 128, 8192, seed=4, clustered=True)
    assert_exact(nns_octree_host(q, r), q, r)
    assert_exact(nns_octree_device(q, r), q, r)


def test_octree_corner_neighbor_case():
    # True NN in a corner-adjacent octant (shares no face with the query's
    # octant) — the case the reference's own-octant + 3-face-neighbor
    # schedule (core.cu:1587-1609) can miss. Ours must stay exact.
    r = np.array(
        [
            [0.49, 0.49, 0.49],   # corner neighbor, very close to center
            [0.9, 0.9, 0.9],      # far point in the query's own octant
        ],
        dtype=np.float32,
    )
    filler = np.random.default_rng(0).random((62, 3)).astype(np.float32) * 0.2
    refs = np.concatenate([r, filler + np.array([0, 0, 0.8], np.float32)]).astype(np.float32)
    q = np.array([[0.51, 0.51, 0.51]], dtype=np.float32)
    assert_exact(nns_octree_host(q, refs), q, refs)
    assert_exact(nns_octree_device(q, refs), q, refs)


def test_octree_duplicates_beyond_depth():
    # Identical points force max-depth leaf chains with multi-point leaves.
    r = np.repeat(np.array([[0.25, 0.25, 0.25]], np.float32), 100, axis=0)
    r = np.concatenate([r, np.array([[0.8, 0.8, 0.8]], np.float32)])
    q = np.array([[0.3, 0.3, 0.3], [0.9, 0.9, 0.9]], dtype=np.float32)
    assert_exact(nns_octree_host(q, r), q, r)
    assert_exact(nns_octree_device(q, r), q, r)


def test_octree_k_fallback(monkeypatch):
    # k != 3 falls back to an exact full scan (core.cu:1641-1644 /
    # 1882-1885 contract). The host version keeps the reference-shaped
    # linear scan; the DEVICE version must route to the staged fused
    # device kernel — same policy as v11 — not the far slower host loop.
    q, r = make_dataset(5, 16, 512, seed=6)
    assert_exact(nns_octree_host(q, r), q, r)
    import nns.kernels.pallas_fused as pf

    calls = []
    real = pf.fused_fallback

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(pf, "fused_fallback", counting)
    assert_exact(nns_octree_device(q, r), q, r)
    assert calls, "k != 3 device fallback must take the fused device scan"


def test_engine_v13_high_k_stages_fused_at_build():
    # Build/query semantics: NNEngine(13) at k != 3 must stage the fused
    # engine ONCE at build (v11's policy) — the unbuilt per-call route
    # re-transfers the reference set every query.
    from nns.api import NNEngine
    from nns.kernels.pallas_fused import FusedBruteForce

    q, r = make_dataset(16, 32, 2048, seed=9)
    eng = NNEngine(13).build(r)
    assert isinstance(eng._built, FusedBruteForce)
    assert_exact(eng.query(q), q, r)


def test_octree_save_load(tmp_path):
    q, r = make_dataset(3, 32, 1024, seed=8)
    tree = Octree.build(r)
    path = str(tmp_path / "oct.npz")
    tree.save(path)
    loaded = Octree.load(path)
    np.testing.assert_array_equal(tree.query_host(q), loaded.query_host(q))


def test_octree_device_tiny_beam_fallback_exact():
    from nns.trees.octree import Octree
    from nns.trees.octree_device import octree_query_device

    q, r = make_dataset(3, 32, 2048, seed=11)
    tree = Octree.build(r)
    idx = octree_query_device(tree, q, beam=1)
    assert_exact(idx, q, r)


def test_octree_beam_certificate_coverage():
    from nns.trees.octree import Octree

    q, r = make_dataset(3, 256, 65536, seed=12)
    tree = Octree.build(r)
    idx, ok = tree.device_index().query_with_flags(q, beam=8)
    assert ok.mean() >= 0.95
    assert_exact(tree.device_index().query_exact(q), q, r)


def test_octree_degenerate_builds():
    # Morton-build edge cases: single point, all-identical points (keys
    # equal -> root leaf), a degenerate (zero-extent) dimension, and two
    # points closer than the 21-bit grid resolution (same key -> shared
    # leaf; the leaf scan keeps the query exact).
    q = np.array([[0.2, 0.2, 0.2], [0.9, 0.1, 0.5]], dtype=np.float32)
    for r in (
        np.array([[0.5, 0.5, 0.5]], np.float32),
        np.repeat(np.array([[0.25, 0.5, 0.75]], np.float32), 50, axis=0),
        np.column_stack(
            [
                np.linspace(0, 1, 64, dtype=np.float32),
                np.full(64, 0.3, np.float32),
                np.linspace(1, 0, 64, dtype=np.float32),
            ]
        ),
        np.array(
            [[0.1, 0.1, 0.1], [0.1 + 1e-9, 0.1, 0.1], [0.9, 0.9, 0.9]],
            np.float32,
        ),
    ):
        tree = Octree.build(r)
        is_leaf = tree.children.max(axis=1) < 0
        assert tree.count[is_leaf].sum() == r.shape[0]
        assert_exact(tree.query_host(q), q, r)
        assert_exact(tree.query_device(q), q, r)


def test_octree_cluster_with_far_outlier_still_resolves():
    # A dense cluster dwarfed by one far outlier exhausts the fixed 21-bit
    # Morton grid over the root box (cluster span < root_ext / 2^21). The
    # build must re-quantize such nodes over their own tight box so the
    # cluster keeps splitting — otherwise v12 degrades to an O(n) leaf
    # scan on exactly the clustered workloads the octree exists for.
    rng = np.random.default_rng(9)
    cluster = (rng.random((20_000, 3)) * 1e-4).astype(np.float32)
    outlier = np.array([[1e3, 1e3, 1e3]], dtype=np.float32)
    r = np.concatenate([cluster, outlier])
    tree = Octree.build(r)
    is_leaf = tree.children.max(axis=1) < 0
    assert tree.count[is_leaf].sum() == r.shape[0]
    assert tree.count[is_leaf].max() <= 2048, (
        "cluster collapsed into one giant leaf: max leaf count "
        f"{tree.count[is_leaf].max()}"
    )
    # Exactness probes both inside the cluster (f32-sharp distances) and
    # far from it (thousands of points f64-distinct but f32-TIED — f64
    # gaps ~4e-9 relative at distance ~520). recall_at_1's f32-degeneracy
    # fallback handles the far probe: the returned point must attain the
    # f32-minimal distance, the strongest claim definable on f32 inputs.
    q_in = (rng.random((64, 3)) * 1e-4).astype(np.float32)
    assert_exact(tree.query_host(q_in), q_in, r)
    q_far = np.array([[300.0, 300.0, 300.0]], np.float32)
    assert_exact(tree.query_host(q_far), q_far, r)
    # Order must remain a permutation through the re-quantization sorts.
    np.testing.assert_array_equal(np.sort(tree.order), np.arange(r.shape[0]))
