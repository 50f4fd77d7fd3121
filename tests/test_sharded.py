"""Multi-chip sharded brute force tests (v8/v9 analog) on the virtual
8-device CPU mesh — the reference's 4-GPU data parallelism (core.cu:700-1058)
was untestable without 4 GPUs; ours runs anywhere (SURVEY.md §4 item 4)."""

import jax as _jax
import pytest as _pytest

pytestmark = _pytest.mark.skipif(
    len(_jax.devices()) < 2, reason="needs a multi-device mesh (virtual CPU devices)"
)

import jax
import numpy as np
import pytest

from conftest import assert_exact
from nns.data import make_dataset
from nns.parallel.mesh import best_mesh, make_mesh
from nns.parallel.sharded import nns_sharded, sharded_argmin


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_sharded_exact_across_mesh_sizes(n_dev):
    q, r = make_dataset(k=3, m=64, n=4096, seed=1000)
    mesh = make_mesh(n_dev)
    idx = np.asarray(nns_sharded(q, r, mesh=mesh, tile_n=512))
    assert_exact(idx, q, r)


def test_sharded_matches_single_chip():
    from nns.kernels.pallas_fused import nns_fused

    q, r = make_dataset(k=16, m=32, n=2048, seed=5)
    single = np.asarray(nns_fused(q, r))
    multi = np.asarray(sharded_argmin(q, r, make_mesh(8), tile_n=256))
    np.testing.assert_array_equal(single, multi)


def test_sharded_unaligned_n():
    # n not divisible by n_dev * lane: sentinel-padded tail shards.
    q, r = make_dataset(k=3, m=17, n=999, seed=9)
    idx = np.asarray(sharded_argmin(q, r, make_mesh(8), tile_n=128))
    assert_exact(idx, q, r)


def test_sharded_tiebreak_lowest_global_index():
    # Duplicates on different shards: merge must pick the lowest global index.
    rng = np.random.default_rng(1)
    r = rng.random((1024, 3), dtype=np.float32)
    target = np.array([0.3, 0.6, 0.9], dtype=np.float32)
    for dup in (5, 400, 900):  # shards 0, 3, 7 for 8 shards of 128
        r[dup] = target
    q = target[None, :]
    idx = np.asarray(sharded_argmin(q, r, make_mesh(8), tile_n=128))
    assert idx[0] == 5


def test_best_mesh_degenerate_tiny_n():
    # Fewer reference points than devices must not produce empty shards.
    mesh = best_mesh(3)
    assert mesh.devices.size <= 3


# -- ring variant (parallel/ring.py) ----------------------------------------


def test_ring_matches_oracle_and_allgather():
    import jax
    from nns.parallel.mesh import make_mesh
    from nns.parallel.ring import ring_argmin
    from nns.parallel.sharded import sharded_argmin

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    mesh = make_mesh(8)
    q, r = make_dataset(3, 64, 8 * 256, seed=41)
    idx_ring = np.asarray(ring_argmin(q, r, mesh, tile_m=64, tile_n=128))
    idx_ag = np.asarray(sharded_argmin(q, r, mesh, tile_m=64, tile_n=128))
    # Both paths guarantee the lowest-index tie-break -> exact array equality.
    np.testing.assert_array_equal(idx_ring, idx_ag)
    assert_exact(idx_ring, q, r)


def test_ring_duplicate_tiebreak_lowest_global_index():
    import jax
    from nns.parallel.mesh import make_mesh
    from nns.parallel.ring import ring_argmin

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    mesh = make_mesh(8)
    rng = np.random.default_rng(42)
    base = rng.random((256, 3), dtype=np.float32)
    r = np.tile(base, (8, 1))  # every point duplicated on every shard
    q = base[:32] + np.float32(1e-5)
    idx = np.asarray(ring_argmin(q, r, mesh, tile_m=64, tile_n=128))
    # The winner must be the FIRST copy (shard 0's), regardless of which
    # ring step saw it first.
    d = np.sum((q[:, None].astype(np.float64) - r[None].astype(np.float64)) ** 2, -1)
    dmin = d.min(axis=1)
    for i in range(len(q)):
        ties = np.flatnonzero(d[i] <= dmin[i] * (1 + 1e-12) + 1e-18)
        assert idx[i] == ties.min()


def test_ring_uneven_pad_and_single_device_fallback():
    from nns.parallel.ring import nns_ring

    q, r = make_dataset(3, 33, 777, seed=43)  # padding on both axes
    assert_exact(np.asarray(nns_ring(q, r)), q, r)


def test_ring_16m_refs_virtual_mesh():
    # Big-n dryrun (VERDICT round 3 item 7): 2^24 reference points sharded
    # over the 8-device virtual mesh, reference blocks rotating on the ring
    # — per-chip memory O(m/D + n/D), the designed escape when one chip's
    # HBM is exhausted. Tiny query count + wide tiles keep the interpreted
    # kernel fast; recall vs the f64 oracle on all queries.
    import jax

    from nns.parallel.mesh import make_mesh
    from nns.parallel.ring import ring_argmin

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    rng = np.random.default_rng(99)
    n = 1 << 24
    refs = rng.random((n, 3), dtype=np.float32)
    queries = rng.random((8, 3), dtype=np.float32)
    mesh = make_mesh(8)
    idx = np.asarray(ring_argmin(queries, refs, mesh, tile_m=8, tile_n=131072))
    assert idx.max() >= (1 << 23)  # big-n ids actually exercised (w.h.p.)
    assert_exact(idx, queries, refs)
