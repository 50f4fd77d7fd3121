"""Layout/padding helper tests — the padding contract underpinning every
Pallas kernel (sentinel refs can never win; zero-padded dims are
distance-neutral)."""

import numpy as np

from nns.kernels import layouts


def test_round_up():
    assert layouts.round_up(0, 8) == 0
    assert layouts.round_up(1, 8) == 8
    assert layouts.round_up(8, 8) == 8
    assert layouts.round_up(129, 128) == 256


def test_pad_dims_distance_neutral():
    q = np.random.default_rng(0).random((4, 3)).astype(np.float32)
    r = np.random.default_rng(1).random((5, 3)).astype(np.float32)
    qp = np.asarray(layouts.pad_dims(q, 8))
    rp = np.asarray(layouts.pad_dims(r, 8))
    assert qp.shape == (4, 8)
    d_orig = ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)
    d_pad = ((qp[:, None, :] - rp[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(d_orig, d_pad, rtol=1e-6)


def test_pad_refs_sentinel_never_wins():
    r = np.random.default_rng(2).random((130, 3)).astype(np.float32)
    rp = np.asarray(layouts.pad_refs(r, 128))
    assert rp.shape == (256, 3)
    q = np.random.default_rng(3).random((8, 3)).astype(np.float32)
    d = ((q[:, None, :] - rp[None, :, :]) ** 2).sum(-1)
    assert (np.argmin(d, axis=1) < 130).all()


def test_pad_queries_and_dim_major():
    q = np.random.default_rng(4).random((5, 3)).astype(np.float32)
    qp = np.asarray(layouts.pad_queries(q, 8))
    assert qp.shape == (8, 3)
    np.testing.assert_array_equal(np.asarray(layouts.to_dim_major(qp)).shape, (3, 8))
