"""Exact k-NN tests vs a numpy f64 oracle."""

import numpy as np
import pytest

from nns.data import make_dataset
from nns.kernels.topk import nns_topk


def _oracle_topk(q, r, kk):
    d = np.sum((q[:, None, :].astype(np.float64) - r[None, :, :].astype(np.float64)) ** 2, axis=-1)
    idx = np.lexsort((np.broadcast_to(np.arange(r.shape[0]), d.shape), d), axis=-1)[:, :kk]
    return idx


@pytest.mark.parametrize("k,m,n,kk", [(3, 32, 4096, 8), (16, 16, 2048, 4), (3, 8, 100000, 8)])
def test_topk_matches_oracle(k, m, n, kk):
    q, r = make_dataset(k, m, n, seed=1000)
    d2, idx = nns_topk(q, r, kk, chunk_n=8192)
    oracle = _oracle_topk(q, r, kk)
    # Compare by distance sets (f32 vs f64 can permute exact ties).
    d_oracle = np.sum((q[:, None, :].astype(np.float64) - r[oracle].astype(np.float64)) ** 2, axis=-1)
    d_ours = np.sum((q[:, None, :].astype(np.float64) - r[idx].astype(np.float64)) ** 2, axis=-1)
    np.testing.assert_allclose(d_ours, d_oracle, rtol=1e-5, atol=1e-9)
    assert (np.diff(d2, axis=1) >= 0).all()  # sorted ascending


def test_topk_duplicates_lowest_indices():
    rng = np.random.default_rng(0)
    r = rng.random((4096, 3), dtype=np.float32)
    target = np.array([0.5, 0.5, 0.5], dtype=np.float32)
    dups = [7, 1000, 2000, 3000]
    for w in dups:
        r[w] = target
    q = target[None, :]
    _, idx = nns_topk(q, r, 4, chunk_n=512)
    assert sorted(idx[0].tolist()) == dups  # all four ties found, by index


def test_topk_k_exceeds_n():
    q, r = make_dataset(3, 4, 5, seed=1)
    d2, idx = nns_topk(q, r, 10)
    assert idx.shape == (4, 5)
    assert (np.diff(d2, axis=1) >= 0).all()


def test_topk_first_column_is_1nn():
    from nns.kernels.oracle import recall_at_1

    q, r = make_dataset(3, 64, 8192, seed=2)
    _, idx = nns_topk(q, r, 8)
    assert recall_at_1(idx[:, 0], q, r) == 1.0
