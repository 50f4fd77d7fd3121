"""Oracle + v0 linear scan tests (reference analog: core.cu v0, the ladder's
ground truth — which the reference itself never verified, SURVEY.md §4)."""

import numpy as np
import pytest

from nns.data import make_dataset
from nns.kernels.oracle import (
    _linear_scan_numpy,
    linear_scan,
    nn_oracle_f64,
    recall_at_1,
)


def test_oracle_matches_bruteforce_tiny():
    q, r = make_dataset(k=3, m=10, n=50, seed=7)
    idx, dmin = nn_oracle_f64(q, r)
    d = np.sum((q[:, None, :].astype(np.float64) - r[None, :, :].astype(np.float64)) ** 2, axis=-1)
    np.testing.assert_array_equal(idx, np.argmin(d, axis=1))
    np.testing.assert_allclose(dmin, d.min(axis=1), rtol=1e-12)


@pytest.mark.parametrize("k,m,n", [(3, 1, 1024), (16, 1, 1024), (3, 200, 2048), (16, 100, 1024)])
def test_linear_scan_exact(k, m, n):
    q, r = make_dataset(k, m, n, seed=1000)
    idx = linear_scan(q, r)
    assert idx.dtype == np.int32
    assert recall_at_1(idx, q, r) == 1.0


def test_linear_scan_numpy_lowest_index_tiebreak():
    # Duplicate reference points: scan must return the lowest index.
    r = np.array([[0.5, 0.5], [0.1, 0.1], [0.1, 0.1]], dtype=np.float32)
    q = np.array([[0.1, 0.1]], dtype=np.float32)
    assert _linear_scan_numpy(q, r)[0] == 1


def test_recall_detects_wrong_answer():
    q, r = make_dataset(3, 32, 256, seed=3)
    idx, _ = nn_oracle_f64(q, r)
    wrong = np.array(idx)
    wrong[0] = (wrong[0] + 1) % r.shape[0]
    assert recall_at_1(wrong, q, r) < 1.0


def test_recall_accepts_ties():
    r = np.array([[0.0, 0.0], [0.0, 0.0], [1.0, 1.0]], dtype=np.float32)
    q = np.array([[0.0, 0.0]], dtype=np.float32)
    # Index 1 is a tie with index 0 — both are true nearest neighbors.
    assert recall_at_1(np.array([1]), q, r) == 1.0
    assert recall_at_1(np.array([2]), q, r) < 1.0
