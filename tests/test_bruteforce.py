"""Brute-force family tests: v1/v2 XLA versions and the v3..v7 registry
rungs (one fused scan; v7 in its reference-split mode), each verified at
recall@1 = 1.0 against the f64 oracle over the scaled reference grid
(main.cu:38-51 corners, SURVEY.md §4)."""

import numpy as np
import pytest

import nns
from conftest import assert_exact
from nns.config import EngineConfig
from nns.data import make_dataset
from nns.kernels.pallas_fused import nns_fused
from nns.kernels.xla_bruteforce import nns_distance_matrix, nns_expansion_matmul


def _rung(version: int, name: str):
    """Registry rung ``version`` through the public API, with the tile
    sizes as keyword arguments like the kernel functions take them."""

    def fn(q, r, tile_m: int = 64, tile_n: int = 128):
        cfg = EngineConfig(tile_m=tile_m, tile_n=tile_n)
        return nns.nns(q, r, version=version, config=cfg)

    fn.__name__ = name
    return fn


nns_fused_point_major = _rung(3, "nns_fused_point_major")
nns_fused_streaming = _rung(5, "nns_fused_streaming")
nns_fused_queries_resident = _rung(6, "nns_fused_queries_resident")
nns_two_level = _rung(7, "nns_two_level")

ALL_BRUTE = [
    nns_distance_matrix,
    nns_expansion_matmul,
    nns_fused,
    nns_fused_point_major,
    nns_fused_queries_resident,
    nns_fused_streaming,
    nns_two_level,
]


@pytest.mark.parametrize("fn", ALL_BRUTE, ids=lambda f: f.__name__)
def test_bruteforce_exact_on_grid(fn, grid_datasets):
    for k, m, n, q, r in grid_datasets:
        idx = np.asarray(fn(q, r))
        assert idx.shape == (m,), f"{fn.__name__} shape at {(k, m, n)}"
        assert_exact(idx, q, r)


@pytest.mark.parametrize("fn", ALL_BRUTE, ids=lambda f: f.__name__)
def test_bruteforce_unaligned_shapes(fn):
    # Shapes that are not multiples of any tile size (padding paths).
    q, r = make_dataset(k=5, m=33, n=777, seed=11)
    assert_exact(np.asarray(fn(q, r)), q, r)


@pytest.mark.parametrize("fn", [nns_fused, nns_two_level], ids=lambda f: f.__name__)
def test_lowest_index_tiebreak_across_tiles(fn):
    # Duplicate points placed in different reference tiles: the returned
    # index must be the lowest (reference scan convention, core.cu:30-47).
    rng = np.random.default_rng(0)
    r = rng.random((600, 3), dtype=np.float32)
    target = np.array([0.25, 0.5, 0.75], dtype=np.float32)
    for dup in (17, 300, 599):  # spread across tiles for small tile_n
        r[dup] = target
    q = target[None, :]
    idx = np.asarray(fn(q, r, tile_m=8, tile_n=128))
    assert idx[0] == 17


def test_single_query_single_ref():
    q = np.array([[0.1, 0.2, 0.3]], dtype=np.float32)
    r = np.array([[0.9, 0.9, 0.9]], dtype=np.float32)
    for fn in ALL_BRUTE:
        assert np.asarray(fn(q, r))[0] == 0, fn.__name__


def test_v2_expansion_exact_at_offset():
    """ADVICE r1 (high): the expansion form alone misranks when rounding
    O(eps*scale^2) exceeds true distance gaps. A large common offset makes
    expansion error dominate — the refine pass must restore exactness."""
    rng = np.random.default_rng(42)
    base = rng.random((2048, 3)).astype(np.float32) * 1e-3 + 1000.0
    q = (rng.random((128, 3)).astype(np.float32) * 1e-3 + 1000.0)
    idx = nns.nns(q, base, version=2)
    assert_exact(idx, q, base)


def test_v2_duplicate_fallback_exact():
    """>L duplicates of the NN defeat the candidate certificate; v2 must
    fall back to the exact scan and still return the lowest index."""
    refs = np.ones((64, 4), dtype=np.float32) * 0.5
    refs[40:] = 0.9
    q = np.full((8, 4), 0.49, dtype=np.float32)
    idx = np.asarray(nns.nns(q, refs, version=2))
    np.testing.assert_array_equal(idx, np.zeros(8, dtype=np.int32))


def test_far_query_padding_in_range():
    """ADVICE r1 (medium): a query farther than the old 1e6 sentinel must
    not select a padding phantom — replica padding keeps every result a
    real in-range reference for any data range. (At 3e6 offsets f32
    arithmetic cannot discriminate sub-eps distance gaps, so the assertion
    is in-range + within f32 resolution of the true minimum, not f64
    recall.)"""
    rng = np.random.default_rng(7)
    refs = rng.random((1000, 3)).astype(np.float32)  # pads up to tile size
    q = np.array([[3e6, 3e6, 3e6]], dtype=np.float32)
    d = ((q[:, None, :].astype(np.float64) - refs[None]) ** 2).sum(-1)[0]
    dmin = d.min()
    for v in (1, 2, 3, 4, 5, 6, 7, 8, 9):
        idx = np.asarray(nns.nns(q, refs, version=v))
        assert 0 <= idx[0] < 1000, f"v{v} returned out-of-range {idx[0]}"
        assert d[idx[0]] <= dmin * (1 + 4 * np.finfo(np.float32).eps), (
            f"v{v} result outside the f32 resolution band"
        )
