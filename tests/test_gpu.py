"""The kernels as compiled for the card (no interpret mode), at small
shapes. Marked ``gpu``: they skip on the CPU and run on the card from
chip_smoke.py."""

import numpy as np
import pytest

from conftest import assert_exact
from nns.data import make_dataset

pytestmark = pytest.mark.gpu


def test_kernels_compile_for_the_card(gpu):
    from nns.kernels.pallas_fused import interpret_mode

    assert interpret_mode() is False


@pytest.mark.parametrize("k", [3, 5, 16])
@pytest.mark.parametrize("splits", [None, 1, 3])
def test_fused_scan_compiled_unaligned(gpu, k, splits):
    from nns.kernels.pallas_fused import nns_fused

    q, r = make_dataset(k=k, m=33, n=777, seed=11)
    assert_exact(np.asarray(nns_fused(q, r, splits=splits)), q, r)


@pytest.mark.parametrize("splits", [None, 1, 2, 5])
def test_fused_scan_compiled_lowest_index_ties(gpu, splits):
    from nns.kernels.pallas_fused import nns_fused

    rng = np.random.default_rng(0)
    r = rng.random((600, 3), dtype=np.float32)
    target = np.array([0.25, 0.5, 0.75], dtype=np.float32)
    r[[17, 300, 599]] = target
    idx = np.asarray(nns_fused(target[None], r, tile_n=128, splits=splits))
    assert idx[0] == 17


def test_v9_compiled_exact(gpu):
    from nns.kernels.mxu_expansion import MXUExpansion

    rng = np.random.default_rng(3)
    r = rng.random((5000, 16), dtype=np.float32)
    q = rng.random((300, 16), dtype=np.float32)
    eng = MXUExpansion(r, tile_m=32, tile_n=1024)
    _, _, cert = eng.query_min_idx_cert(q)
    assert cert.mean() > 0.5
    assert_exact(eng.query(q), q, r)


def test_cell_engine_on_card(gpu):
    from nns.kernels.cell_list import CellListEngine

    q, r = make_dataset(k=3, m=500, n=50000, seed=5)
    assert_exact(CellListEngine(r).query(q), q, r)
