"""The kernels' own contracts on the CPU (Pallas in interpret mode): exact
answers at unaligned shapes, lowest-index ties across reference tiles and
reference splits, a single query, the block shapes the wrappers choose at
the main path's widths (computed, not run), the choice of kernel mode, and
that a failed v9 dispatch is never hidden."""

import numpy as np
import pytest

import nns
from conftest import assert_exact
from nns.data import make_dataset
from nns.kernels import mxu_expansion as mx
from nns.kernels import pallas_fused as pf

H100_SMEM = 227 * 1024


def _pow2(x: int) -> bool:
    return x >= 1 and x & (x - 1) == 0


@pytest.mark.parametrize("k", [3, 16])
@pytest.mark.parametrize("m,n", [(33, 777), (70, 3000), (1, 1000)])
@pytest.mark.parametrize("splits", [None, 1, 3])
def test_fused_scan_exact_unaligned(k, m, n, splits):
    q, r = make_dataset(k=k, m=m, n=n, seed=5)
    assert_exact(np.asarray(pf.nns_fused(q, r, splits=splits)), q, r)


@pytest.mark.parametrize("splits", [None, 1, 2, 5])
@pytest.mark.parametrize("tile_n", [128, 256])
def test_fused_scan_lowest_index_across_tiles_and_splits(splits, tile_n):
    # Exact duplicates of the query in three different reference tiles
    # (and, with splits, in different reference splits): the lowest index
    # must win, whichever lane and split each copy lands in.
    rng = np.random.default_rng(0)
    r = rng.random((600, 3), dtype=np.float32)
    target = np.array([0.25, 0.5, 0.75], dtype=np.float32)
    r[[300, 17, 599]] = target
    q = np.stack([target, rng.random(3, dtype=np.float32)])
    idx = np.asarray(pf.nns_fused(q, r, tile_n=tile_n, splits=splits))
    assert idx[0] == 17
    assert_exact(idx, q, r)


def test_fused_scan_lowest_index_same_lane_across_tiles():
    # Two copies 128 apart share a lane of the (TM, TN) accumulator: the
    # strict < must keep the earlier tile's copy.
    rng = np.random.default_rng(1)
    r = rng.random((512, 16), dtype=np.float32)
    r[[5 + 128, 5 + 256]] = r[5 + 384]
    q = r[5 + 384][None]
    assert np.asarray(pf.nns_fused(q, r, tile_n=128))[0] == 5 + 128


@pytest.mark.parametrize("k,m", [(3, 10_000), (16, 10_000), (3, 1), (16, 1),
                                 (16, 1024), (5, 300)])
def test_fused_plan_block_shapes_at_1m(k, m):
    n_pad = -(-1_000_000 // 128) * 128
    p = pf.fused_plan(m, n_pad, k)
    assert _pow2(p["tm"]) and _pow2(p["tn"])
    assert p["smem_bytes"] <= H100_SMEM
    assert p["tm"] * k <= pf._WARPS * pf._ROW_REGS  # query rows fit registers
    assert p["m_pad"] % p["tm"] == 0 and p["m_pad"] >= m
    assert p["splits"] * p["tiles_per_split"] >= p["n_tiles"]
    assert (p["splits"] - 1) * p["tiles_per_split"] < p["n_tiles"]  # none empty
    programs = (p["m_pad"] // p["tm"]) * p["splits"]
    if m <= 1024:  # V7: few queries still fill the 132 SMs
        assert p["splits"] > 1 and programs >= 132


def test_v9_phase1_plan_block_shapes_at_1m():
    eng_kp = mx.padded_dims(16)
    n_pad = -(-1_000_000 // 4096) * 4096
    p = mx.phase1_plan(10_000, n_pad, eng_kp, 64, 4096, 256)
    for key in ("tm", "ts"):
        assert _pow2(p[key])
    assert _pow2(eng_kp) and eng_kp >= 16  # bf16 tensor-core operand edge
    assert p["smem_bytes"] <= H100_SMEM
    assert p["ns"] * p["ts"] == 4096 and p["n_tiles"] * 4096 == n_pad


@pytest.mark.parametrize("k", [3, 8, 16, 17])
def test_v9_padded_dims_power_of_two(k):
    kp = mx.padded_dims(k)
    assert _pow2(kp) and kp >= max(16, k)


def test_kernel_mode_by_backend():
    assert pf.interpret_mode("cpu") is True
    assert pf.interpret_mode("gpu") is False
    assert pf.interpret_mode() is True  # the test suite runs on the CPU
    for other in ("rocm", "METAL", "neuron"):
        with pytest.raises(RuntimeError, match="no Pallas kernel route"):
            pf.interpret_mode(other)


def test_v9_failed_dispatch_propagates(monkeypatch):
    rng = np.random.default_rng(2)
    r = rng.random((2000, 16), dtype=np.float32)
    q = rng.random((50, 16), dtype=np.float32)
    eng = mx.MXUExpansion(r, tile_m=16, tile_n=512)

    def broken(*args, **kwargs):
        raise RuntimeError("kernel refused by the compiler")

    monkeypatch.setattr(mx, "_expansion_drain", broken)
    with pytest.raises(RuntimeError, match="refused"):
        eng.query(q)
    monkeypatch.setattr(mx, "_expansion_query", broken)
    with pytest.raises(RuntimeError, match="refused"):
        eng.query_min_idx_cert(q)


def test_v9_failed_dispatch_propagates_through_engine(monkeypatch):
    rng = np.random.default_rng(4)
    r = rng.random((3000, 16), dtype=np.float32)
    q = rng.random((40, 16), dtype=np.float32)
    eng = nns.NNEngine(9).build(r)
    assert isinstance(eng._built, mx.MXUExpansion)

    def broken(*args, **kwargs):
        raise RuntimeError("kernel refused by the compiler")

    monkeypatch.setattr(mx, "_expansion_drain", broken)
    with pytest.raises(RuntimeError, match="refused"):
        eng.query(q)


def test_cell_scan_lexicographic_ties_and_certificate():
    # The supercell scan keeps the smallest global id among exact ties,
    # wherever the copies sit in the halo, and signs uncertified slots.
    import jax.numpy as jnp

    from nns.kernels.cell_list import _cell_scan

    rng = np.random.default_rng(6)
    g, qm, r_max = 3, 4, 640
    halo = rng.random((g, 3, r_max), dtype=np.float32)
    ids = rng.permutation(g * r_max).reshape(g, r_max).astype(np.int32)
    q = rng.random((g, qm, 3), dtype=np.float32)
    target = q[1, 2]
    halo[1, :, [9, 300, 600]] = target
    ids[1, [9, 300, 600]] = [77, 5, 901]
    d2, sgid = _cell_scan(jnp.asarray(q), jnp.asarray(halo), jnp.asarray(ids),
                          jnp.float32(0.01))
    d2, sgid = np.asarray(d2), np.asarray(sgid)
    assert d2.shape == sgid.shape == (g, qm)
    assert d2[1, 2] == 0.0 and sgid[1, 2] == 5
    # Reference: direct distances, lexicographic (d2, id) min, sign bit.
    dd = ((q[:, :, None, :] - np.swapaxes(halo, 1, 2)[:, None]) ** 2).sum(-1)
    for gi in range(g):
        for j in range(qm):
            best = dd[gi, j].min()
            want = ids[gi][dd[gi, j] == best].min()
            assert np.isclose(d2[gi, j], best, rtol=1e-6)
            assert sgid[gi, j] == (want if d2[gi, j] <= 0.01 else -want - 1)
