"""Structural scaling evidence (VERDICT r3 item 5): per-chip work falls
~1/D at fixed problem totals, and collective payload stays O(m) — derived
from the kernels' own padding arithmetic (parallel/accounting.py) and
spot-validated against live engines on the virtual mesh.

Reference analog: core.cu:781-791 — the reference's multi-GPU scaling
story IS its shard arithmetic (thread_n = divup(n, num_gpus)); this is
the same proof at the rebuild's level, runnable without N real chips.
"""

from __future__ import annotations

import numpy as np
import pytest

from nns.parallel.accounting import (
    ring_argmin_work,
    sharded_argmin_work,
    sharded_cells_work,
)

M, N = 10_000, 1 << 20


@pytest.mark.parametrize("work_fn", [sharded_argmin_work, ring_argmin_work])
def test_per_chip_pairs_fall_inverse_in_d(work_fn):
    base = work_fn(M, N, 1)
    for d in (2, 4, 8):
        w = work_fn(M, N, d)
        ratio = w.pairs_scanned / base.pairs_scanned
        if work_fn is sharded_argmin_work:
            # refs shard 1/D; queries replicated.
            assert ratio == pytest.approx(1 / d, rel=0.02)
        else:
            # ring: queries shard 1/D, every chip still visits all of n.
            assert ratio == pytest.approx(1 / d, rel=0.02)
        assert w.ref_bytes_resident == pytest.approx(
            base.ref_bytes_resident / d, rel=0.02
        )


def test_collective_payload_is_o_m_not_o_n():
    # Payload must not grow with n for the gather-merge path...
    for d in (2, 4, 8):
        small = sharded_argmin_work(M, 1 << 18, d)
        big = sharded_argmin_work(M, 1 << 22, d)
        assert small.collective_payload_bytes == big.collective_payload_bytes
        assert small.collective_payload_bytes == 2 * M * 4  # two m-float gathers
    # ...while the ring's per-chip payload is O(n) total but O(n/D) per hop
    # and independent of m.
    for d in (2, 4, 8):
        w1 = ring_argmin_work(M, N, d)
        w2 = ring_argmin_work(4 * M, N, d)
        assert w1.collective_payload_bytes == w2.collective_payload_bytes
        assert w1.collectives == d


def test_sharded_cells_work_matches_live_engine():
    import jax

    from nns.parallel.mesh import make_mesh
    from nns.parallel.sharded_cells import ShardedCellEngine

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    rng = np.random.default_rng(9)
    r = rng.random((32768, 3), dtype=np.float32)
    works = {}
    for d in (2, 4, 8):
        eng = ShardedCellEngine(r, make_mesh(d))
        w = sharded_cells_work(eng, w=4, q_max=16)
        works[d] = w
        # Live-engine agreement: g_local really is the padded G / D.
        assert eng.g_local * d == eng.g_pad
        assert w.collectives == 1  # one all-gather per sub-drain (round 4)
    # Per-chip scan work and resident halo bytes fall ~1/D (up to the
    # sentinel padding that makes the group axis shard evenly).
    for d in (4, 8):
        assert works[d].pairs_scanned <= works[2].pairs_scanned * 2 / d * 1.1
        assert works[d].ref_bytes_resident <= (
            works[2].ref_bytes_resident * 2 / d * 1.1
        )
    # Collective payload is the winner table only — O(G * q_max), not the
    # halo data: far below the resident reference bytes.
    assert works[8].collective_payload_bytes < works[8].ref_bytes_resident
