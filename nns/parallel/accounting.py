"""Per-device work accounting for the sharded paths.

The reference's multi-GPU scaling story is its shard arithmetic
(core.cu:781-791: thread_n = divup(n, num_gpus), each GPU scans m x
thread_n). These functions derive, from shapes alone, exactly how much scan
work, reference-data traffic, and collective payload each device owns, and
the virtual-mesh tests assert that per-device work falls ~1/D at fixed
totals while the collective payload stays O(m) (independent of n).
Wall-clock scaling is a measurement on the cards, not this module's job.

All numbers are derived from the same padding/tiling arithmetic the
kernels use — not measurements — so they are exact, deterministic, and
valid for any device count.
"""

from __future__ import annotations

from dataclasses import dataclass

from nns.kernels import layouts

_TILE = 128  # the fused scan's reference tile: shards are whole tiles


@dataclass(frozen=True)
class ChipWork:
    """Shape-derived per-chip accounting for one sharded query batch/drain.

    pairs_scanned: query-reference candidate pairs each chip evaluates
        (the kernels' padded forms — what actually runs, not the ideal).
    ref_bytes_resident: bytes of reference/halo data each chip holds.
    collective_payload_bytes: bytes each chip CONTRIBUTES to collectives
        for the whole batch/drain (the interconnect bill; receive side is this
        times (D-1) for an all-gather).
    collectives: number of collective ops issued for the batch/drain.
    """

    n_dev: int
    pairs_scanned: int
    ref_bytes_resident: int
    collective_payload_bytes: int
    collectives: int


def sharded_argmin_work(m: int, n: int, n_dev: int, k: int = 3) -> ChipWork:
    """parallel/sharded.py: refs sharded on n, queries replicated, winners
    all-gathered. Mirrors sharded_argmin's padding (refs to D * TILE)."""
    n_pad = layouts.round_up(n, n_dev * _TILE)
    shard_n = n_pad // n_dev
    m_pad = layouts.round_up(m, 8)
    return ChipWork(
        n_dev=n_dev,
        pairs_scanned=m_pad * shard_n,
        ref_bytes_resident=shard_n * k * 4,
        # two all_gathers (min_d f32 + gidx i32), each m floats per chip
        collective_payload_bytes=2 * m_pad * 4,
        collectives=2,
    )


def ring_argmin_work(m: int, n: int, n_dev: int, k: int = 3) -> ChipWork:
    """parallel/ring.py: queries AND refs sharded, reference blocks rotate
    via ppermute. Per chip: (m/D) x n pairs over D steps; communication is
    D hops of one reference block each."""
    n_pad = layouts.round_up(n, n_dev * _TILE)
    m_pad = layouts.round_up(m, n_dev * 8)
    shard_n = n_pad // n_dev
    m_local = m_pad // n_dev
    return ChipWork(
        n_dev=n_dev,
        pairs_scanned=m_local * shard_n * n_dev,  # = m_local * n_pad
        ref_bytes_resident=shard_n * k * 4,
        # D ppermute hops, each sending this chip's current (shard_n, k)
        # block one neighbor over — O(n/D) per hop, O(n) per query batch,
        # but NEVER materialized in full anywhere.
        collective_payload_bytes=n_dev * shard_n * k * 4,
        collectives=n_dev,
    )


def sharded_cells_work(engine, w: int, q_max: int) -> ChipWork:
    """parallel/sharded_cells.py: supercell groups partitioned over the
    mesh; each chip scans only its groups' dense slots against its halo
    tensors; one all-gather of the (w, g_local, q_max) winner tables per
    sub-drain. ``engine`` is a ShardedCellEngine (uses its real g_local /
    R_max padding)."""
    g_local = engine.g_local
    r_max = engine.R_max
    return ChipWork(
        n_dev=engine.n_dev,
        pairs_scanned=w * g_local * q_max * r_max,
        ref_bytes_resident=g_local * (3 * r_max * 4 + r_max * 4),
        collective_payload_bytes=w * g_local * q_max * 4,
        collectives=1,
    )
