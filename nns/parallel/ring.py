"""Ring-sharded exact NN — the blockwise / ring-attention analog.

SURVEY.md §5 names this layout as the rebuild's sequence-parallel analog: a
blockwise/"ring" variant whose n is bounded by the devices' combined memory,
not one device's. The all-gather merge in `parallel/sharded.py` (the v8
analog, core.cu:700-854) replicates queries to every card and gathers
per-card winners; its per-card memory is O(m + n/D). This module shards
BOTH sides: each card holds a query shard (m/D) and a reference block
(n/D), and the reference blocks rotate around the ring via `ppermute`
while each card folds a carried (min, global idx) over every visiting
block. Nothing is ever gathered:

- per-card memory is O(m/D + n/D) — reference sets larger than any single
  card's memory fit, with capacity scaling linearly in D;
- communication is D-1 neighbor hops of one block each (the same total
  bytes as an all-gather of the refs, but pipelined against compute and
  never materialized in full);
- each visiting block's global index offset is computed locally from
  (axis_index + step) mod D — the rotation needs no metadata exchange.

Exactness and tie-break: the local fused kernel returns the lowest local
index among tied minima, and the cross-block fold merges (min, idx)
lexicographically, so the result is the globally LOWEST reference index —
the brute-force family's strong tie-break contract, independent of ring
visit order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from nns.kernels import layouts
from nns.kernels.pallas_fused import (
    _TILE_M, _TILE_N, _fused_call_min_idx, interpret_mode,
)
from nns.parallel.mesh import best_mesh



@functools.lru_cache(maxsize=32)
def _build_ring(mesh: Mesh, axis: str, shard_n: int, tile_m: int,
                tile_n: int, interpret: bool):
    n_dev = mesh.shape[axis]
    perm = tuple((j, (j - 1) % n_dev) for j in range(n_dev))

    def local(q_local, r_shard):
        i = jax.lax.axis_index(axis)

        def step(s, carry):
            r_cur, best_d, best_i = carry
            min_d, lidx = _fused_call_min_idx(
                q_local, r_cur, tile_m, tile_n, interpret
            )
            origin = jax.lax.rem(i + s, n_dev)
            gidx = lidx + origin * shard_n
            better = (min_d < best_d) | ((min_d == best_d) & (gidx < best_i))
            best_d = jnp.where(better, min_d, best_d)
            best_i = jnp.where(better, gidx, best_i)
            # Rotate the reference block one hop (the final rotation returns
            # blocks to their owners — a no-op logically, kept for a
            # loop-invariant body).
            r_next = jax.lax.ppermute(r_cur, axis, perm)
            return (r_next, best_d, best_i)

        m_l = q_local.shape[0]
        init = (
            r_shard,
            jnp.full((m_l,), jnp.inf, dtype=jnp.float32),
            jnp.zeros((m_l,), dtype=jnp.int32),
        )
        _, _, best_i = jax.lax.fori_loop(0, n_dev, step, init)
        return best_i

    smapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None)),
        out_specs=P(axis),
        check_vma=False,  # pallas outputs lack varying-manual-axes metadata
    )
    return jax.jit(smapped)


def ring_argmin(
    queries: jnp.ndarray,
    refs: jnp.ndarray,
    mesh: Mesh,
    tile_m: int = _TILE_M,
    tile_n: int = _TILE_N,
) -> jnp.ndarray:
    """Exact 1-NN with queries AND refs sharded over ``mesh``'s first axis,
    reference blocks rotating via ppermute. Lowest-index tie-break."""
    axis = mesh.axis_names[0]
    # Shard over the FIRST mesh axis only: sizes must come from that axis,
    # not the whole device count, or global indices are silently wrong on
    # multi-axis meshes.
    n_dev = mesh.shape[axis]
    m = queries.shape[0]
    q = layouts.pad_queries(jnp.asarray(queries), n_dev * 8)
    r = layouts.pad_refs(jnp.asarray(refs), n_dev * _TILE_N)
    shard_n = r.shape[0] // n_dev
    fn = _build_ring(mesh, axis, shard_n, tile_m, tile_n, interpret_mode())
    return fn(q, r)[:m]


def nns_ring(queries, refs, mesh: Mesh | None = None,
             tile_m: int = _TILE_M, tile_n: int = _TILE_N):
    """Ring-sharded exact NN; single device falls back to the fused kernel
    (the graceful-degradation contract, SURVEY.md §5)."""
    if mesh is None:
        mesh = best_mesh(refs.shape[0])
    if mesh.devices.size == 1:
        from nns.kernels.pallas_fused import nns_fused, stage_inputs

        queries, refs = stage_inputs(queries, refs)
        return nns_fused(queries, refs, tile_m=tile_m, tile_n=tile_n)
    return ring_argmin(queries, refs, mesh, tile_m, tile_n)
