"""Multi-chip sharded brute force — the v8/v9 analog (core.cu:700-1058).

Reference behavior: shard the reference set contiguously across GPUs
(thread_n = divup(n, num_gpus), core.cu:781), replicate queries to every GPU
(core.cu:793), compute per-GPU winners with the fused kernel, then merge on
the HOST through an OpenMP critical section + barrier + CPU argmin
(core.cu:821-852) — local indices rebased to global by adding the shard
offset (core.cu:1032-1033).

Here (SURVEY.md §2.3, §7 B4): the same data decomposition, but the merge
never leaves the devices. `jax.shard_map` over a 1-D mesh axis: refs sharded
on n, queries replicated; each card runs the fused local-argmin kernel;
per-card (min_dist, global_idx) winners are all-gathered over NVLink
(m * n_dev * 8 bytes — tiny; XLA hands the collective to NCCL) and reduced
on-device.
Exactness/tie-break: shards are contiguous ascending, so picking the
lowest-numbered shard among tied minima (XLA argmin over the gathered axis)
yields the globally lowest reference index.
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



@functools.lru_cache(maxsize=64)
def _build(mesh: Mesh, axis: str, shard_n: int, tile_m: int, tile_n: int, interpret: bool):
    def local(q, r_shard):
        min_d, lidx = _fused_call_min_idx(q, r_shard, tile_m, tile_n, interpret)
        gidx = lidx + jax.lax.axis_index(axis) * shard_n
        # The on-device merge replacing the reference's host critical section:
        # winners (n_dev, m) are all-gathered, then reduced locally.
        md_all = jax.lax.all_gather(min_d, axis)   # (n_dev, m)
        gi_all = jax.lax.all_gather(gidx, axis)    # (n_dev, m)
        win = jnp.argmin(md_all, axis=0)           # lowest shard on ties
        return jnp.take_along_axis(gi_all, win[None, :], axis=0)[0]

    smapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, None), P(axis, None)),
        out_specs=P(None),
        # pallas_call outputs don't carry varying-manual-axes metadata yet;
        # replication of the merged result is checked by the tests instead.
        check_vma=False,
    )
    return jax.jit(smapped)


def sharded_argmin(
    queries: jnp.ndarray,
    refs: jnp.ndarray,
    mesh: Mesh,
    tile_m: int = _TILE_M,
    tile_n: int = _TILE_N,
) -> jnp.ndarray:
    """Exact 1-NN with the reference set sharded over ``mesh``'s first axis."""
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    m = queries.shape[0]
    # Pad n so every shard is equal-sized and a whole number of reference
    # tiles; replica padding (copies of refs[0]) loses every tie-break
    # (layouts.pad_refs).
    r = layouts.pad_refs(jnp.asarray(refs), n_dev * _TILE_N)
    shard_n = r.shape[0] // n_dev
    fn = _build(mesh, axis, shard_n, tile_m, tile_n, interpret_mode())
    idx = fn(jnp.asarray(queries), r)
    return idx[:m]


@functools.lru_cache(maxsize=64)
def _build_2d(mesh: Mesh, dp_axis: str, shard_axis: str, shard_n: int,
              tile_m: int, tile_n: int, interpret: bool):
    def local(q_local, r_shard):
        min_d, lidx = _fused_call_min_idx(q_local, r_shard, tile_m, tile_n, interpret)
        gidx = lidx + jax.lax.axis_index(shard_axis) * shard_n
        md_all = jax.lax.all_gather(min_d, shard_axis)
        gi_all = jax.lax.all_gather(gidx, shard_axis)
        win = jnp.argmin(md_all, axis=0)
        return jnp.take_along_axis(gi_all, win[None, :], axis=0)[0]

    smapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(dp_axis, None), P(shard_axis, None)),
        out_specs=P(dp_axis),
        check_vma=False,
    )
    return jax.jit(smapped)


def sharded_argmin_2d(
    queries: jnp.ndarray,
    refs: jnp.ndarray,
    mesh: Mesh,
    tile_m: int = _TILE_M,
    tile_n: int = _TILE_N,
) -> jnp.ndarray:
    """Exact 1-NN over a 2-D mesh: queries data-parallel over the first axis,
    reference set sharded over the second (the scale-out layout: DP for
    throughput, ref-sharding for memory; merge collective rides only the
    shard axis). Query/ref counts are padded to multiples of the mesh axes."""
    dp_axis, shard_axis = mesh.axis_names[0], mesh.axis_names[1]
    n_dp = mesh.shape[dp_axis]
    n_shard = mesh.shape[shard_axis]
    m = queries.shape[0]
    q = layouts.pad_queries(jnp.asarray(queries), n_dp * 8)
    r = layouts.pad_refs(jnp.asarray(refs), n_shard * _TILE_N)
    shard_n = r.shape[0] // n_shard
    fn = _build_2d(mesh, dp_axis, shard_axis, shard_n, tile_m, tile_n, interpret_mode())
    return fn(q, r)[:m]


def nns_sharded(queries, refs, mesh: Mesh | None = None, tile_m: int = _TILE_M, tile_n: int = _TILE_N):
    """v8 analog. Falls back to the single-device fused kernel when only one
    device is available (reference fallback contract: core.cu:774-777)."""
    if mesh is None:
        mesh = best_mesh(refs.shape[0])
    if mesh.devices.size == 1:
        from nns.kernels.pallas_fused import nns_fused, stage_inputs

        queries, refs = stage_inputs(queries, refs)
        return nns_fused(queries, refs, tile_m=tile_m, tile_n=tile_n)
    return sharded_argmin(queries, refs, mesh, tile_m, tile_n)
