"""Multi-chip supercell engine — the flagship's sharded form.

Scaling story (BASELINE.md: near-linear across cards): the supercell index
is embarrassingly shardable — supercell GROUPS partition across the mesh
axis, each chip holding the dense halo tensors for its group range and
scanning only queries routed to its groups. Per-chip work is the
single-chip kernel on 1/n_dev of the groups; the only communication is an
all-gather of the per-slot winners ((G, Q_max) scalars — a few hundred KB)
so every chip can assemble the full result. Compare the reference's v8:
contiguous shards, host-side merge (core.cu:821-852); here both the data
structure and the merge live on device.

The host-side build and query bucketing are inherited from CellListEngine;
only device placement and the scan dispatch differ.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nns.kernels.cell_list import CellListEngine, _cell_scan
from nns.kernels.layouts import PAD_SENTINEL


@functools.lru_cache(maxsize=128)
def _build_scan(mesh: Mesh, axis: str, g_local: int, q_max: int,
                halo2: float):
    def local(packed, halo_dm_l, halo_ids_l):
        i = jax.lax.axis_index(axis)
        q = packed[:, :3]
        sid = packed[:, 3].astype(jnp.int32)
        pos = packed[:, 4].astype(jnp.int32)
        sid_l = sid - i * g_local
        mine = (sid_l >= 0) & (sid_l < g_local)
        # Foreign queries scatter into a dump group (index g_local) so they
        # can never collide with this shard's real slots.
        sid_c = jnp.where(mine, sid_l, g_local)
        dense = jnp.zeros((g_local + 1, q_max, 3), jnp.float32)
        dense = dense.at[sid_c, pos].set(q)
        _, sgid = _cell_scan(dense[:g_local], halo_dm_l, halo_ids_l, halo2)
        # The scan signs uncertified slots (-id-1 < 0); the consumer's
        # `idx >= 0` certificate test is unchanged.
        return jax.lax.all_gather(sgid, axis, tiled=True)  # (G, Q_max)

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(None, None), P(axis, None, None), P(axis, None)),
            out_specs=P(None, None),
            check_vma=False,
        )
    )


# maxsize must exceed the canonical drain's full program universe per
# engine geometry — q_max tiers (<= 9 pow2 values) x _CHUNK_LADDER (5
# chunk widths) = 45 keys — with headroom for a second live geometry.
# At 32 a steady-state mixed workload could evict compiled executables
# and re-trace mesh programs mid-serving;
# test_sharded_queue_drain_bounds_traces pins the bound.
@functools.lru_cache(maxsize=128)
def _build_scan_queue(mesh: Mesh, axis: str, g_local: int, q_max: int,
                      w: int, halo2: float):
    """W staged batches drained in ONE sharded program: each chip slices
    its group range out of every (replicated) dense batch tensor and scans
    it; the W local winner tables are stacked and ride ONE all-gather for
    the whole drain (one collective per batch would pay W latencies for
    payloads that together are only W * G * QM i32, a few MB; one tiled
    gather moves the same bytes in one latency)."""
    def local(dstack, halo_dm_l, halo_ids_l):
        i = jax.lax.axis_index(axis)
        outs = []
        for wi in range(w):
            dense_l = jax.lax.dynamic_slice_in_dim(
                dstack[wi], i * g_local, g_local, axis=0
            )
            outs.append(_cell_scan(dense_l, halo_dm_l, halo_ids_l, halo2)[1])
        stacked = jnp.stack(outs)  # (W, g_local, Q_max)
        return jax.lax.all_gather(stacked, axis, axis=1, tiled=True)

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(None, None, None, None), P(axis, None, None), P(axis, None)),
            out_specs=P(None, None, None),
            check_vma=False,
        )
    )


class ShardedCellEngine(CellListEngine):
    """Supercell engine with halo tensors sharded over a 1-D mesh axis."""

    # The sharded drain follows the single-chip serving protocol — ragged
    # per-batch pow2 q_max staging, canonicalized into per-shape-tier
    # fixed-size sub-drains (_drain_ragged_canonical). Each sub-drain stacks
    # its same-shape batches into one (c, G, QM, 3) mesh-wide program with
    # ONE all-gather, so a skewed batch cannot inflate the whole queue's
    # tensors and the collective count is ceil(W_tier / chunk), not W.
    _ragged_queue_drain = True

    def __init__(self, refs: np.ndarray, mesh: Mesh, **kwargs):
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.n_dev = int(mesh.devices.size)
        super().__init__(refs, device_place=False, **kwargs)
        # device_place=False leaves numpy halos; pad + place across the mesh.
        self._place_halos(self.halo_dm, self.halo_ids)

    def _place_halos(self, halo_dm: np.ndarray, halo_ids: np.ndarray) -> None:
        """Pad the group axis to a multiple of the mesh size (sentinel-only
        groups) and shard both halo tensors over it."""
        G = self.D ** 3
        g_pad = -(-G // self.n_dev) * self.n_dev
        if g_pad != G:
            pad_dm = np.full((g_pad - G,) + halo_dm.shape[1:], PAD_SENTINEL, np.float32)
            halo_dm = np.concatenate([halo_dm, pad_dm])
            halo_ids = np.concatenate(
                [halo_ids, np.zeros((g_pad - G, self.R_max), np.int32)]
            )
        self.g_pad = g_pad
        self.g_local = g_pad // self.n_dev
        shard = NamedSharding(self.mesh, P(self.axis, None, None))
        self.halo_dm = jax.device_put(jnp.asarray(halo_dm), shard)
        self.halo_ids_dev = jax.device_put(
            jnp.asarray(halo_ids), NamedSharding(self.mesh, P(self.axis, None))
        )
        jax.block_until_ready((self.halo_dm, self.halo_ids_dev))

    # The single-chip staged surface returns a (4, m) packed device array;
    # the sharded device half returns the gathered winner table instead, so
    # the packed contract cannot be honored — use query_submit/query_collect.
    def query_staged(self, packed, q_max):  # pragma: no cover - guard
        raise NotImplementedError(
            "sharded engine: use query_submit()/query_collect() "
            "(or query()/query_with_flags())"
        )

    def query_queue_staged(self, dstack, fstack=None):
        """Sharded queue drain: same contract as the single-chip form.
        A stacked (W, G, QM, 3) array returns (W, G*QM) i32 sign-encoded
        winners; a tuple of W same-shape (G, QM, 3) arrays (the canonical
        ragged drain's per-tier chunks) returns W per-batch (G, QM) rows.
        Either way the whole drain rides ONE all-gather."""
        del fstack
        seq = isinstance(dstack, (tuple, list))
        if seq:
            shapes = {d.shape for d in dstack}
            if len(shapes) > 1:
                raise ValueError(
                    "sharded tuple drain requires same-shape batches per "
                    f"chunk (got {sorted(shapes)}); group by q_max tier "
                    "first (query_queue does this)"
                )
            dstack = jnp.stack([jnp.asarray(d) for d in dstack])
        else:
            dstack = jnp.asarray(dstack)
        w, G = dstack.shape[0], self.D ** 3
        if self.g_pad != dstack.shape[1]:
            dstack = jnp.pad(
                dstack,
                ((0, 0), (0, self.g_pad - dstack.shape[1]), (0, 0), (0, 0)),
            )
        fn = _build_scan_queue(
            self.mesh, self.axis, self.g_local, int(dstack.shape[2]), w,
            float(self.halo) ** 2,
        )
        out = fn(dstack, self.halo_dm, self.halo_ids_dev)  # (W, g_pad, QM)
        if seq:
            return tuple(out[wi, :G] for wi in range(w))
        return out[:, :G].reshape(w, -1)

    def query_submit(self, queries):
        """Asynchronous half, sharded form: host bucketing + ONE sharded
        dispatch (scan + all-gather). The returned token holds the
        still-in-flight gathered (G_pad, q_max) winner table; a serving
        loop can pipeline the next batch's host staging against it, same
        as the single-chip submit/collect protocol (cell_list.py:749)."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        packed_np, order, q_max = self.stage(q)
        if packed_np is None:
            # Too-skewed batch: nothing certified; caller's fallback rescans.
            return (None, None, order, len(order), None)
        fn = _build_scan(
            self.mesh, self.axis, self.g_local, q_max, float(self.halo) ** 2,
        )
        gathered = fn(jnp.asarray(packed_np), self.halo_dm, self.halo_ids_dev)
        risk = self._sentinel_risk(q)
        return (gathered, packed_np, order, q.shape[0], risk)

    def _unscatter(self, token):
        """Decode the gathered winner table back into query order. Returns
        (idx_raw, ok, inv): idx_raw is the per-query winner, sign-encoded
        (-id-1) for uncertified rows; inv is the order->query permutation,
        shared by both collect forms so it is computed once per token."""
        gathered, packed_np, order, m, risk = token
        gathered = np.asarray(gathered)  # the single round-trip
        sid_s = packed_np[:, 3].astype(np.int64)
        pos = packed_np[:, 4].astype(np.int64)
        inv = np.empty(m, dtype=np.int64)
        inv[order] = np.arange(m)
        idx = gathered[sid_s, pos][inv]
        ok = idx >= 0
        if risk is not None:
            ok &= ~risk  # sentinel-corner proximity: force the exact path
        return idx, ok, inv

    def query_collect(self, token):
        if token[0] is None:
            m = token[3]
            return np.zeros(m, dtype=np.int32), np.zeros(m, dtype=bool)
        idx, ok, _ = self._unscatter(token)
        return idx.astype(np.int32), ok

    def query_collect_dist(self, token):
        """(idx, certified, best_d2), sharded form — same triple as the
        single-chip contract (cell_list.py:766). The gather payload carries
        sign-encoded ids only (keeping the collective at O(G*QM) i32), so
        d2 is recomputed HOST-side, in float64, from the decoded winning
        candidate: for certified rows it equals the true NN distance of the
        f32 inputs up to f64 rounding (exact in practice — f64 rounding of
        a 3-term f32 sum is ~1e-16 relative), and for uncertified rows it
        is a sound upper bound on the true NN distance (any
        ||q - refs[j]||^2 upper-bounds the minimum; computing it in f64
        keeps the bound literally true — an f32 recompute can round ~1 ulp
        BELOW the truth). Divergence from single chip: on an empty-halo row
        the single-chip kernel reports inf while this path returns the
        finite (stronger) f64 distance to the decoded id-0 candidate. idx
        is the decoded candidate id (never sign-encoded)."""
        gathered, packed_np, order, m, risk = token
        if gathered is None:
            idx, ok = self.query_collect(token)
            return idx, ok, np.full(m, np.inf, dtype=np.float64)
        idx_raw, ok, inv = self._unscatter(token)
        q = packed_np[inv, :3].astype(np.float64)
        cand = np.where(idx_raw >= 0, idx_raw, -idx_raw - 1)
        diff = q - self.refs[cand].astype(np.float64)
        d2 = np.einsum("ij,ij->i", diff, diff)
        return cand.astype(np.int32), ok, d2

    def query_with_flags(self, queries: np.ndarray):
        return self.query_collect(self.query_submit(queries))

    # -- persistence (checkpoint subsystem, SURVEY.md §5) ------------------

    def save(self, path: str) -> None:
        """Placement-free checkpoint: fetches the logical (unpadded) halo
        tensors back from the mesh and writes the single-chip npz format,
        so one artifact restores as either engine —
        ``CellListEngine.load(path)`` (single chip) or
        ``ShardedCellEngine.load(path, mesh)`` (any mesh size; placement
        is re-derived, not serialized)."""
        G = self.D ** 3
        halo_dm = np.asarray(self.halo_dm)[:G]
        np.savez_compressed(
            path,
            refs=self.refs,
            halo_pts=np.swapaxes(halo_dm, 1, 2),
            halo_ids=self.halo_ids[:G],
            meta=np.array([self.D, self.R_max], dtype=np.int64),
            geo=np.concatenate([self.mn, self.W, [self.halo]]).astype(np.float64),
        )

    @classmethod
    def load(cls, path: str, mesh: Mesh | None = None) -> "ShardedCellEngine":
        """Restore from a single-chip-format npz onto a mesh (padding and
        placement are recomputed for THIS mesh's size, so a checkpoint
        written at D=4 restores cleanly at D=8)."""
        from nns.parallel.mesh import make_mesh

        if mesh is None:
            mesh = make_mesh()
        with np.load(path) as z:
            eng = cls.__new__(cls)
            eng.mesh = mesh
            eng.axis = mesh.axis_names[0]
            eng.n_dev = int(mesh.devices.size)
            eng.refs = z["refs"]
            eng.n = eng.refs.shape[0]
            eng.D, eng.R_max = (int(v) for v in z["meta"])
            geo = z["geo"]
            eng.mn, eng.W, eng.halo = geo[0:3], geo[3:6], float(geo[6])
            halo_pts = z["halo_pts"]
            eng.halo_ids = z["halo_ids"]
            eng.avg_candidates = float(
                (halo_pts[..., 0] < PAD_SENTINEL).sum() / eng.D ** 3
            )
            eng._place_halos(np.swapaxes(halo_pts, 1, 2), eng.halo_ids)
            return eng


def nns_sharded_cells(queries, refs, mesh: Mesh | None = None) -> np.ndarray:
    """One-shot sharded flagship; single device or non-3-D routes to the
    corresponding single-chip / brute paths."""
    from nns.parallel.mesh import make_mesh

    if mesh is None:
        mesh = make_mesh()
    if mesh.devices.size == 1 or refs.shape[1] != 3 or refs.shape[0] < 4096:
        from nns.kernels.cell_list import nns_cell_list

        return nns_cell_list(np.asarray(queries), np.asarray(refs))
    try:
        eng = ShardedCellEngine(np.asarray(refs), mesh)
    except ValueError:
        from nns.parallel.sharded import nns_sharded

        return np.asarray(nns_sharded(queries, refs, mesh=mesh))
    return eng.query(np.asarray(queries))
