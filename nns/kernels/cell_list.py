"""Supercell (cell-list) engine — exact low-dim NN with a dense index.

The reference's tree ladder (v10-v13) prunes per query with divergent
control flow. This engine makes the spatial index *dense* instead of
traversed:

Build (host, vectorized):
  - partition the bounding box into D^3 equal supercells (D ~ (n/350)^(1/3));
  - for every supercell, precompute its HALO point set — all reference
    points within ``halo`` distance of the supercell box (each point lands
    in <= 8 halo sets) — stored as one dense (G, R_max, k) tensor padded
    with distance sentinels, plus their global ids. Query-independent, so
    the runtime needs no gathers at all.

Query:
  - bucket queries by supercell and scatter them into a dense
    (G, Q_max, k) tensor on the host;
  - one scan (``_cell_scan``): per supercell, a fused direct-distance scan
    of its query block against its halo block with a (min, id) reduction —
    the exact scan batched over supercells, about
    n*(W+2*halo)^3/W^3/D^3 candidates per query instead of n;
  - unscatter on the host. Exactness certificate: a result is proven exact
    iff best_dist <= halo (every unscanned point is farther than ``halo``);
    queries failing it (rare on uniform data; possible on adversarial data)
    fall back to the exact full scan.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from nns.kernels.layouts import PAD_SENTINEL, pow2_at_least as _pow2_at_least


def _cell_scan(dense_q, halo_dm, halo_ids, halo2):
    """Per supercell, its query block against its whole halo block: direct
    distances and a lexicographic (d2, global id) min, in one XLA reduction.

    dense_q: (G, QM, 3) queries; halo_dm: (G, 3, R_max) dim-major halo
    points; halo_ids: (G, R_max) their global ids; halo2: the certificate
    radius^2. Returns per-slot (min_d (G, QM), SIGNED global id (G, QM)):
    among exactly tied neighbours the
    smallest global id wins (exact, but not the lowest-index guarantee of
    the brute-force family), and the certificate rides the sign bit: id when
    min_d <= halo2, -id-1 otherwise.

    XLA fuses the distance into the reduction, so the (G, QM, R_max)
    distance block is never stored. On an H100 this plain form ran at
    0.067 ms of device time per 10K-query batch of the 1M-point index
    (D = 14, R_max = 1280, QM = 16) against 0.081 ms for a Triton kernel
    with the halo loop inside the block; see PERF.md."""
    d2 = jnp.zeros(dense_q.shape[:2] + halo_dm.shape[2:], jnp.float32)
    for d in range(3):
        d2 = d2 + (dense_q[:, :, d, None] - halo_dm[:, None, d, :]) ** 2
    ids = jnp.broadcast_to(halo_ids[:, None, :], d2.shape)

    def lexmin(a, b):
        take = (b[0] < a[0]) | ((b[0] == a[0]) & (b[1] < a[1]))
        return jnp.where(take, b[0], a[0]), jnp.where(take, b[1], a[1])

    best, bid = jax.lax.reduce(
        (d2, ids), (jnp.float32(jnp.inf), jnp.int32(2**31 - 1)), lexmin, (2,)
    )
    return best, jnp.where(best <= halo2, bid, -bid - 1)


def _query_body(packed_in, halo_dm, halo_ids, halo2, q_max: int, g_total: int):
    """One batch: packed (m, 5) f32 [qx, qy, qz, sid, pos] -> scatter into
    the dense per-supercell tensor, scan kernel, unscatter -> (4, m)."""
    q_sorted = packed_in[:, :3]
    sid_s = packed_in[:, 3].astype(jnp.int32)   # exact for values < 2^24
    pos = packed_in[:, 4].astype(jnp.int32)
    dense_q = jnp.zeros((g_total, q_max, 3), jnp.float32).at[sid_s, pos].set(q_sorted)
    dmin, sgid = _cell_scan(dense_q, halo_dm, halo_ids, halo2)
    d2 = dmin[sid_s, pos]
    sg = sgid[sid_s, pos]
    # Certificate soundness, including queries OUTSIDE the data bounding box
    # (their cell index is clipped): every unscanned point B has per-dim
    # gap_d to the query's cell box with sum(gap_d^2) > halo^2, and for each
    # dim |B_d - q_d| >= gap_d — for in-box dims because q lies within its
    # cell's range, for clipped dims because the clipped cell touches the
    # violated boundary and B cannot lie beyond it. So dist(B, q) > halo,
    # and best <= halo proves exactness. The scan folded this compare into
    # the id's sign bit.
    ok = sg >= 0
    idx = jnp.where(ok, sg, -sg - 1)
    # Packed f32 result: [idx_hi, idx_lo, ok, best_d2]. Ids travel as two
    # exactly-representable float columns (hi/lo 12-bit split, each < 2^23,
    # sound for n < 2^35); a plain astype corrupts ids >= 2^24. Same scheme
    # as the top-k path. best_d2 is the scan's f32 min over the halo
    # candidates: it tracks the true NN distance only to f32 rounding (~1 ulp
    # can land BELOW the f64 truth), and is inf when the halo set was empty
    # — adaptive consumers size structures from it, widening by that band if
    # they need a sound upper bound.
    idx_hi = (idx >> 12).astype(jnp.float32)
    idx_lo = (idx & 0xFFF).astype(jnp.float32)
    return jnp.stack([idx_hi, idx_lo, ok.astype(jnp.float32), d2])


@functools.partial(jax.jit, static_argnames=("q_max", "g_total"))
def _device_query(packed_in, halo_dm, halo_ids, halo2, q_max: int, g_total: int):
    """Device path for ONE batch: one upload, one program, one fetch."""
    return _query_body(packed_in, halo_dm, halo_ids, halo2, q_max, g_total)


@jax.jit
def _device_query_queue(dstack, halo_dm, halo_ids, halo2):
    """W staged batches in ONE program: dstack (W, G, QM, 3) dense query
    tensors built on the HOST at staging time -> (W, G, QM) i32, the
    DENSE per-slot winners with the certificate in the sign bit (id when
    the <= halo certificate holds, -id-1 when it fails; ids < 2^30 by the
    build-time n limit). The device does ONLY the scans: the per-batch
    winner unscatter is numpy on the host after the fetch."""
    rows = _drain_rows((dstack[w] for w in range(dstack.shape[0])),
                       halo_dm, halo_ids, halo2)
    return jnp.stack(rows)


@jax.jit
def _device_query_queue_seq(ds_seq, halo_dm, halo_ids, halo2):
    """Tuple-form queue drain: W separate (G, QM, 3) device arrays in, W
    separate (G, QM) i32 winner tables out, still ONE device program.
    It skips the stacked form's per-batch slice and final stack, and lets
    the batches of one drain have different QM."""
    return tuple(_drain_rows(ds_seq, halo_dm, halo_ids, halo2))


def _drain_rows(ds_iter, halo_dm, halo_ids, halo2):
    """Shared drain body: one scan per batch, winner table returned in the
    scan's (G, QM) shape — the single place the queue output layout lives;
    consumers flatten on the host after the fetch (unscatter_queue reshapes
    its input, a numpy view)."""
    return [_cell_scan(d, halo_dm, halo_ids, halo2)[1] for d in ds_iter]


@functools.partial(jax.jit, static_argnames=("k_nn", "q_max", "g_total"))
def _device_query_topk(packed_in, halo_dm, halo_ids, halo2,
                       k_nn: int, q_max: int, g_total: int):
    """Exact k-NN over the dense halo sets (XLA path: per-group distance
    blocks + lax.top_k, chunked over groups to bound memory). Returns one
    packed (m, 2*k_nn + 1) f32 array: [dists, ids, certificate] — the
    certificate holds iff the k-th distance is within halo (then no
    unscanned point can belong to the true top-k, modulo exact ties)."""
    q_sorted = packed_in[:, :3]
    sid_s = packed_in[:, 3].astype(jnp.int32)
    pos = packed_in[:, 4].astype(jnp.int32)
    r_max = halo_dm.shape[2]
    dense_q = jnp.zeros((g_total, q_max, 3), jnp.float32).at[sid_s, pos].set(q_sorted)

    # Bound the per-chunk distance block (gc, q_max, r_max) to ~16M f32
    # (the 1-NN scan kernel bounds its tile the same way).
    gc = max(1, min(64, (16 << 20) // max(q_max * r_max, 1)))
    g_pad = -(-g_total // gc) * gc
    dq = jnp.pad(dense_q, ((0, g_pad - g_total), (0, 0), (0, 0)))
    hd = jnp.pad(halo_dm, ((0, g_pad - g_total), (0, 0), (0, 0)),
                 constant_values=PAD_SENTINEL)

    kk = min(k_nn, r_max)

    def chunk(c):
        qs = jax.lax.dynamic_slice_in_dim(dq, c * gc, gc, axis=0)   # (gc, QM, 3)
        hs = jax.lax.dynamic_slice_in_dim(hd, c * gc, gc, axis=0)   # (gc, 3, R)
        d2 = jnp.zeros((gc, q_max, r_max), jnp.float32)
        for d in range(3):
            d2 = d2 + (qs[:, :, d : d + 1] - hs[:, d : d + 1, :]) ** 2
        nd, pi = jax.lax.top_k(-d2.reshape(gc * q_max, r_max), kk)
        return -nd, pi  # ascending distances + halo-slot positions

    kd, kp = jax.lax.map(chunk, jnp.arange(g_pad // gc))
    kd = kd.reshape(g_pad, q_max, kk)[:g_total]
    kp = kp.reshape(g_pad, q_max, kk)[:g_total]

    qd = kd[sid_s, pos]                                   # (m, kk)
    qpos = kp[sid_s, pos]
    qid = halo_ids[sid_s[:, None], qpos]                  # (m, kk) gather
    ok = qd[:, -1] <= halo2
    if kk < k_nn:  # fewer halo slots than requested neighbors
        qd = jnp.pad(qd, ((0, 0), (0, k_nn - kk)), constant_values=jnp.inf)
        qid = jnp.pad(qid, ((0, 0), (0, k_nn - kk)))
        ok = jnp.zeros_like(ok)
    # Ids travel as two exactly-representable float columns (hi/lo 12-bit
    # split, each < 2^23); a plain astype corrupts ids >= 2^24.
    qid_hi = (qid >> 12).astype(jnp.float32)
    qid_lo = (qid & 0xFFF).astype(jnp.float32)
    return jnp.concatenate(
        [qd, qid_hi, qid_lo, ok[:, None].astype(jnp.float32)], axis=1
    )


class CellListEngine:
    """Prepare-once/query-many exact NN for k <= 3-ish low dims (k == 3 here,
    matching the octree family's domain; other k route to the fused kernel)."""

    # query_queue staging form: True = ragged per-batch q_max through the
    # canonical tier/chunk drain (both the single-chip engine and
    # ShardedCellEngine — its query_queue_staged stacks each
    # same-shape chunk into one mesh-wide program). False keeps shared-QM
    # stacked staging; no in-tree engine uses it, but the stacked
    # query_queue_staged form remains public API.
    _ragged_queue_drain = True

    def __init__(self, refs: np.ndarray, d_per_dim: int | None = None,
                 halo: float | None = None, max_candidates: int = 200_000,
                 device_place: bool = True):
        refs = np.ascontiguousarray(refs, dtype=np.float32)
        n, k = refs.shape
        if k != 3:
            raise ValueError("CellListEngine requires 3-D points")
        if n >= 1 << 30:
            # Result ids travel as hi/lo 12-bit f32 pairs (exact transit up
            # to 2^35) and as i32 in-kernel with a 2^30 tie mask, so the
            # true ceiling is 2^30 — device memory bounds n long before that.
            raise ValueError("CellListEngine supports n < 2^30 per device")
        self.refs = refs
        self.n = n

        mn = refs.min(axis=0)
        mx = refs.max(axis=0)
        extent = np.maximum(mx - mn, 1e-6)
        if d_per_dim is None:
            # ~350 points per supercell (D=14 at n=1M).
            d_per_dim = max(1, min(24, round((n / 350.0) ** (1.0 / 3.0))))
        self.D = d_per_dim
        self.W = (extent / self.D).astype(np.float64)  # per-dim supercell width
        if halo is None:
            # halo = c * (V/n)^(1/3) trades certificate coverage against
            # scan width: P(NN > halo) = exp(-(4/3)pi c^3) per uniform
            # query. c = 1.5 gives P ~ 7e-7 (one fallback per ~140 batches
            # of 10K) while carrying ~40% fewer halo candidates per cell
            # than the previous c = 2.5 (P ~ e-65 — certainty overkill that
            # cost real kernel time every batch).
            volume = float(np.prod(extent))
            halo = 1.5 * (volume / max(n, 1)) ** (1.0 / 3.0)
        # Build-cost bound: membership enumeration spans ceil(2*halo/W) + 1
        # cells per dim, so halo is capped at one cell width (<= 3 cells per
        # dim, <= 27 memberships per point). A larger requested halo is
        # clamped — the certificate then rejects more queries (exact
        # fallback), never lies. The fast native build handles the classic
        # halo <= W/2 (8-corner) case; wider halos use the vectorized numpy
        # enumeration.
        self.halo = float(min(halo, float(self.W.min())))
        self.mn = mn.astype(np.float64)

        # Halo membership: point p joins group g iff p is within halo of g's
        # box; per dim that is at most 2 consecutive supercell indices
        # (guaranteed by the halo <= W/2 clamp above). Native C++ counting-
        # sort build when available (two O(8n) passes); numpy fallback below.
        G = self.D ** 3
        from nns.native import native_cells_build

        native = None
        if self.halo <= float(self.W.min()) / 2.0:
            # The native counting-sort build enumerates the classic
            # {lo, hi} 8-corner memberships, valid only for halo <= W/2.
            native = native_cells_build(
                refs, self.D, self.halo, self.mn, self.W, max_candidates, PAD_SENTINEL
            )
        if native is not None:
            halo_dm_np, halo_ids, counts = native
            if halo_dm_np is None:
                raise ValueError(
                    f"supercell halo overflow (R_max={int(counts.max())}): data "
                    "too clustered for the cell-list engine — use the fused "
                    "kernel or octree"
                )
            self.R_max = halo_dm_np.shape[2]
        else:
            halo_pts, halo_ids, counts = self._build_numpy_halos(refs, max_candidates)
            halo_dm_np = np.ascontiguousarray(np.swapaxes(halo_pts, 1, 2))
        if device_place:
            self.halo_dm = jax.device_put(jnp.asarray(halo_dm_np))
            self.halo_ids_dev = jax.device_put(jnp.asarray(halo_ids))
            jax.block_until_ready((self.halo_dm, self.halo_ids_dev))
        else:
            # Subclasses (sharded placement) stage the arrays themselves.
            self.halo_dm = halo_dm_np
            self.halo_ids_dev = None
        self.halo_ids = halo_ids
        self.avg_candidates = float(counts.mean())

    # -- query ------------------------------------------------------------

    def _sentinel_risk(self, q: np.ndarray) -> np.ndarray | None:
        """Bool mask of queries close enough to the PAD_SENTINEL corner
        (coordinates 1e6 per dim) that a padded halo slot could win the scan
        AND pass the <= halo certificate — possible when the DATA itself
        lives near 1e6 (range robustness). Such
        queries are forced uncertified on the host, so they take the exact
        fallback; everywhere else the phantom's distance exceeds halo and
        the certificate already rejects it. Returns None when no query is
        at risk (the overwhelmingly common case)."""
        d2 = ((q.astype(np.float64) - PAD_SENTINEL) ** 2).sum(axis=1)
        risk = d2 <= (2.0 * self.halo) ** 2
        return risk if bool(risk.any()) else None

    def _group_of(self, q: np.ndarray) -> np.ndarray:
        g = np.floor((q.astype(np.float64) - self.mn) / self.W).astype(np.int64)
        g = np.clip(g, 0, self.D - 1)
        return (g[:, 0] * self.D + g[:, 1]) * self.D + g[:, 2]

    def _build_numpy_halos(self, refs: np.ndarray, max_candidates: int):
        """Vectorized numpy halo build (wide-halo levels, and the fallback
        when the native lib is unavailable): enumerate the cells whose box
        lies within ``halo`` of each point per dim (a variable lo..hi index
        range — the classic 8-corner case when halo <= W/2), stable-sort by
        group, fill. Membership is per-dim (L-inf) and thus a superset of
        the L2 ball — the certificate stays sound: any point absent from a
        cell's set has a > halo gap in SOME dim, hence L2 distance > halo."""
        rel = refs.astype(np.float64) - self.mn
        lo = np.clip(np.floor((rel - self.halo) / self.W).astype(np.int64), 0, self.D - 1)
        hi = np.clip(np.floor((rel + self.halo) / self.W).astype(np.int64), 0, self.D - 1)
        span = (hi - lo).max(axis=0) + 1  # per-dim enumeration width
        pairs_pt: list[np.ndarray] = []
        pairs_gid: list[np.ndarray] = []
        for dx in range(int(span[0])):
            gx = lo[:, 0] + dx
            vx = gx <= hi[:, 0]
            for dy in range(int(span[1])):
                gy = lo[:, 1] + dy
                vy = gy <= hi[:, 1]
                for dz in range(int(span[2])):
                    gz = lo[:, 2] + dz
                    vz = gz <= hi[:, 2]
                    valid = vx & vy & vz
                    gid = (gx * self.D + gy) * self.D + gz
                    pairs_pt.append(np.flatnonzero(valid))
                    pairs_gid.append(gid[valid])
        pt = np.concatenate(pairs_pt)
        gid = np.concatenate(pairs_gid)
        # Within a group, slot order follows octant-block then id — an
        # arbitrary but fixed order (ties return any true NN; see kernel).
        order = np.argsort(gid, kind="stable")
        pt, gid = pt[order], gid[order]

        G = self.D ** 3
        counts = np.bincount(gid, minlength=G)
        r_max = int(counts.max()) if len(counts) else 1
        if r_max > max_candidates:
            raise ValueError(
                f"supercell halo overflow (R_max={r_max}): data too clustered "
                "for the cell-list engine — use the fused kernel or octree"
            )
        # Round to 256 slots, not pow2 (see native_cells_build): the scan
        # pays R_max for every group.
        self.R_max = max(256, -(-r_max // 256) * 256)
        starts = np.concatenate([[0], np.cumsum(counts)])
        halo_pts = np.full((G, self.R_max, 3), PAD_SENTINEL, dtype=np.float32)
        halo_ids = np.zeros((G, self.R_max), dtype=np.int32)
        pos = np.arange(len(pt)) - starts[gid]
        halo_pts[gid, pos] = refs[pt]
        halo_ids[gid, pos] = pt.astype(np.int32)
        return halo_pts, halo_ids, counts

    def q_max_limit(self) -> int:
        """Largest supported queries-per-supercell for one batch. Every
        batch pays its densest supercell's QM in every supercell, so a
        batch beyond this bound (a heavily skewed query distribution) goes
        to the brute-force path instead."""
        return 2048

    def stage(self, queries: np.ndarray):
        """Host-side bucketing: sort queries by supercell, compute slot
        positions, pack into one (m, 5) f32 upload array. Returns
        (packed_np, order, q_max); q_max is None when the batch is too
        skewed for the dense kernel (caller must use the brute path)."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim != 2 or q.shape[1] != 3:
            raise ValueError(f"queries must be (m, 3); got {q.shape}")
        m = q.shape[0]
        from nns.native import native_cells_stage

        native = native_cells_stage(q, self.D, self.mn, self.W)
        if native is not None:
            packed, order, raw_max = native
            q_max = _pow2_at_least(max(raw_max, 8))
            if q_max > self.q_max_limit():
                return None, order, None
            return packed, order, q_max
        sid = self._group_of(q)
        order = np.argsort(sid, kind="stable")
        sid_s = sid[order]
        counts = np.bincount(sid_s, minlength=self.D ** 3)
        q_max = _pow2_at_least(max(int(counts.max()), 8))
        if q_max > self.q_max_limit():
            return None, order, None
        pos = np.arange(m) - np.concatenate([[0], np.cumsum(counts)])[sid_s]
        packed = np.empty((m, 5), dtype=np.float32)
        packed[:, :3] = q[order]
        packed[:, 3] = sid_s
        packed[:, 4] = pos
        return packed, order, q_max

    def query_staged(self, packed, q_max: int):
        """Device half: one dispatch over a staged (m, 5) upload array
        (numpy or device-resident). Returns the packed (4, m) device array."""
        return _device_query(
            jnp.asarray(packed), self.halo_dm, self.halo_ids_dev,
            jnp.float32(self.halo) ** 2, q_max, self.D ** 3,
        )

    def _dense_scatter(self, packed: np.ndarray, q_max: int):
        """One staged (m, 5) pack -> (dense (G, q_max, 3) f32, flat winner
        slots (m,) i32) — the single home of the host dense-scatter (both
        staging forms share it so a future dtype/sentinel change cannot
        drift between them)."""
        sid = packed[:, 3].astype(np.int64)
        pos = packed[:, 4].astype(np.int64)
        dense = np.zeros((self.D ** 3, q_max, 3), np.float32)
        dense[sid, pos] = packed[:, :3]
        return dense, (sid * q_max + pos).astype(np.int32)

    def stage_queue_ragged(self, batches):
        """Ragged queue staging for the tuple drain: each batch keeps its
        OWN pow2 q_max instead of sharing the queue-wide max, so one
        skewed batch cannot inflate every other batch's dense tensor and
        winner table (`stage_queue`'s shared-QM stacking doubles the
        whole queue's download the moment any batch crosses a pow2
        boundary — observed: one 18-query supercell in a 896-deep queue).
        The tuple drain traces one scan per batch, so mixed shapes share
        one device program. Returns (denses [list of (G, qm_b, 3)],
        fslots [list of (m,) i32], orders), or (None, None, None) when
        any batch is too skewed for the dense kernel."""
        denses, fslots, orders = [], [], []
        for qb in batches:
            packed, order, q_max = self.stage(qb)
            if packed is None:
                return None, None, None
            dense, flat = self._dense_scatter(packed, q_max)
            denses.append(dense)
            fslots.append(flat)
            orders.append(order)
        return denses, fslots, orders

    def stage_queue(self, batches):
        """Queue-form staging: bucket several equal-sized query batches on
        host straight into dense per-supercell tensors plus flat winner
        slots (the device then does no scatter at all). Returns
        (dstack (W, G, QM, 3), fstack (W, m), orders) — dstack is None when
        any batch is too skewed for the dense kernel (caller queries per
        batch instead)."""
        packs, orders, q_maxes = [], [], []
        for qb in batches:
            packed, order, q_max = self.stage(qb)
            if packed is None:
                return None, None, None
            packs.append(packed)
            orders.append(order)
            q_maxes.append(q_max)
        q_max = max(q_maxes)
        denses, flats = [], []
        for packed in packs:
            dense, flat = self._dense_scatter(packed, q_max)
            denses.append(dense)
            flats.append(flat)
        return np.stack(denses), np.stack(flats), orders

    def query_queue_staged(self, dstack, fstack=None):
        """Device half of the queue path: W staged batches, one dispatch
        (see _device_query_queue). Returns the dense (W, G, QM) i32
        device array (the sharded override returns (W, G*QM) — flat either
        way after unscatter_queue's host reshape) — winner id per slot,
        certificate in the sign bit; recover
        per-query results by indexing with stage_queue's fstack slots on
        the host (unscatter_queue). ``fstack`` is accepted for call-site
        symmetry but the device no longer needs it. A tuple/list of W
        per-batch (G, QM, 3) arrays routes to the slice-free tuple drain
        (same winners, rows returned as a tuple)."""
        del fstack
        if isinstance(dstack, (tuple, list)):
            return _device_query_queue_seq(
                tuple(dstack), self.halo_dm, self.halo_ids_dev,
                jnp.float32(self.halo) ** 2,
            )
        return _device_query_queue(
            jnp.asarray(dstack), self.halo_dm, self.halo_ids_dev,
            jnp.float32(self.halo) ** 2,
        )

    @staticmethod
    def unscatter_queue(out_w: np.ndarray, fslots: np.ndarray,
                        order: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Host half of the queue path for one batch: dense (G*QM,) signed
        winners + the batch's flat slots and staging order -> (idx, ok) in
        the caller's original query order."""
        got = np.asarray(out_w).reshape(-1)[fslots]  # (m,) signed, staged order
        m = len(order)
        inv = np.empty(m, dtype=np.int64)
        inv[order] = np.arange(m)
        got = got[inv]
        ok = got >= 0
        idx = np.where(ok, got, -got - 1).astype(np.int32)
        return idx, ok

    # Sub-drain sizes for the serving (canonicalized) ragged drain, largest
    # first; greedy decomposition of each tier's batch count. The small
    # steps (4, 2) keep remainders amortized: a 7-batch tier drains as
    # 4+2+1 (3 dispatches / sharded collectives) instead of 7 singles,
    # while the compiled-program universe stays bounded by
    # tiers x len(ladder).
    _CHUNK_LADDER = (64, 8, 4, 2, 1)

    def _drain_ragged_canonical(self, denses):
        """Serving-safe ragged drain: group batches by dense shape (the
        pow2 q_max tier — <= 9 tiers exist) and drain each tier in
        fixed-size chunks from ``_CHUNK_LADDER``, so the compiled-program
        universe is bounded by tiers x ladder sizes REGARDLESS of queue
        composition or order. Jitting the ordered W-tuple directly (the
        bench's monolithic path) makes any novel q_max mix or permutation
        a fresh trace — a compile in the middle of serving. All winner rows
        are concatenated on device and fetched ONCE. Returns the per-batch
        flat (G*qm_b,) i32 winner arrays in input order."""
        by_shape: dict[tuple, list[int]] = {}
        for i, d in enumerate(denses):
            by_shape.setdefault(d.shape, []).append(i)
        pending: list[tuple[int, Any]] = []  # (batch index, device row)
        for idxs in by_shape.values():
            p = 0
            while p < len(idxs):
                c = next(s for s in self._CHUNK_LADDER if s <= len(idxs) - p)
                chunk = idxs[p:p + c]
                rows = self.query_queue_staged(tuple(denses[i] for i in chunk))
                pending.extend(zip(chunk, rows))
                p += c
        sizes = [denses[i].shape[0] * denses[i].shape[1] for i, _ in pending]
        offs = np.concatenate([[0], np.cumsum(sizes)])
        flat = np.asarray(jnp.concatenate([r.reshape(-1) for _, r in pending]))
        winners: list[np.ndarray | None] = [None] * len(denses)
        for j, (i, _) in enumerate(pending):
            winners[i] = flat[offs[j]:offs[j + 1]]
        return winners

    def query_queue(self, batches, return_coverage: bool = False):
        """EXACT answers for several equal-sized query batches in few device
        dispatches (the serving queue-drain path: per-dispatch overhead
        amortizes across the whole queue). Uncertified queries in
        any batch fall back to the exact scan; a too-skewed queue falls
        back to per-batch querying. With ``return_coverage``, also returns
        the per-batch certified fraction (query_with_coverage semantics) so
        serving callers can feed workload-adaptation hysteresis.

        Staging is RAGGED on the single-chip engine (per-batch pow2 q_max —
        one skewed batch cannot inflate the whole drain's tensors; see
        stage_queue_ragged) and the drain is CANONICALIZED into per-tier
        fixed-size sub-drains (_drain_ragged_canonical) so the compiled-
        program universe is bounded by tiers x ladder sizes; the host
        still pays ONE sync fetch. ShardedCellEngine inherits this drain —
        its query_queue_staged stacks each same-shape chunk into one
        mesh-wide program with one all-gather."""
        if self._ragged_queue_drain:
            denses, fslots, orders = self.stage_queue_ragged(batches)
            staged_ok = denses is not None
        else:
            dstack, fslots, orders = self.stage_queue(batches)
            staged_ok = dstack is not None
        if not staged_ok:
            pairs = [self.query_with_coverage(qb) for qb in batches]
            results = [idx for idx, _ in pairs]
            return (results, [cov for _, cov in pairs]) if return_coverage \
                else results
        if self._ragged_queue_drain:
            winners = self._drain_ragged_canonical(denses)
        else:
            out = np.asarray(self.query_queue_staged(dstack))
            winners = [out[w] for w in range(len(batches))]
        results = []
        covs = []
        for w, qb in enumerate(batches):
            idx, ok = self.unscatter_queue(winners[w], fslots[w], orders[w])
            risk = self._sentinel_risk(np.asarray(qb, dtype=np.float32))
            if risk is not None:
                ok &= ~risk
            covs.append(float(ok.mean()) if len(ok) else 1.0)
            if not ok.all():
                from nns.kernels.pallas_fused import fused_fallback

                bad = np.flatnonzero(~ok)
                idx[bad] = np.asarray(fused_fallback(
                    np.ascontiguousarray(qb, dtype=np.float32)[bad], self.refs
                ))
            results.append(idx)
        return (results, covs) if return_coverage else results

    def query_submit(self, queries: np.ndarray):
        """Asynchronous half: host bucketing + device dispatch. Returns a
        token for ``query_collect``; several tokens may be in flight, so a
        serving loop pipelines host prep with device compute."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        packed_np, order, q_max = self.stage(q)
        if packed_np is None:
            # Batch too skewed for the dense kernel: mark every query as
            # uncertified; collect()'s caller routes them to the exact scan.
            return (None, order, len(order), None)
        risk = self._sentinel_risk(q)
        return (self.query_staged(packed_np, q_max), order, packed_np.shape[0], risk)

    def query_collect(self, token):
        idx, ok, _ = self.query_collect_dist(token)
        return idx, ok

    def query_collect_dist(self, token):
        packed, order, m, risk = token
        if packed is None:
            return (
                np.zeros(m, dtype=np.int32),
                np.zeros(m, dtype=bool),
                np.full(m, np.inf, dtype=np.float32),
            )
        packed = np.asarray(packed)  # the single round-trip
        inv = np.empty(m, dtype=np.int64)
        inv[order] = np.arange(m)
        hi = packed[0][inv].astype(np.int64)
        lo_bits = packed[1][inv].astype(np.int64)
        idx = ((hi << 12) | lo_bits).astype(np.int32)
        ok = packed[2][inv].astype(bool)
        d2 = packed[3][inv].astype(np.float32)
        if risk is not None:
            ok &= ~risk  # sentinel-corner proximity: force the exact path
        return idx, ok, d2

    def query_with_flags(self, queries: np.ndarray):
        return self.query_collect(self.query_submit(queries))

    def query_with_flags_dist(self, queries: np.ndarray):
        """(idx, certified, best_d2): best_d2 is the kernel's f32 min over
        the halo candidates — it tracks the true NN distance only to f32
        rounding (can land ~1 ulp, ~1e-7 relative, BELOW the f64 truth),
        and is inf when the halo set was empty. Consumers needing a sound
        upper bound must widen by that band (or recompute in f64 as the
        sharded engine does, sharded_cells.py query_collect_dist)."""
        return self.query_collect_dist(self.query_submit(queries))

    def query_with_coverage(self, queries: np.ndarray) -> tuple[np.ndarray, float]:
        """Exact answers plus the fraction certified by the index (callers
        can adapt engine choice when coverage is persistently poor)."""
        idx, ok = self.query_with_flags(queries)
        idx = np.array(idx)
        if not ok.all():
            from nns.kernels.pallas_fused import fused_fallback

            bad = np.flatnonzero(~ok)
            idx[bad] = np.asarray(fused_fallback(
                np.ascontiguousarray(queries, dtype=np.float32)[bad], self.refs
            ))
        cov = float(np.asarray(ok).mean()) if len(ok) else 1.0
        return idx.astype(np.int32), cov

    def query(self, queries: np.ndarray) -> np.ndarray:
        return self.query_with_coverage(queries)[0]

    def query_topk(self, queries: np.ndarray, k_nn: int = 8):
        """Exact k-NN through the supercell index: (dist2[m, k], idx[m, k]),
        ascending. Queries whose k-th neighbor the certificate cannot prove
        (k-th dist > halo, or fewer than k candidates) fall back to the
        exact chunked top-k scan."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        m = q.shape[0]
        k_nn = min(k_nn, self.n)  # nns_topk clamps the same way
        packed_np, order, q_max = self.stage(q)
        if packed_np is None:
            from nns.kernels.topk import nns_topk

            return nns_topk(q, self.refs, k_nn)
        out = np.asarray(_device_query_topk(
            jnp.asarray(packed_np), self.halo_dm, self.halo_ids_dev,
            jnp.float32(self.halo) ** 2, k_nn, q_max, self.D ** 3,
        ))
        inv = np.empty(m, dtype=np.int64)
        inv[order] = np.arange(m)
        out = out[inv]
        d2 = out[:, :k_nn].astype(np.float32)
        hi = out[:, k_nn : 2 * k_nn].astype(np.int64)
        lo = out[:, 2 * k_nn : 3 * k_nn].astype(np.int64)
        idx = ((hi << 12) | lo).astype(np.int32)
        ok = out[:, -1] > 0.5
        risk = self._sentinel_risk(q)
        if risk is not None:
            ok &= ~risk
        if not ok.all():
            from nns.kernels.topk import nns_topk

            bad = np.flatnonzero(~ok)
            fd, fi = nns_topk(q[bad], self.refs, k_nn)
            d2[bad] = fd
            idx[bad] = fi
        return d2, idx


    # -- persistence (checkpoint subsystem, SURVEY.md §5) ------------------

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            refs=self.refs,
            halo_pts=np.swapaxes(np.asarray(self.halo_dm), 1, 2),
            halo_ids=self.halo_ids,
            meta=np.array([self.D, self.R_max], dtype=np.int64),
            geo=np.concatenate([self.mn, self.W, [self.halo]]).astype(np.float64),
        )

    @classmethod
    def load(cls, path: str) -> "CellListEngine":
        with np.load(path) as z:
            eng = cls.__new__(cls)
            eng.refs = z["refs"]
            eng.n = eng.refs.shape[0]
            eng.D, eng.R_max = (int(v) for v in z["meta"])
            geo = z["geo"]
            eng.mn, eng.W, eng.halo = geo[0:3], geo[3:6], float(geo[6])
            halo_pts = z["halo_pts"]
            eng.halo_ids = z["halo_ids"]
            eng.halo_dm = jax.device_put(jnp.asarray(np.swapaxes(halo_pts, 1, 2)))
            eng.halo_ids_dev = jax.device_put(jnp.asarray(eng.halo_ids))
            jax.block_until_ready((eng.halo_dm, eng.halo_ids_dev))
            eng.avg_candidates = float((halo_pts[..., 0] < PAD_SENTINEL).sum() / eng.D ** 3)
            return eng


def nns_cell_list(queries, refs, d_per_dim: int | None = None) -> np.ndarray:
    """One-shot wrapper; non-3-D or tiny reference sets route to the fused
    kernel (capability-dispatch contract, SURVEY.md §5)."""
    if refs.shape[1] != 3 or refs.shape[0] < 4096:
        from nns.kernels.pallas_fused import fused_fallback

        return np.asarray(fused_fallback(queries, refs))
    try:
        # One-shot semantics: a single CellListEngine — residual misses
        # go to one exact scan. (Prepare-once/query-many callers get
        # workload adaptation — promotion to the octree beam index on
        # clustered data — via NNEngine.)
        eng = CellListEngine(np.asarray(refs), d_per_dim=d_per_dim)
    except ValueError:
        from nns.kernels.pallas_fused import fused_fallback

        return np.asarray(fused_fallback(queries, refs))
    return eng.query(np.asarray(queries))
