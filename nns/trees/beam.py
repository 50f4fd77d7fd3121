"""Beam frontier search — the device tree query (v11/v13 engine).

The reference's *intended* GPU traversals (core.cu:1305-1345 and 1717-1794,
both no-ops there) are pointer-chasing stack machines: run as a batched
`lax.while_loop` that pops one tree node per query per step, every step is a
serialized chain of gathers and (m, cap) one-hot stack scatters, and the
loop runs for the max-over-queries visit count — slower than the same
algorithm on the host. A wide device wants tree search DENSE, not
pointer-chased. This module is that redesign; both tree families share it.

Build (host, from an already-built KDTree/Octree):
  - FRONTIER: a maximal antichain of subtrees each owning <= cap points
    (oversized depth-limited octree leaves are chunked into several buckets).
    The tree's own partition geometry defines the buckets — this *is* the
    KD/octree, queried breadth-first instead of node-at-a-time.
  - per-bucket tight bounding boxes over the member points (tighter than the
    splitting planes / cubes, still exact lower bounds);
  - one dense (F, cap, k) point tensor per tree, padded by replicating the
    bucket's first member — padding with REAL points keeps every path exact
    for any data range (a far-sentinel coordinate cannot);
  - the KD-tree stores one point at every internal node (the reference's
    implicit-heap design, core.cu:1080); the 2^T - 1 points living above the
    frontier form an EXTRAS block scanned densely by every query.

Query — one jitted dispatch, no scatters, no data-dependent control flow:
  1. lb[m, F] = distance from each query to each bucket's box (dense);
  2. top-(beam+1) nearest buckets per query (lax.top_k);
  3. gather the beam buckets' (cap, k) blocks, exact direct-form (q - r)^2
     distances, carried argmin (+ the extras block);
  4. exactness certificate: best * (1 + 1e-5) <= lb of the (beam+1)-th
     bucket — every unscanned point lies in a bucket at least that far, so
     the scanned winner is a true nearest neighbor (the margin covers f32
     rounding of lb vs the direct form; ties return any true NN, like all
     traversal engines here). Uncertified queries fall back to the exact
     fused scan.

On uniform data the beam certifies ~all queries (the home bucket plus a
handful of box neighbors contain the NN ball), so per-query work drops from
n points to ~beam * cap + extras, with every op a dense batched tensor op.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from nns.kernels.layouts import pow2_at_least, round_up

_CHUNK_M = 1024   # queries per lax.map step (bounds the gather/candidate temps)
_MAX_F = 65536    # bucket-count guard: cap doubles until the frontier fits
# Certificate margin: lb and the direct form are both f32 sums of <= 16
# squared terms (<= ~4 ulp relative each); 1e-5 relative dominates both.
_CERT_MARGIN = 1.0 + 1e-5


def _select_buckets(lb, beam: int):
    """Per-query nearest-`beam` bucket ids + the (beam+1)-th box bound (the
    certificate threshold). For the serving beams (kk <= 17) this unrolls
    argmin + where-mask passes instead of ``lax.top_k``, which over a
    (1024, 2048) bound matrix lowers to a full row sort; kk iota-reduce
    argmins are cheap passes. Same extraction trick as _beam_topk's hit
    loop. Wide retry beams (kk > 17, the rare uncertified tail) keep top_k:
    there the sort amortizes better than ~33+ unrolled passes would."""
    m, f_total = lb.shape
    nb = min(beam, f_total)
    kk = min(beam + 1, f_total)
    if kk > 17:
        neg, bids = jax.lax.top_k(-lb, kk)
        thr = (-neg[:, nb] if f_total > nb
               else jnp.full((m,), jnp.inf, jnp.float32))
        return bids[:, :nb], thr
    cols = jax.lax.broadcasted_iota(jnp.int32, lb.shape, 1)
    rows = jnp.arange(m)
    sel_parts = []
    thr = jnp.full((m,), jnp.inf, jnp.float32)
    for i in range(kk):
        pos = jnp.argmin(lb, axis=1)
        if i < nb:
            sel_parts.append(pos)
        else:                       # i == nb: the (beam+1)-th smallest bound
            thr = lb[rows, pos]
        lb = jnp.where(cols == pos[:, None], jnp.inf, lb)
    return jnp.stack(sel_parts, axis=1), thr


def _beam_query_core(q, lo, hi, pts, ids, extras, extras_ids, beam: int):
    """q (m, k); lo/hi (F, k); pts (F, cap, k); ids (F, cap); extras (E, k).
    Returns (best_idx (m,) i32, certified (m,) bool)."""
    m, k = q.shape
    f_total = lo.shape[0]
    cap = pts.shape[1]

    # 1. Dense box lower bounds: per-dim accumulation keeps the working set
    # at (m, F) instead of materializing an (m, F, k) gap tensor.
    lb = jnp.zeros((m, f_total), dtype=jnp.float32)
    for d in range(k):
        qd = q[:, d : d + 1]
        gap = jnp.maximum(jnp.maximum(lo[None, :, d] - qd, qd - hi[None, :, d]), 0.0)
        lb = lb + gap * gap

    # 2. Nearest beam buckets + the (beam+1)-th bound = certificate threshold.
    nb = min(beam, f_total)
    sel, thr = _select_buckets(lb, beam)                 # (m, nb), (m,)

    # 3. Exact direct-form scan of the selected buckets (+ shared extras).
    cand = pts[sel]                                      # (m, nb, cap, k) gather
    cids = ids[sel]                                      # (m, nb, cap)
    diff = q[:, None, None, :] - cand
    d2 = jnp.sum(diff * diff, axis=3).reshape(m, nb * cap)
    flat_ids = cids.reshape(m, nb * cap)
    if extras.shape[0]:
        de = jnp.zeros((m, extras.shape[0]), dtype=jnp.float32)
        for d in range(k):
            dd = q[:, d : d + 1] - extras[None, :, d]
            de = de + dd * dd
        d2 = jnp.concatenate([d2, de], axis=1)
        flat_ids = jnp.concatenate(
            [flat_ids, jnp.broadcast_to(extras_ids[None, :], (m, extras.shape[0]))],
            axis=1,
        )
    pos = jnp.argmin(d2, axis=1)
    rows = jnp.arange(m)
    best = d2[rows, pos]
    idx = flat_ids[rows, pos]

    # 4. Certificate (see module docstring). best == thr == 0 certifies
    # soundly: a zero-distance winner ties any unscanned duplicate.
    ok = best * _CERT_MARGIN <= thr
    return idx.astype(jnp.int32), ok


@functools.partial(jax.jit, static_argnames=("beam",))
def _beam_query_many(qc, lo, hi, pts, ids, extras, extras_ids, beam: int):
    """ONE program for a whole staged queue: qc (C, step, k) chunks mapped
    through _beam_query_core by lax.map, so the per-step bucket gather stays
    bounded at one chunk while the host pays ONE dispatch + ONE fetch
    instead of one dispatch per chunk. Returns (C, 2, step) i32:
    [idx | certified] per chunk, one fetchable array."""

    def step(qk):
        idx, ok = _beam_query_core(qk, lo, hi, pts, ids, extras, extras_ids, beam)
        return jnp.stack([idx, ok.astype(jnp.int32)], axis=0)

    return jax.lax.map(step, qc)


def _chunk_scan_core(q, lo, hi, pts, ids, extras, extras_ids, budget: int):
    """Budget scan: ONE shared candidate set per query chunk instead of a
    per-query bucket gather (the high-k clustered serving path).

    The per-query beam gather materializes (m, beam, cap, k) — at
    beam=16/cap=512/k=16 that is 0.5 GB per 1024-query chunk. But a
    LOCALITY-SORTED chunk's queries overwhelmingly
    select the same buckets (in-distribution clustered workloads: ~8
    buckets per blob, ~40 queries per blob per batch), so this core scans
    the chunk-level union instead:

      1. lb (m, F) box bounds as in the beam core;
      2. the `budget` buckets nearest to ANY query in the chunk
         (min-over-queries score, one top_k row — not per-query);
      3. gather those buckets ONCE — (budget, cap, k), ~100x less device
         memory traffic than the per-query form — append the extras block,
         and run the exact direct-form fused scan (pallas_fused, the v4
         kernel) of all m queries against the shared candidate tensor;
      4. certificate: winner_d2 * margin <= min lb over the buckets NOT
         in the scanned set (every unscanned point lies in an unscanned
         bucket at least that far). Sound for ANY query order; sorting
         only affects how often it certifies.

    Exactness: the fused kernel computes direct-form f32 (q - r)^2 over
    real points only (bucket pads and tile pads are replicas of real
    points), so a certified winner is a true NN of the f32 inputs; the
    scanned set is a SUPERSET of any per-query beam selection that the
    same budget could certify, so coverage dominates the beam form's at
    equal scanned volume. Returns (idx (m,) i32, certified (m,) bool).
    """
    from nns.kernels import layouts
    from nns.kernels.pallas_fused import (
        _TILE_M, _fused_on_prepared, interpret_mode, ref_tile,
    )

    m, k = q.shape
    f_total = lo.shape[0]
    cap = pts.shape[1]
    b = min(budget, f_total)

    lb = jnp.zeros((m, f_total), dtype=jnp.float32)
    for d in range(k):
        qd = q[:, d : d + 1]
        gap = jnp.maximum(jnp.maximum(lo[None, :, d] - qd, qd - hi[None, :, d]), 0.0)
        lb = lb + gap * gap

    score = jnp.min(lb, axis=0)                      # (F,) chunk-level bound
    _, sel = jax.lax.top_k(-score, b)                # one row — cheap sort
    cand = pts[sel].reshape(b * cap, k)              # ONE gather per chunk
    cand_ids = ids[sel].reshape(b * cap)
    if extras.shape[0]:
        cand = jnp.concatenate([cand, extras], axis=0)
        cand_ids = jnp.concatenate([cand_ids, extras_ids], axis=0)

    # Tile-align the candidate axis with replicas of candidate 0 (a real
    # point — exact for any data; ties resolve to the earlier real slot).
    tn = ref_tile(k)
    n_pad = layouts.round_up(cand.shape[0], tn)
    if n_pad != cand.shape[0]:
        reps = n_pad - cand.shape[0]
        cand = jnp.concatenate(
            [cand, jnp.broadcast_to(cand[0], (reps, k))], axis=0
        )
        cand_ids = jnp.concatenate(
            [cand_ids, jnp.broadcast_to(cand_ids[0], (reps,))], axis=0
        )
    best_d2, pos = _fused_on_prepared(
        q, cand.T, _TILE_M, tn, interpret_mode()
    )
    idx = cand_ids[pos]

    scanned = jnp.zeros((f_total,), bool).at[sel].set(True)
    unscanned_min = jnp.min(
        jnp.where(scanned[None, :], jnp.inf, lb), axis=1
    )
    ok = best_d2 * _CERT_MARGIN <= unscanned_min
    return idx.astype(jnp.int32), ok


@functools.partial(jax.jit, static_argnames=("budget",))
def _chunk_scan_many(qc, lo, hi, pts, ids, extras, extras_ids, budget: int):
    """ONE program for a staged queue of locality-sorted chunks (the
    _beam_query_many shape: lax.map + a single fetchable (C, 2, step)
    output)."""

    def step(qk):
        idx, ok = _chunk_scan_core(
            qk, lo, hi, pts, ids, extras, extras_ids, budget
        )
        return jnp.stack([idx, ok.astype(jnp.int32)], axis=0)

    return jax.lax.map(step, qc)


@functools.partial(jax.jit, static_argnames=("beam", "k_nn"))
def _beam_topk(q, lo, hi, pts, ids, valid, extras, extras_ids,
               beam: int, k_nn: int):
    """Exact k-NN over the beam buckets. Unlike the 1-NN path, pad replicas
    MUST be masked out (a replica would duplicate its bucket's first point
    in the top-k), hence the `valid` mask. Returns one packed (m, 2*k_nn+1)
    i32 array: [d2 bitcast to i32 | ids | certified] — i32 transit keeps
    both halves exact for a single host fetch."""
    m, k = q.shape
    f_total = lo.shape[0]
    cap = pts.shape[1]

    lb = jnp.zeros((m, f_total), dtype=jnp.float32)
    for d in range(k):
        qd = q[:, d : d + 1]
        gap = jnp.maximum(jnp.maximum(lo[None, :, d] - qd, qd - hi[None, :, d]), 0.0)
        lb = lb + gap * gap
    nb = min(beam, f_total)
    sel, thr = _select_buckets(lb, beam)

    cand = pts[sel]
    diff = q[:, None, None, :] - cand
    d2 = jnp.sum(diff * diff, axis=3)
    d2 = jnp.where(valid[sel], d2, jnp.inf).reshape(m, nb * cap)
    flat_ids = ids[sel].reshape(m, nb * cap)
    if extras.shape[0]:
        de = jnp.zeros((m, extras.shape[0]), dtype=jnp.float32)
        for d in range(k):
            dd = q[:, d : d + 1] - extras[None, :, d]
            de = de + dd * dd
        d2 = jnp.concatenate([d2, de], axis=1)
        flat_ids = jnp.concatenate(
            [flat_ids, jnp.broadcast_to(extras_ids[None, :], (m, extras.shape[0]))],
            axis=1,
        )
    # Iterative extraction instead of lax.top_k: a wide-row top_k with an
    # index payload lowers to a full row sort; k_nn unrolled argmin +
    # where-mask passes are cheap for small k.
    kk_nn = min(k_nn, d2.shape[1])
    cols = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
    rows = jnp.arange(m)
    d_parts, i_parts = [], []
    for _ in range(kk_nn):
        pos = jnp.argmin(d2, axis=1)
        d_parts.append(d2[rows, pos])
        i_parts.append(flat_ids[rows, pos])
        d2 = jnp.where(cols == pos[:, None], jnp.inf, d2)
    dists = jnp.stack(d_parts, axis=1)
    fids = jnp.stack(i_parts, axis=1)
    if kk_nn < k_nn:
        dists = jnp.pad(dists, ((0, 0), (0, k_nn - kk_nn)), constant_values=jnp.inf)
        fids = jnp.pad(fids, ((0, 0), (0, k_nn - kk_nn)))
    # Certificate: the k-th hit must beat every unscanned bucket's bound
    # (an infinite k-th distance means too few real candidates — uncertified).
    ok = dists[:, -1] * _CERT_MARGIN <= thr
    return jnp.concatenate(
        [
            jax.lax.bitcast_convert_type(dists, jnp.int32),
            fids.astype(jnp.int32),
            ok[:, None].astype(jnp.int32),
        ],
        axis=1,
    )


class BeamStagedQueries:
    """A query set staged for BeamIndex.query_staged_with_flags: the host
    copy (retry/fallback slicing, ORIGINAL order) and the chunked device
    copy — the upload moves OUT of the serving drain's timed region,
    mirroring MXUExpansion.stage_queries / CellListEngine.stage_queue.
    ``perm`` (device order -> original row) is the locality sort applied
    at staging for the chunk-scan path; None = identity."""

    __slots__ = ("q_np", "q_dev", "m", "perm")

    def __init__(self, q_np: np.ndarray, q_dev, m: int, perm=None):
        self.q_np = q_np
        self.q_dev = q_dev
        self.m = m
        self.perm = perm


@dataclasses.dataclass
class BeamIndex:
    """Device-resident frontier of one tree: query-many exact NN search."""

    refs: np.ndarray          # (n, k) original points (fallback scans use it)
    lo: jnp.ndarray           # (F, k) bucket box lower corners
    hi: jnp.ndarray           # (F, k)
    pts: jnp.ndarray          # (F, cap, k)
    ids: jnp.ndarray          # (F, cap) i32
    valid: jnp.ndarray        # (F, cap) bool — False on pad-replica slots
    extras: jnp.ndarray       # (E, k) — points stored above the frontier
    extras_ids: jnp.ndarray   # (E,) i32
    # Optional exact re-answer hook for uncertified rows (q_bad -> idx).
    # None = the direct fused device scan over self.refs. The high-k
    # adaptation ladder (api.py) points this at its retained v9 expansion
    # engine, which is strictly faster than the fused scan at k >= 8.
    exact_fallback: Any = None
    # Host descent table of the owning tree's splitting planes — (F-1,)
    # dims + thresholds over the implicit-heap internal nodes above the
    # frontier. Used ONLY as the staging locality key for the chunk-scan
    # drain (sorting queries by home bucket); None (octree frontiers)
    # degrades to unsorted staging, which only lowers chunk-scan coverage,
    # never correctness.
    desc_dim: Any = None      # (F-1,) int8/int32 numpy
    desc_thr: Any = None      # (F-1,) f32 numpy

    @classmethod
    def from_groups(
        cls,
        refs: np.ndarray,
        grouped_ids: np.ndarray,   # point ids concatenated bucket-by-bucket
        counts: np.ndarray,        # (F,) members per bucket
        extras_ids: np.ndarray,    # ids stored above the frontier (may be empty)
    ) -> "BeamIndex":
        refs = np.ascontiguousarray(refs, dtype=np.float32)
        f_total, k = len(counts), refs.shape[1]
        cap = max(8, round_up(int(counts.max()) if f_total else 1, 8))
        starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

        # Pad every bucket by replicating its first member (point 0 for empty
        # buckets) — replicas are real points, so scans stay exact; they can
        # only tie the true NN, never beat it.
        first = np.zeros(f_total, dtype=np.int64)
        nonempty = counts > 0
        first[nonempty] = grouped_ids[starts[:-1][nonempty]]
        ids = np.broadcast_to(first[:, None], (f_total, cap)).astype(np.int32).copy()
        bucket_of = np.repeat(np.arange(f_total), counts)
        pos = np.arange(len(grouped_ids)) - np.repeat(starts[:-1], counts)
        ids[bucket_of, pos] = grouped_ids
        pts = refs[ids]                                    # (F, cap, k)
        valid = np.zeros((f_total, cap), dtype=bool)
        valid[bucket_of, pos] = True

        # Tight boxes from the member points. grouped_ids is dense, so
        # consecutive NONEMPTY starts bound exactly one bucket's rows.
        lo = np.full((f_total, k), np.inf, dtype=np.float32)
        hi = np.full((f_total, k), -np.inf, dtype=np.float32)
        if nonempty.any():
            gp = refs[grouped_ids]
            ne_starts = starts[:-1][nonempty]
            lo[nonempty] = np.minimum.reduceat(gp, ne_starts, axis=0)
            hi[nonempty] = np.maximum.reduceat(gp, ne_starts, axis=0)

        extras_ids = np.asarray(extras_ids, dtype=np.int32)
        extras = refs[extras_ids] if len(extras_ids) else np.zeros((0, k), np.float32)
        dev = jax.device_put(
            (jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(pts),
             jnp.asarray(ids), jnp.asarray(valid), jnp.asarray(extras),
             jnp.asarray(extras_ids))
        )
        jax.block_until_ready(dev)
        return cls(refs, *dev)

    # -- query --------------------------------------------------------------

    def home_buckets(self, q: np.ndarray) -> np.ndarray:
        """Host descent to each query's home frontier bucket (the staging
        locality key). Requires the desc tables; vectorized over rows —
        log2(F) gather+compare passes."""
        m = q.shape[0]
        t = int(self.lo.shape[0]).bit_length() - 1
        s = np.ones(m, dtype=np.int64)
        rows = np.arange(m)
        for _ in range(t):
            d = self.desc_dim[s]
            s = 2 * s + (q[rows, d] > self.desc_thr[s])
        return (s - (1 << t)).astype(np.int64)

    def stage_queries(
        self, queries: np.ndarray, chunk_m: int | None = None
    ) -> BeamStagedQueries:
        """Pre-stage a query set on device for the serving drain (the
        host->device upload leaves the timed region). Chunk shapes are
        quantized to powers of two so retry tails and odd batch sizes don't
        compile a fresh program per size. When the frontier carries a
        descent table, queries are sorted by home bucket first — the
        locality grouping the chunk-scan drain's shared candidate set
        depends on (answers are unsorted back to caller order at decode,
        so the sort is invisible to every caller). ``chunk_m`` overrides
        the queries-per-chunk default (_CHUNK_M): smaller chunks
        concentrate the locality sort — each chunk's bucket union shrinks,
        so the chunk scan covers at a smaller budget — at the price of
        more per-chunk selection/gather overhead."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        m = q.shape[0]
        perm = None
        q_sorted = q
        if self.desc_dim is not None and m > 1:
            perm = np.argsort(self.home_buckets(q), kind="stable")
            q_sorted = q[perm]
        step = min(chunk_m or _CHUNK_M, pow2_at_least(max(m, 8)))
        chunks = -(-m // step)
        pad = chunks * step - m
        if pad:
            # Replicate the LAST query instead of zero-padding: the chunk
            # scan's bucket score is a min over the chunk's rows, and a
            # zero row would drag the shared candidate set toward the
            # origin corner (replicas keep it locality-pure; pad rows are
            # sliced off at decode either way).
            qpad = np.concatenate(
                [q_sorted, np.repeat(q_sorted[-1:], pad, axis=0)], axis=0
            )
        else:
            qpad = q_sorted
        qdev = jnp.asarray(qpad.reshape(chunks, step, q.shape[1]))  # ONE upload
        return BeamStagedQueries(q, qdev, m, perm)

    @staticmethod
    def _decode(out: np.ndarray, st: BeamStagedQueries):
        """(C, 2, step) i32 drain output -> (idx, ok) in CALLER order."""
        step = out.shape[2]
        idx = out[:, 0, :].reshape(-1)[: st.m].astype(np.int32)
        ok = out[:, 1, :].reshape(-1)[: st.m].astype(bool)
        if st.perm is not None:
            idx_o = np.empty_like(idx)
            ok_o = np.empty_like(ok)
            idx_o[st.perm] = idx
            ok_o[st.perm] = ok
            return idx_o, ok_o
        return idx, ok

    def query_staged_with_flags(self, st: BeamStagedQueries, beam: int = 8):
        """(idx, certified) for a pre-staged query set: ONE device program
        (lax.map over the staged chunks) + ONE host fetch, the serving-drain
        shape shared by every engine in this repo."""
        out = np.asarray(_beam_query_many(
            st.q_dev, self.lo, self.hi, self.pts, self.ids,
            self.extras, self.extras_ids, beam,
        ))  # (C, 2, step) i32 — the single round trip
        return self._decode(out, st)

    def query_staged_scan_with_flags(self, st: BeamStagedQueries,
                                     budget: int = 128):
        """(idx, certified) by the chunk-scan drain: one shared
        `budget`-bucket candidate set per locality-sorted chunk, scanned by
        the exact fused kernel (_chunk_scan_core), plus the unscanned-bucket
        certificate. Same one-dispatch/one-fetch drain shape."""
        out = np.asarray(_chunk_scan_many(
            st.q_dev, self.lo, self.hi, self.pts, self.ids,
            self.extras, self.extras_ids, budget,
        ))
        return self._decode(out, st)

    def query_with_flags(self, queries: np.ndarray, beam: int = 8):
        """(idx, certified); certified=False rows need an exact fallback
        (query_exact does it)."""
        return self.query_staged_with_flags(self.stage_queries(queries), beam)

    def query_staged_with_coverage(
        self, st: BeamStagedQueries, beam: int = 8, budget: int | None = None,
    ) -> tuple[np.ndarray, float]:
        """Exact answers plus the certified fraction for a pre-staged query
        set — the full serving answer in the timed region: base drain (the
        chunk-scan when ``budget`` is set, else the per-query beam form; one
        dispatch either way), then a wider beam retry for a dense
        uncertified tail, then the exact fallback for survivors (callers
        adapt engine choice on persistent misses)."""
        if budget is not None:
            idx, ok = self.query_staged_scan_with_flags(st, budget)
        else:
            idx, ok = self.query_staged_with_flags(st, beam)
        bad = np.flatnonzero(~ok)
        if len(bad) and self.lo.shape[0] > 4 * beam:
            # A structurally hard tail (clustered data, box-boundary
            # queries): one wider-beam dispatch usually certifies most of it
            # for far less than the tail's full scans.
            ri, ro = self.query_with_flags(st.q_np[bad], beam * 4)
            idx[bad] = ri
            ok[bad] = ro
            bad = np.flatnonzero(~ok)
        cov = float(ok.mean()) if len(ok) else 1.0
        if len(bad):
            if self.exact_fallback is not None:
                idx[bad] = np.asarray(
                    self.exact_fallback(st.q_np[bad])
                ).astype(np.int32)
            else:
                from nns.kernels.pallas_fused import fused_fallback

                idx[bad] = np.asarray(fused_fallback(st.q_np[bad], self.refs))
        return idx, cov

    def query_with_coverage(
        self, queries: np.ndarray, beam: int = 8, budget: int | None = None,
    ) -> tuple[np.ndarray, float]:
        """query_staged_with_coverage on a freshly-staged query set."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        return self.query_staged_with_coverage(self.stage_queries(q), beam, budget)

    def query_exact(self, queries: np.ndarray, beam: int = 8) -> np.ndarray:
        return self.query_with_coverage(queries, beam)[0]

    def query(self, queries: np.ndarray) -> np.ndarray:
        return self.query_exact(queries)

    def _topk_pass(self, q: np.ndarray, k_nn: int, beam: int):
        m = q.shape[0]
        step = min(_CHUNK_M, pow2_at_least(max(m, 8)))
        chunks = -(-m // step)
        qpad = np.pad(q, ((0, chunks * step - m), (0, 0)))
        qdev = jnp.asarray(qpad.reshape(chunks, step, q.shape[1]))  # ONE upload
        outs = [
            _beam_topk(
                qdev[c], self.lo, self.hi, self.pts, self.ids,
                self.valid, self.extras, self.extras_ids, beam, k_nn,
            )
            for c in range(chunks)
        ]
        packed = np.asarray(jnp.concatenate(outs, axis=0))[:m]  # one fetch
        d2 = packed[:, :k_nn].view(np.float32).copy()
        idx = packed[:, k_nn : 2 * k_nn].astype(np.int32)
        return d2, idx, packed[:, -1] != 0

    def query_topk(self, queries: np.ndarray, k_nn: int = 8, beam: int = 8):
        """Exact k-NN through the frontier: (dist2[m, k], idx[m, k])
        ascending. The k-th-distance certificate is harder to satisfy than
        1-NN's, so an uncertified tail retries at 4x beam before falling
        back to the exact chunked top-k scan."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        k_nn = min(k_nn, self.refs.shape[0])
        d2, idx, ok = self._topk_pass(q, k_nn, beam)
        bad = np.flatnonzero(~ok)
        if len(bad) and self.lo.shape[0] > 4 * beam:
            rd, ri, ro = self._topk_pass(q[bad], k_nn, beam * 4)
            d2[bad] = rd
            idx[bad] = ri
            ok[bad] = ro
            bad = np.flatnonzero(~ok)
        if len(bad):
            from nns.kernels.topk import nns_topk

            fd, fi = nns_topk(q[bad], self.refs, k_nn)
            d2[bad] = fd
            idx[bad] = fi
        return d2, idx

    # -- persistence (checkpoint subsystem, SURVEY.md §5) ------------------

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, refs=self.refs, beam_lo=np.asarray(self.lo),
            beam_hi=np.asarray(self.hi), beam_pts=np.asarray(self.pts),
            beam_ids=np.asarray(self.ids), beam_valid=np.asarray(self.valid),
            beam_extras=np.asarray(self.extras),
            beam_extras_ids=np.asarray(self.extras_ids),
        )

    @classmethod
    def load(cls, path: str) -> "BeamIndex":
        with np.load(path) as z:
            dev = jax.device_put(tuple(
                jnp.asarray(z[f"beam_{f}"])
                for f in ("lo", "hi", "pts", "ids", "valid", "extras", "extras_ids")
            ))
            jax.block_until_ready(dev)
            return cls(z["refs"], *dev)


# ---------------------------------------------------------------------------
# Frontier extraction per tree family
# ---------------------------------------------------------------------------


def kd_beam_index(tree, cap_target: int = 512) -> BeamIndex:
    """Frontier of the implicit-heap KD-tree: all subtrees rooted at heap
    depth T (F = 2^T buckets, T chosen so buckets hold ~cap_target points);
    the 2^T - 1 median points stored at shallower nodes become extras."""
    node_point = np.asarray(tree.node_point)
    slots = np.flatnonzero(node_point >= 0).astype(np.int64)
    pids = node_point[slots].astype(np.int64)
    n = len(pids)
    t = 0
    while (1 << t) * cap_target < n and (1 << t) < _MAX_F:
        t += 1
    # Heap depth of each slot, exactly: slot s = mantissa * 2^(depth+1).
    depth = (np.frexp(slots.astype(np.float64))[1] - 1).astype(np.int64)
    is_extra = depth < t
    extras_ids = pids[is_extra]
    shift = depth[~is_extra] - t
    bucket = (slots[~is_extra] >> shift) - (1 << t)
    order = np.argsort(bucket, kind="stable")
    grouped = pids[~is_extra][order].astype(np.int32)
    counts = np.bincount(bucket, minlength=1 << t)
    bi = BeamIndex.from_groups(tree.refs, grouped, counts, extras_ids)
    # Descent table over the internal nodes above the frontier (heap slots
    # 1 .. 2^t - 1): the chunk-scan drain's staging locality key
    # (BeamIndex.home_buckets). Empty slots keep (dim 0, thr 0) — descent
    # through them is an arbitrary but deterministic grouping, which only
    # affects sort quality, never correctness.
    node_dim = np.asarray(tree.node_dim)
    node_point = np.asarray(tree.node_point)
    desc_dim = np.zeros(1 << t, dtype=np.int64)
    desc_thr = np.zeros(1 << t, dtype=np.float32)
    internal = np.arange(1, 1 << t)
    have = internal[internal < len(node_point)]
    have = have[node_point[have] >= 0]
    desc_dim[have] = node_dim[have]
    desc_thr[have] = tree.refs[node_point[have], node_dim[have]]
    bi.desc_dim = desc_dim
    bi.desc_thr = desc_thr
    return bi


def octree_beam_index(tree, cap_target: int = 512) -> BeamIndex:
    """Frontier of the linearized octree: expand nodes while count > cap;
    depth-limited leaves larger than cap are chunked into several buckets
    (each chunk gets its own tight box). Octrees store points only at
    leaves, so there are no extras."""
    children, start, count = tree.children, tree.start, tree.count
    order = np.asarray(tree.order, dtype=np.int64)
    is_leaf = children.max(axis=1) < 0

    cap = cap_target
    while True:
        seg_start: list[int] = []
        seg_count: list[int] = []
        stack = [0]
        while stack:
            nid = stack.pop()
            c = int(count[nid])
            if c == 0:
                continue
            if c <= cap or is_leaf[nid]:
                s = int(start[nid])
                for off in range(0, c, cap):   # chunk oversized leaves
                    seg_start.append(s + off)
                    seg_count.append(min(cap, c - off))
            else:
                stack.extend(int(ch) for ch in children[nid] if ch >= 0)
        if len(seg_start) <= _MAX_F or cap >= len(order):
            break
        cap *= 2

    # Greedy merge of underfull neighbors: the expansion leaves many tiny
    # buckets (a split node's 8 children join the frontier even when 7 are
    # nearly empty), inflating F and with it the dense lb matrix. Frontier
    # ranges partition `order`, so sorting by start gives spatially-adjacent
    # DFS neighbors; merging consecutive ranges up to cap keeps boxes local
    # while shrinking F toward n/cap. Merged boxes are computed from their
    # member points like any other bucket — exactness is unaffected.
    so = np.argsort(np.asarray(seg_start, dtype=np.int64))
    s_sorted = np.asarray(seg_start, dtype=np.int64)[so]
    c_sorted = np.asarray(seg_count, dtype=np.int64)[so]
    m_start: list[int] = []
    m_count: list[int] = []
    for s, c in zip(s_sorted.tolist(), c_sorted.tolist()):
        if m_count and m_count[-1] + c <= cap:
            m_count[-1] += c
        else:
            m_start.append(s)
            m_count.append(c)
    s_arr = np.asarray(m_start, dtype=np.int64)
    c_arr = np.asarray(m_count, dtype=np.int64)
    total = int(c_arr.sum())
    offs = np.arange(total) - np.repeat(np.cumsum(c_arr) - c_arr, c_arr)
    grouped = order[np.repeat(s_arr, c_arr) + offs].astype(np.int32)
    return BeamIndex.from_groups(
        tree.refs, grouped, c_arr, np.zeros(0, dtype=np.int32)
    )
