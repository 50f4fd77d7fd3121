"""Octree: host build + batched query — the v12 analog (and v13's base).

Reference (core.cu:1453-1659): 3-D only (k != 3 falls back to brute force,
core.cu:1641-1644); pointer-based nodes {8 children, center, radius = half
max extent, depth, point list}; octant assignment by 3 sign bits
((p[j] > c[j]) << j, core.cu:1549-1552); leaf when depth > 9 or <= 1 point
(core.cu:1557-1559); queries prune siblings by axis distance.

Deliberate deviations (documented per SURVEY.md §2.1.4 and §7 B6):
- The reference's query visits only the query's own octant plus its 3
  face-adjacent siblings (core.cu:1587-1609) — a heuristic that can MISS the
  true nearest neighbor in edge/corner cases, and its point indexing has a
  stride bug. This rebuild must be exact, so the query is a proper
  best-first DFS over ALL children pruned by cube distance
  (sum_d max(0, |q_d - c_d| - radius)^2 <= true distance), which is
  guaranteed exact.
- Nodes are a linearized array (children table + center/radius + leaf point
  ranges over one permutation array) instead of heap pointers — the layout
  a device traversal needs.

The batched stackless traversal (host numpy here; jitted device twin in
octree_device.py) adds a per-query *scan mode*: popping a leaf switches the
query to scanning its point range CHUNK-at-a-time while other queries keep
traversing — the vectorized replacement for the reference's per-leaf scan
loop (core.cu:1613-1624).
"""

from __future__ import annotations

import dataclasses

import numpy as np

_CHUNK = 16  # leaf points scanned per traversal step


@dataclasses.dataclass
class Octree:
    refs: np.ndarray       # (n, 3) f32, original order
    children: np.ndarray   # (n_nodes, 8) i32, -1 = absent
    center: np.ndarray     # (n_nodes, 3) f32
    radius: np.ndarray     # (n_nodes,) f32 — cube half extent
    start: np.ndarray      # (n_nodes,) i32 — range into `order`
    count: np.ndarray      # (n_nodes,) i32
    order: np.ndarray      # (n,) i32 — points grouped by subtree
    max_depth: int

    @classmethod
    def build(cls, refs: np.ndarray, max_depth: int = 9) -> "Octree":
        refs = np.ascontiguousarray(refs, dtype=np.float32)
        n, k = refs.shape
        if k != 3:
            raise ValueError("octree requires 3-D points")
        from nns.native import native_octree_build

        native = native_octree_build(refs, max_depth)
        if native is not None:
            children, centers, radii, starts, counts, order = native
            return cls(refs, children, centers, radii, starts, counts, order, max_depth)
        return cls._build_numpy(refs, max_depth)

    @staticmethod
    def _tight_geometry(lo: np.ndarray, hi: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(center f32, radius f32) for point boxes (S, 3) lo/hi in f64.

        Node geometry is derived from each node's OWN points, never halved
        from the parent cube: at large coordinate magnitudes the f32
        rounding of a halved center exceeds deep-node nominal radii, and
        the query's cube-distance prune becomes unsound (range-robustness
        fuzz). The radius is inflated by a few ulps of the coordinate
        magnitude so |q - c| - r stays a true lower bound under f32 query
        arithmetic; tight boxes also prune strictly harder than nominal
        octant cubes. Mirrors oct_node_geom in native/nns_cpu.cpp."""
        cen = ((lo + hi) * 0.5).astype(np.float32)
        c64 = cen.astype(np.float64)
        radd = np.maximum(hi - c64, c64 - lo).max(axis=1)
        cmag = np.abs(c64).max(axis=1)
        rad = (radd + 1.2e-6 * (cmag + radd) + 1e-30).astype(np.float32)
        return cen, rad

    @classmethod
    def _build_numpy(cls, refs: np.ndarray, max_depth: int = 9) -> "Octree":
        n, k = refs.shape

        r64 = refs.astype(np.float64)
        root_c, root_r = cls._tight_geometry(
            r64.min(axis=0, keepdims=True), r64.max(axis=0, keepdims=True)
        )

        order = np.arange(n, dtype=np.int32)
        # Per-level pending segments (ranges into `order`).
        beg = np.array([0], dtype=np.int64)
        end = np.array([n], dtype=np.int64)
        cen = root_c
        rad = root_r

        children_out: list[np.ndarray] = []
        center_out: list[np.ndarray] = [cen]
        radius_out: list[np.ndarray] = [rad]
        start_out: list[np.ndarray] = [beg.astype(np.int32)]
        count_out: list[np.ndarray] = [(end - beg).astype(np.int32)]
        next_id = 1
        depth = 0

        while len(beg):
            counts = end - beg
            split = (depth < max_depth) & (counts > 1)
            S = len(beg)
            child_tbl = np.full((S, 8), -1, dtype=np.int32)

            si = np.flatnonzero(split)
            if len(si):
                sb, se, sc = beg[si], end[si], cen[si]
                lens = se - sb
                total = int(lens.sum())
                segid = np.repeat(np.arange(len(si)), lens)
                pos = np.repeat(sb, lens) + (np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens))
                pts = refs[order[pos]]
                # Octant bits: (p[j] > c[j]) << j (core.cu:1549-1552).
                oct_ = ((pts > sc[segid]) * np.array([1, 2, 4], dtype=np.int32)).sum(axis=1)
                perm = np.lexsort((oct_, segid))
                order[pos] = order[pos][perm]

                occ = np.bincount(segid * 8 + oct_, minlength=len(si) * 8).reshape(len(si), 8)
                offs = np.concatenate([np.zeros((len(si), 1), dtype=np.int64), np.cumsum(occ, axis=1)[:, :-1]], axis=1)
                cb = sb[:, None] + offs          # (Si, 8) child begs
                ce_ = cb + occ                   # child ends
                nonempty = occ > 0
                n_new = int(nonempty.sum())
                ids = np.full((len(si), 8), -1, dtype=np.int32)
                ids[nonempty] = next_id + np.arange(n_new, dtype=np.int32)
                next_id += n_new
                child_tbl[si] = ids

                flat = nonempty.reshape(-1)
                nb = cb.reshape(-1)[flat]
                ne = ce_.reshape(-1)[flat]

                # Child geometry: tight per-child point boxes (see
                # _tight_geometry). Child ranges are consecutive in the
                # permuted flat point array, so one reduceat per bound.
                pts_s = pts[perm].astype(np.float64)
                seg_off = (np.cumsum(lens) - lens)[:, None]
                flat_starts = (seg_off + (cb - sb[:, None])).reshape(-1)[flat]
                lo = np.minimum.reduceat(pts_s, flat_starts, axis=0)
                hi = np.maximum.reduceat(pts_s, flat_starts, axis=0)
                nc, nr = cls._tight_geometry(lo, hi)

                center_out.append(nc)
                radius_out.append(nr)
                start_out.append(nb.astype(np.int32))
                count_out.append((ne - nb).astype(np.int32))

                beg, end, cen, rad = nb, ne, nc, nr
            else:
                beg = np.empty(0, dtype=np.int64)

            children_out.append(child_tbl)
            depth += 1

        return cls(
            refs=refs,
            children=np.concatenate(children_out, axis=0),
            center=np.concatenate(center_out, axis=0),
            radius=np.concatenate(radius_out, axis=0),
            start=np.concatenate(start_out, axis=0),
            count=np.concatenate(count_out, axis=0),
            order=order,
            max_depth=max_depth,
        )

    def stack_cap(self) -> int:
        return 8 * (self.max_depth + 2)

    # -- host query (v12) --------------------------------------------------

    def query_host(self, queries: np.ndarray) -> np.ndarray:
        """Batched CPU traversal (v12). Native C++/OpenMP DFS when available
        (the reference also parallelizes octree queries with OpenMP,
        core.cu:1654-1657); else the vectorized numpy scan-mode traversal."""
        from nns.native import native_octree_query

        out = native_octree_query(self, queries)
        if out is not None:
            return out
        q = np.ascontiguousarray(queries, dtype=np.float32)
        m = q.shape[0]
        rows = np.arange(m)
        cap = self.stack_cap()
        children, center, radius = self.children, self.center, self.radius
        start, count, order, refs = self.start, self.count, self.order, self.refs
        is_leaf = children.max(axis=1) < 0

        stack_n = np.zeros((m, cap), dtype=np.int32)
        stack_b = np.zeros((m, cap), dtype=np.float32)
        sp = np.ones(m, dtype=np.int64)  # root (node 0) pre-pushed, bound 0
        best_d = np.full(m, np.inf, dtype=np.float32)
        best_i = np.zeros(m, dtype=np.int32)
        scan_pos = np.zeros(m, dtype=np.int64)
        scan_end = np.zeros(m, dtype=np.int64)

        while True:
            scanning = scan_pos < scan_end
            if not (scanning.any() or (sp > 0).any()):
                break

            # -- scan step for queries inside a leaf ----------------------
            if scanning.any():
                offs = np.arange(_CHUNK, dtype=np.int64)
                idxs = scan_pos[:, None] + offs[None, :]
                in_rng = (idxs < scan_end[:, None]) & scanning[:, None]
                safe = np.where(in_rng, idxs, 0)
                pnts = order[safe]                       # (m, CHUNK)
                diff = q[:, None, :] - refs[pnts]        # (m, CHUNK, 3)
                d2 = np.einsum("mcd,mcd->mc", diff, diff)
                d2 = np.where(in_rng, d2, np.inf)
                cmin = d2.min(axis=1)
                carg = pnts[rows, d2.argmin(axis=1)]
                better = scanning & (cmin < best_d)
                best_d = np.where(better, cmin, best_d)
                best_i = np.where(better, carg.astype(np.int32), best_i)
                scan_pos = np.where(scanning, np.minimum(scan_pos + _CHUNK, scan_end), scan_pos)

            # -- pop step for traversing queries ---------------------------
            popping = (~(scan_pos < scan_end)) & (sp > 0)
            if popping.any():
                top = np.maximum(sp - 1, 0)
                node = np.where(popping, stack_n[rows, top], 0)
                bound = stack_b[rows, top]
                sp = sp - popping

                process = popping & (bound < best_d)
                leaf = process & is_leaf[node]
                scan_pos = np.where(leaf, start[node].astype(np.int64), scan_pos)
                scan_end = np.where(leaf, (start[node] + count[node]).astype(np.int64), scan_end)

                inner = process & ~is_leaf[node]
                ch = children[node]                         # (m, 8)
                ch_valid = (ch >= 0) & inner[:, None]
                safe_ch = np.where(ch_valid, ch, 0)
                cc = center[safe_ch]                        # (m, 8, 3)
                cr = radius[safe_ch]                        # (m, 8)
                gap = np.abs(q[:, None, :] - cc) - cr[:, :, None]
                gap = np.maximum(gap, 0.0)
                cbound = np.einsum("mcd,mcd->mc", gap, gap).astype(np.float32)
                cbound = np.where(ch_valid & (cbound < best_d[:, None]), cbound, np.inf)
                # Push in descending-bound order so the nearest child pops first.
                ord8 = np.argsort(-cbound, axis=1)
                for j in range(8):
                    cj = ord8[:, j]
                    bj = cbound[rows, cj]
                    nj = safe_ch[rows, cj]
                    push = np.isfinite(bj)
                    slot = sp
                    stack_n[rows, slot] = np.where(push, nj, stack_n[rows, slot])
                    stack_b[rows, slot] = np.where(push, bj, stack_b[rows, slot])
                    sp = sp + push

        return best_i

    def query_device(self, queries: np.ndarray) -> np.ndarray:
        from nns.trees.octree_device import octree_query_device

        return octree_query_device(self, queries)

    def device_index(self):
        """Lazily-built, cached beam frontier index (trees/beam.py) — the
        device-resident form of this tree for batched exact queries."""
        if getattr(self, "_beam", None) is None:
            from nns.trees.beam import octree_beam_index

            self._beam = octree_beam_index(self)
        return self._beam

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, refs=self.refs, children=self.children, center=self.center,
            radius=self.radius, start=self.start, count=self.count,
            order=self.order, max_depth=np.int64(self.max_depth),
        )

    @classmethod
    def load(cls, path: str) -> "Octree":
        with np.load(path) as z:
            return cls(
                z["refs"], z["children"], z["center"], z["radius"],
                z["start"], z["count"], z["order"], int(z["max_depth"]),
            )


def nns_octree_host(queries: np.ndarray, refs: np.ndarray, max_depth: int = 9) -> np.ndarray:
    """v12: octree host build + host query; k != 3 falls back to the linear
    scan (reference contract, core.cu:1641-1644)."""
    if refs.shape[1] != 3:
        from nns.kernels.oracle import linear_scan

        return linear_scan(queries, refs)
    return Octree.build(refs, max_depth=max_depth).query_host(queries)
