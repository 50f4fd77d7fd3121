"""KD-tree: host build + batched stackless query — the v10/v11 analog.

Reference (core.cu:1059-1163): implicit-heap KD-tree in two int arrays
``p``/``dim`` of size 4n (core.cu:1080); split dimension = max variance
(core.cu:1096-1108); median split via nth_element (core.cu:1109-1111);
recursive best-first query with hypersphere-vs-hyperplane pruning
(core.cu:1123-1138); k > 16 falls back to brute force (core.cu:1148-1149).

Differences from the reference (SURVEY.md §7 B5):
- The build is **vectorized level-wise** (one lexsort + segmented reductions
  per tree level) instead of per-node recursion — O(n log^2 n) numpy work,
  no Python recursion over 2n nodes.
- The query is **stackless, batched, iterative**: every query carries an
  explicit (node, lower-bound) stack in fixed-size arrays; one loop step
  pops one node per active query, updates the running best, and pushes the
  near/far children with the hyperplane-distance bound — the traversal the
  reference's GPU version intended but never ran (core.cu:1345). The device
  query (v11, kdtree_device.py) uses the dense beam frontier instead.

Layout: node ids are 1-based heap ranks (root = 1, children 2r/2r+1);
``node_point[r]`` = reference-point index stored at node r (-1 = empty
slot), ``node_dim[r]`` = its split dimension. A node's point is the median
of its subtree along node_dim: left subtree strictly below-or-tied, right
subtree above-or-tied (stable median partition).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _heap_size(n: int) -> int:
    size = 1
    while size < max(n, 1):
        size *= 2
    return 4 * size  # same 4n bound the reference allocates (core.cu:1080)


@dataclasses.dataclass
class KDTree:
    refs: np.ndarray         # (n, k) f32, original point order
    node_point: np.ndarray   # (heap_len,) i32, -1 = empty
    node_dim: np.ndarray     # (heap_len,) i32
    depth: int               # number of levels actually built

    @classmethod
    def build(cls, refs: np.ndarray) -> "KDTree":
        refs = np.ascontiguousarray(refs, dtype=np.float32)
        from nns.native import native_kd_build

        native = native_kd_build(refs)
        if native is not None:
            perm, dims = native
            heap_len = _heap_size(refs.shape[0])
            node_point = np.full(heap_len, -1, dtype=np.int32)
            node_dim = np.zeros(heap_len, dtype=np.int32)
            node_point[: len(perm)] = perm
            node_dim[: len(dims)] = dims
            depth = int(np.ceil(np.log2(max(refs.shape[0], 2)))) + 2
            return cls(refs, node_point, node_dim, depth)
        return cls._build_numpy(refs)

    @classmethod
    def _build_numpy(cls, refs: np.ndarray) -> "KDTree":
        n, k = refs.shape
        heap_len = _heap_size(n)
        node_point = np.full(heap_len, -1, dtype=np.int32)
        node_dim = np.zeros(heap_len, dtype=np.int32)

        order = np.arange(n, dtype=np.int64)
        beg = np.array([0], dtype=np.int64)
        end = np.array([n], dtype=np.int64)
        nodes = np.array([1], dtype=np.int64)
        depth = 0

        while len(nodes):
            depth += 1
            lengths = end - beg
            n_segs = len(nodes)
            segid = np.repeat(np.arange(n_segs), lengths)
            pts = refs[order]  # (n_active, k) f64-safe in f32

            # Split dim = max variance within each segment (core.cu:1096-1108
            # behavior), via segmented sums.
            sums = np.add.reduceat(pts.astype(np.float64), beg, axis=0)
            sqs = np.add.reduceat((pts.astype(np.float64)) ** 2, beg, axis=0)
            var = sqs - sums * sums / lengths[:, None]
            split_dim = var.argmax(axis=1).astype(np.int32)

            # Stable in-segment sort by the chosen dimension.
            keys = pts[np.arange(len(order)), split_dim[segid]]
            perm = np.lexsort((keys, segid))
            order = order[perm]

            mid = beg + lengths // 2
            node_point[nodes] = order[mid].astype(np.int32)
            node_dim[nodes] = split_dim

            # Children: left [beg, mid), right (mid, end); medians removed
            # from the packed order, so downstream begs shift by the number
            # of removed medians before them.
            removed_before = np.arange(n_segs, dtype=np.int64)
            lb, le = beg - removed_before, mid - removed_before
            rb, re = mid + 1 - removed_before - 1, end - removed_before - 1
            keep = np.ones(len(order), dtype=bool)
            keep[mid] = False
            order = order[keep]

            child_beg = np.stack([lb, rb], axis=1).reshape(-1)
            child_end = np.stack([le, re], axis=1).reshape(-1)
            child_node = np.stack([nodes * 2, nodes * 2 + 1], axis=1).reshape(-1)
            nonempty = child_end > child_beg
            beg, end, nodes = child_beg[nonempty], child_end[nonempty], child_node[nonempty]

        return cls(refs, node_point, node_dim, depth)

    # -- query ------------------------------------------------------------

    def stack_cap(self) -> int:
        return self.depth + 4

    def query_host(self, queries: np.ndarray) -> np.ndarray:
        """Batched CPU traversal (v10). Native C++/OpenMP per-query descent
        when available; else vectorized numpy stackless traversal (the
        reference queries serially on one thread, core.cu:1160-1161)."""
        from nns.native import native_kd_query

        out = native_kd_query(self.refs, queries, self.node_point, self.node_dim)
        if out is not None:
            return out
        q = np.ascontiguousarray(queries, dtype=np.float32)
        m, k = q.shape
        refs = self.refs
        node_point, node_dim = self.node_point, self.node_dim
        heap_len = len(node_point)
        cap = self.stack_cap()

        rows = np.arange(m)
        stack_n = np.zeros((m, cap), dtype=np.int64)
        stack_b = np.zeros((m, cap), dtype=np.float32)
        stack_n[:, 0] = 1  # root
        sp = np.ones(m, dtype=np.int64)
        best_d = np.full(m, np.inf, dtype=np.float32)
        best_i = np.zeros(m, dtype=np.int32)

        while (sp > 0).any():
            active = sp > 0
            top = np.maximum(sp - 1, 0)
            node = np.where(active, stack_n[rows, top], 0)
            bound = stack_b[rows, top]
            sp = sp - active

            process = active & (bound < best_d)
            pidx = node_point[node]           # node 0 slot holds -1
            valid = process & (pidx >= 0)
            safe_p = np.where(valid, pidx, 0)
            diff = q - refs[safe_p]
            d2 = np.einsum("ij,ij->i", diff, diff)
            better = valid & (d2 < best_d)
            best_d = np.where(better, d2, best_d)
            best_i = np.where(better, safe_p.astype(np.int32), best_i)

            ndim = node_dim[node]
            sv = refs[safe_p, ndim]
            delta = q[rows, ndim] - sv
            go_right = delta >= 0
            near = 2 * node + go_right
            far = 2 * node + (~go_right)
            near_ok = valid & (near < heap_len)
            far_ok = valid & (far < heap_len)
            near = np.where(near_ok, near, 0)
            far = np.where(far_ok, far, 0)
            near_ok &= node_point[near] >= 0
            far_ok &= node_point[far] >= 0

            # Push far (pruned by hyperplane distance), then near on top.
            far_bound = delta * delta
            push_far = far_ok & (far_bound < best_d)
            slot = sp
            stack_n[rows, slot] = np.where(push_far, far, stack_n[rows, slot])
            stack_b[rows, slot] = np.where(push_far, far_bound, stack_b[rows, slot])
            sp = sp + push_far

            push_near = near_ok
            slot = sp
            stack_n[rows, slot] = np.where(push_near, near, stack_n[rows, slot])
            stack_b[rows, slot] = np.where(push_near, bound, stack_b[rows, slot])
            sp = sp + push_near

        return best_i

    def query_device(self, queries: np.ndarray):
        from nns.trees.kdtree_device import kd_query_device

        return kd_query_device(self, queries)

    def device_index(self):
        """Lazily-built, cached beam frontier index (trees/beam.py) — the
        device-resident form of this tree for batched exact queries."""
        if getattr(self, "_beam", None) is None:
            from nns.trees.beam import kd_beam_index

            self._beam = kd_beam_index(self)
        return self._beam

    # -- persistence (SURVEY.md §5 checkpoint subsystem) -------------------

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, refs=self.refs, node_point=self.node_point,
            node_dim=self.node_dim, depth=np.int64(self.depth),
        )

    @classmethod
    def load(cls, path: str) -> "KDTree":
        with np.load(path) as z:
            return cls(z["refs"], z["node_point"], z["node_dim"], int(z["depth"]))


def nns_kdtree_host(queries: np.ndarray, refs: np.ndarray, max_k: int = 16) -> np.ndarray:
    """v10: KD-tree host build + host query; k > max_k falls back to the
    linear scan (reference contract, core.cu:1148-1149)."""
    if refs.shape[1] > max_k:
        from nns.kernels.oracle import linear_scan

        return linear_scan(queries, refs)
    return KDTree.build(refs).query_host(queries)
