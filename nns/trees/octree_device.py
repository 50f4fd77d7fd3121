"""Device octree query — the v13 analog.

The reference's GPU octree (core.cu:1661-1898) passes the root node by value
into a kernel whose body is commented out (core.cu:1793-1794), returning
zeros. Run literally as a batched `lax.while_loop` stack machine, that
traversal is latency-bound; here it is the dense beam frontier search
(trees/beam.py) instead: maximal <= cap-point
subtrees become boxed buckets (their tight point boxes prune harder than
the octree cubes), each query scans its `beam` nearest buckets exactly and
certifies against the (beam+1)-th bound. The host stack machine remains in
octree.py (v12) as the reference-shaped algorithm.
"""

from __future__ import annotations

import numpy as np


def octree_query_device(tree, queries, beam: int = 8) -> np.ndarray:
    """Exact batched device query through the tree's beam frontier index.
    A too-small beam only shrinks certificate coverage — uncertified
    queries are re-answered by the exact fused scan, never returned wrong."""
    return tree.device_index().query_exact(queries, beam=beam)


def nns_octree_device(queries, refs, max_depth: int = 9) -> np.ndarray:
    """v13: octree host build + batched device query. k != 3 falls back
    to an exact full scan as in the reference (core.cu:1882-1885 routes to
    v0's host loop) — but on the staged fused device kernel, matching
    v11's policy (kdtree_device.py): the contract is "exact fallback",
    and at k=16 n=1M the host scan is orders of magnitude slower than the
    device scan for the same exactness."""
    if refs.shape[1] != 3:
        from nns.kernels.pallas_fused import fused_fallback

        return np.asarray(fused_fallback(queries, refs))
    from nns.trees.octree import Octree

    return octree_query_device(Octree.build(refs, max_depth=max_depth), queries)
