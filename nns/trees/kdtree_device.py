"""Device KD-tree query — the v11 analog.

The reference's GPU KD-tree (core.cu:1289-1451) builds on the CPU, copies
the flat tree to the device, and launches a per-query recursive traversal —
whose kernel body is commented out (core.cu:1345), so it returns zeros.

Run literally as a batched `lax.while_loop` stack machine (one node pop per
step), that traversal is latency-bound and slower than the same algorithm on
the host. Here it is the dense beam frontier search (trees/beam.py) instead:
the tree's depth-T subtrees become boxed point
buckets, every query ranks ALL buckets by box distance in one dense op,
scans its `beam` nearest exactly, and certifies the winner against the
(beam+1)-th bound; the host stack machine remains in kdtree.py (v10) as the
reference-shaped algorithm.
"""

from __future__ import annotations

import numpy as np


def kd_query_device(tree, queries, beam: int = 8) -> np.ndarray:
    """Exact batched device query through the tree's beam frontier index.
    A too-small beam only shrinks certificate coverage — uncertified
    queries are re-answered by the exact fused scan, never returned wrong."""
    return tree.device_index().query_exact(queries, beam=beam)


def nns_kdtree_device(queries, refs, max_k: int = 16) -> np.ndarray:
    """v11: KD-tree host build + batched device query; k > max_k falls
    back to the linear scan (reference contract, core.cu:1435-1436), and
    6 < k <= max_k to the fused device kernel — high-dimensional KD pruning
    degenerates toward a full scan, which the dense kernel does far faster
    (capability dispatch, SURVEY.md §5)."""
    if refs.shape[1] > max_k:
        from nns.kernels.oracle import linear_scan

        return linear_scan(queries, refs)
    if refs.shape[1] > 6:
        # fused_fallback device_puts the refs FIRST, so a large numpy
        # reference set takes one plain transfer instead of the jit
        # argument path.
        from nns.kernels.pallas_fused import fused_fallback

        return np.asarray(fused_fallback(queries, refs))
    from nns.trees.kdtree import KDTree

    return kd_query_device(KDTree.build(refs), queries)
