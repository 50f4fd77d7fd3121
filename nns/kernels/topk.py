"""Exact k-nearest-neighbors (top-k) — beyond the reference's 1-NN.

The reference ladder answers only 1-NN (all 14 versions return a single
index per query, core.cu:23-29). The driver's benchmark configs also name a
k-NN workload ("1M clustered 3-D refs, k=8 NN", BASELINE.md), so the
framework exposes exact top-k:

- ``nns_topk``: chunked direct-distance scan + running top-k merge. The
  (m, n) distance matrix is processed in reference-chunks of ``chunk_n``;
  per chunk a jax.lax.top_k, then a merged top-k of (running, chunk)
  candidates — memory bounded by m * (k_nn + chunk_n), exact for any n.
  Distances use the direct (q-r)^2 formula (oracle arithmetic class).

Results are sorted by (distance, index): equal distances order by lower
reference index first, matching the 1-NN tie-break convention.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _direct_d2(q, r):
    # (m, chunk) distances by per-dim broadcast (XLA fuses; no (m, c, k)).
    m, k = q.shape
    d2 = jnp.zeros((m, r.shape[0]), dtype=jnp.float32)
    for d in range(k):
        diff = q[:, d, None] - r[None, :, d]
        d2 = d2 + diff * diff
    return d2


@functools.partial(jax.jit, static_argnames=("k_nn", "chunk_n"))
def _topk_scan(queries, refs, k_nn: int, chunk_n: int):
    m, k = queries.shape
    n = refs.shape[0]
    n_chunks = -(-n // chunk_n)
    n_pad = n_chunks * chunk_n
    refs_p = jnp.pad(refs, ((0, n_pad - n), (0, 0)), constant_values=1e6)

    def body(carry, ci):
        best_d, best_i = carry  # (m, k_nn) each
        r = jax.lax.dynamic_slice_in_dim(refs_p, ci * chunk_n, chunk_n, axis=0)
        d2 = _direct_d2(queries, r)
        cd, cpos = jax.lax.top_k(-d2, min(k_nn, chunk_n))
        cidx = cpos + ci * chunk_n
        # Merge running and chunk candidates; sort by (distance, index) so
        # ties resolve to the lowest reference index.
        all_d = jnp.concatenate([best_d, -cd], axis=1)
        all_i = jnp.concatenate([best_i, cidx], axis=1)
        order = jnp.lexsort((all_i, all_d), axis=-1)[:, :k_nn]
        return (
            jnp.take_along_axis(all_d, order, axis=1),
            jnp.take_along_axis(all_i, order, axis=1),
        ), None

    init = (
        jnp.full((m, k_nn), jnp.inf, dtype=jnp.float32),
        jnp.zeros((m, k_nn), dtype=jnp.int32),
    )
    (best_d, best_i), _ = jax.lax.scan(body, init, jnp.arange(n_chunks))
    return best_d, best_i


def nns_topk(queries, refs, k_nn: int = 8, chunk_n: int = 65536):
    """Exact k-NN: returns (dist2[m, k_nn] f32, idx[m, k_nn] i32), sorted by
    ascending distance with lowest-index tie-break. k_nn is clamped to n."""
    from nns.kernels.pallas_fused import stage_inputs

    if isinstance(refs, np.ndarray):
        refs = np.atleast_2d(refs)
    queries, refs = stage_inputs(np.atleast_2d(np.asarray(queries)), refs)
    refs = jnp.asarray(refs, dtype=jnp.float32)
    n = refs.shape[0]
    k_nn = min(k_nn, n)
    d, i = _topk_scan(queries, refs, k_nn, min(chunk_n, max(n, k_nn)))
    return np.asarray(d), np.asarray(i)
