"""XLA-level brute force: the v1/v2 analogs.

Reference:
- v1 (core.cu:56-152): kernel 1 materializes the full m x n distance matrix,
  kernel 2 argmin-reduces each row with a shared-memory butterfly.
- v2 (core.cu:154-200): same distance kernel, argmin via thrust::min_element.

Here the "two kernels" become two XLA ops. ``nns_distance_matrix`` computes
distances by per-dimension broadcast (identical arithmetic to the f32 scan,
so exact) followed by a row argmin; XLA fuses the distance chain into the
reduction, so the (m, n) matrix is not stored, but each query row streams
the whole reference set on its own — the fused kernel (v3+) reuses every
reference tile across a query tile instead. ``nns_expansion_matmul`` uses
the library GEMM: d2 = |q|^2 - 2 q r^T + |r|^2, a (m,k)@(k,n) product with
HIGHEST precision (full f32, never TF32) — faster for large k, but the
expansion loses ~1e-7 absolute precision on values, which misranks at
1M-point densities (see SURVEY.md §7 hard part 4). v2 therefore re-ranks
the top-L expansion candidates with exact direct-formula arithmetic and
carries a certificate that the true NN is inside the candidate set,
falling back to the v1 scan when it is not. Row argmins use XLA's
reduction (lowest-index ties).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("chunk_m",))
def _distance_matrix_idx(queries: jnp.ndarray, refs: jnp.ndarray, chunk_m: int = 0) -> jnp.ndarray:
    # Per-dimension broadcast accumulation: XLA fuses the subtract/square/add
    # chain, so only the (m, n) matrix is materialized, never (m, n, k).
    m, k = queries.shape
    n = refs.shape[0]
    d2 = jnp.zeros((m, n), dtype=jnp.float32)
    for d in range(k):
        diff = queries[:, d, None] - refs[None, :, d]
        d2 = d2 + diff * diff
    return jnp.argmin(d2, axis=1).astype(jnp.int32)


def nns_distance_matrix(queries: jnp.ndarray, refs: jnp.ndarray) -> jnp.ndarray:
    """v1: XLA distance + row argmin. Exact (direct f32)."""
    from nns.kernels.pallas_fused import stage_inputs

    queries, refs = stage_inputs(queries, refs)
    return _distance_matrix_idx(queries, refs)


@partial(jax.jit, static_argnames=("refine_l",))
def _expansion_idx(
    queries: jnp.ndarray, refs: jnp.ndarray, refine_l: int = 8
) -> tuple[jnp.ndarray, jnp.ndarray]:
    q = queries.astype(jnp.float32)
    r = refs.astype(jnp.float32)
    n = r.shape[0]
    l = min(refine_l, n)
    # -2 q r^T by the library GEMM; HIGHEST precision keeps it in full f32
    # (a default-precision f32 product may run in TF32, ~3 digits).
    cross = jax.lax.dot_general(
        q, r,
        dimension_numbers=(((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    r2 = jnp.sum(r * r, axis=1)
    # |q|^2 is constant per row — it cannot change the row argmin, so skip it
    # (same observation the reference's fused kernels exploit implicitly).
    e = r2[None, :] - 2.0 * cross
    # The expansion form carries O(eps * scale^2) rounding that the direct
    # (q-r)^2 form does not — at 1M-point densities it misranks (~1.6% of
    # queries at k=3).  Refine: take the L expansion-smallest candidates and
    # re-rank them with exact direct-f32 arithmetic (lowest index on ties).
    neg_vals, cand = jax.lax.top_k(-e, l)
    vals = -neg_vals  # ascending expansion values, (m, l)
    diff = q[:, None, :] - r[cand]  # (m, l, k)
    d2x = jnp.sum(diff * diff, axis=-1)
    min_d = jnp.min(d2x, axis=1, keepdims=True)
    best = jnp.min(jnp.where(d2x == min_d, cand, n), axis=1).astype(jnp.int32)
    # Exactness certificate: |e_i - (x_i - |q|^2)| <= delta for every point,
    # so the true NN's expansion value is <= vals[0] + 2*delta; if even the
    # L-th kept value exceeds that band, no excluded point can be the true
    # NN.  delta is a conservative data-derived rounding bound.
    scale = jnp.max(r2) + jnp.max(jnp.sum(q * q, axis=1))
    delta = jnp.float32(32.0 * 1.1920929e-7) * scale
    cert = vals[:, -1] > vals[:, 0] + 2.0 * delta
    return best, cert


def nns_expansion_matmul(queries: jnp.ndarray, refs: jnp.ndarray) -> jnp.ndarray:
    """v2: expansion matmul + top-L exact refine + XLA row argmin.

    Queries whose candidate-set certificate fails (more than L points inside
    the expansion rounding band — duplicate-heavy data) fall back to the
    exact v1 direct-formula scan, preserving the package exactness contract.
    """
    import numpy as np

    idx, cert = _expansion_idx(jnp.asarray(queries), jnp.asarray(refs))
    cert = np.asarray(cert)
    if cert.all():
        return idx
    idx = np.asarray(idx).copy()
    bad = np.flatnonzero(~cert)
    idx[bad] = np.asarray(
        _distance_matrix_idx(jnp.asarray(queries)[bad], jnp.asarray(refs))
    )
    return jnp.asarray(idx)
