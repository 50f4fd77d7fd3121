"""Array layout helpers — the v4 AoS->SoA analog (core.cu:293-306).

The reference transposes the reference set from point-major [n][k] to
dim-major [k][n] on the GPU for coalesced reads (mat_inv_kernel). Here the
same decision appears as: which layout do we hand XLA and the Pallas
kernels, and how do we pad to whole kernel tiles.

Padding contract: dimensions (k) are zero-padded on BOTH queries and refs —
appending zero coordinates to both sides leaves every pairwise distance
unchanged. Reference points (n) are padded by replicating the first real
point (see pad_refs: exact for any data range; replicas lose every
tie-break). Queries (m) are padded arbitrarily and the tail results sliced
off. PAD_SENTINEL remains for *distance/slot* padding (empty candidate
slots in the cell engine), where it is certificate-guarded, not for
reference-point coordinates.
"""

from __future__ import annotations

import jax.numpy as jnp

# A padded reference point at (BIG, BIG, ...) has distance >= BIG^2 to any
# real query in [0,1]^k — never the argmin. Kept well below f32 max so
# squared values don't overflow to inf (inf - inf traps in some reductions).
PAD_SENTINEL = 1e6


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def pad_dims(points: jnp.ndarray, k_mult: int) -> jnp.ndarray:
    """Zero-pad the trailing dim axis of (p, k) to a multiple of k_mult."""
    k = points.shape[1]
    kp = round_up(k, k_mult)
    if kp == k:
        return points
    return jnp.pad(points, ((0, 0), (0, kp - k)))


def pad_refs(refs: jnp.ndarray, n_mult: int) -> jnp.ndarray:
    """Pad the point axis of (n, k) to a multiple of n_mult by replicating
    the first reference point.

    Replicas are real points, so padding is exact for ANY data range — a
    fixed far-away sentinel coordinate can be *closer* than every real
    reference to a query outside the assumed range, returning an
    out-of-range index. Replicas sit at indices >= n, after the index-0
    original, so every argmin/merge path in the package (lowest-index XLA
    argmin, strict-< Pallas tile merges in ascending tile order,
    lowest-global-index sharded merge) resolves exact ties to the real
    index-0 copy, never a replica.
    """
    n = refs.shape[0]
    np_ = round_up(n, n_mult)
    if np_ == n:
        return refs
    pad = jnp.broadcast_to(refs[0], (np_ - n, refs.shape[1]))
    return jnp.concatenate([jnp.asarray(refs), pad], axis=0)


def pad_queries(queries: jnp.ndarray, m_mult: int) -> jnp.ndarray:
    """Zero-pad the query axis of (m, k) to a multiple of m_mult."""
    m = queries.shape[0]
    mp = round_up(m, m_mult)
    if mp == m:
        return queries
    return jnp.pad(queries, ((0, mp - m), (0, 0)))


def to_dim_major(points: jnp.ndarray) -> jnp.ndarray:
    """(p, k) point-major -> (k, p) dim-major (mat_inv_kernel analog)."""
    return points.T
