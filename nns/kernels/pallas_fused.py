"""Fused exact scan: squared distance and (min, lowest index) in one kernel.

Reference: V3 (core.cu:202-281) fuses the distance and the reduction in one
kernel, reducing in shared memory, so the m x n distance matrix is never
stored; V4 (core.cu:293-306) reads the refs dim-major for coalesced loads;
V5 (core.cu:382-477) streams them through the read-only path; V6
(core.cu:479-571) keeps the queries in constant memory; V7 (core.cu:573-698)
splits the reference axis across blocks when the queries alone cannot fill
the card, and reduces the per-block winners in a second pass.

On Hopper that whole ladder is one kernel, compiled through Pallas' Triton
route:

- one program per (query tile, reference split);
- the query tile (dim-major, TM queries) and a lane-wise running
  (min, tile) pair stay in registers for the whole program (V6);
- the program walks its reference range in a loop over dim-major TN-wide
  tiles (V4), which Triton software-pipelines through shared memory
  (``num_stages``, the successor of V5's read-only path);
- when the query tiles alone give too few programs to fill the card, the
  reference axis is split across programs (V7) and a small XLA reduction
  over the splits picks the winners.

The distance is the direct form sum_d (q_d - r_d)^2 in f32, the same
arithmetic as the f32 oracle scan, so the answers are exact (no expansion
error). Tie-break: the lowest reference index — within a lane by a
strict-< update in ascending tile order, across the lanes of a tile by the
lowest global index among the lanes' minima, and across splits by an argmin
that keeps the lowest split.

Measured on an H100 (PERF.md): 6.2 ms at k = 3 and 35.9 ms at k = 16 for
10K queries x 1M refs, against 14.9 and 233 ms for XLA's fused distance +
argmin (v1), which streams the whole reference set once per query row.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from nns.kernels import layouts

_TILE_M = 64       # queries per program (at most; see fused_plan)
_TILE_N = 128      # reference points per loop step
_MIN_TILE_M = 16   # smallest query tile (m = 1 pads to it)
_WARPS = 8
_STAGES = 3
# Registers a thread may spend on its query rows. Triton lays the (TM, TN)
# tile out with the warps along TM, so a thread holds TM / _WARPS rows of k
# coordinates each; past this budget the kernel spills (on an H100, k = 16
# at TM = 64 ran 8x slower than at TM = 16).
_ROW_REGS = 32
# Programs to aim for before the reference axis is split: a few waves over
# the H100's 132 SMs, so that small query counts still fill the card.
_TARGET_PROGRAMS = 4 * 132
_MIN_TILES_PER_SPLIT = 8
# Shared memory one program may use (H100: 227 KB per block); the pipelined
# reference tiles are what a program keeps there.
SMEM_BYTES = 227 * 1024


def interpret_mode(backend: str | None = None) -> bool:
    """Whether the Pallas kernels run in the interpreter on ``backend``
    (default: JAX's default backend).

    The kernels are compiled for the GPU through Triton. The CPU runs them
    in the interpreter, which is how the tests check them. Any other backend
    has no route, and raises rather than silently interpreting."""
    backend = jax.default_backend() if backend is None else backend
    if backend == "gpu":
        return False
    if backend == "cpu":
        return True
    raise RuntimeError(
        f"no Pallas kernel route for backend {backend!r}: kernels compile "
        "for 'gpu' and run interpreted on 'cpu'"
    )


def stage_inputs(queries, refs):
    """Move numpy inputs onto the device once, before the jitted call, so
    that every caller stages the (large) reference set the same way."""
    import numpy as _np

    if isinstance(queries, _np.ndarray):
        queries = jnp.asarray(queries, dtype=jnp.float32)
    if isinstance(refs, _np.ndarray):
        refs = jax.device_put(jnp.asarray(refs, dtype=jnp.float32))
    return queries, refs


def _check_tile(name: str, value: int) -> None:
    if value < 1 or value & (value - 1):
        raise ValueError(f"{name}={value} must be a power of two")


def ref_tile(k: int, tile_n: int = _TILE_N) -> int:
    """Reference tile width for k dims: ``tile_n``, halved while the
    pipelined dim-major tiles (k * TN f32 per stage) would overflow the
    block's shared memory."""
    _check_tile("tile_n", tile_n)
    tn = tile_n
    while tn > 16 and _STAGES * k * tn * 4 > SMEM_BYTES:
        tn //= 2
    return tn


def fused_plan(m: int, n_pad: int, k: int, tile_m: int = _TILE_M,
               tile_n: int = _TILE_N, splits: int | None = None) -> dict:
    """Block shapes and grid of the fused scan, computed from the shapes
    alone: query tile ``tm`` (at most ``tile_m``, and small enough for the
    query rows to stay in registers), reference tile ``tn``, the number of
    reference ``splits`` (V7) and the tiles each split walks, and the
    shared memory the pipelined reference tiles take."""
    _check_tile("tile_m", tile_m)
    rows_cap = _WARPS * max(1, _ROW_REGS // k)
    tm = min(tile_m, 1 << (rows_cap.bit_length() - 1),
             max(_MIN_TILE_M, layouts.pow2_at_least(m)))
    tn = ref_tile(k, tile_n)
    if n_pad % tn:
        raise ValueError(f"n_pad={n_pad} is not a multiple of the tile {tn}")
    n_tiles = n_pad // tn
    m_tiles = -(-m // tm)
    if splits is None:
        splits = max(1, min(-(-_TARGET_PROGRAMS // m_tiles),
                            n_tiles // _MIN_TILES_PER_SPLIT))
    splits = max(1, min(splits, n_tiles))
    per_split = -(-n_tiles // splits)
    splits = -(-n_tiles // per_split)  # no empty split
    return dict(tm=tm, tn=tn, m_pad=m_tiles * tm, n_tiles=n_tiles,
                splits=splits, tiles_per_split=per_split,
                smem_bytes=_STAGES * k * tn * 4)


def _fused_kernel(q_ref, r_ref, min_ref, idx_ref, *, k: int, tm: int, tn: int,
                  tiles_per_split: int, n_tiles: int):
    """One (query tile, reference split) program. q_ref (k, m_pad) and
    r_ref (k, n_pad) are dim-major; outputs are (splits, m_pad).

    The loop keeps a (TM, TN) lane-wise running (min, tile) pair and
    reduces across lanes once, after the loop: each step is elementwise
    only, with no cross-thread reduction. Strict < keeps a lane's earliest
    tile, so the final (min, lowest global index) over lanes is the lowest
    index attaining the minimum."""
    i = pl.program_id(0)
    s = pl.program_id(1)
    qs = [q_ref[d, pl.ds(i * tm, tm)][:, None] for d in range(k)]

    def body(t, carry):
        acc_d, acc_t = carry
        d2 = jnp.zeros((tm, tn), jnp.float32)
        for d in range(k):
            diff = qs[d] - r_ref[d, pl.ds(t * tn, tn)][None, :]
            d2 = d2 + diff * diff
        better = d2 < acc_d
        return jnp.where(better, d2, acc_d), jnp.where(better, t, acc_t)

    lo = s * tiles_per_split
    hi = jnp.minimum(lo + tiles_per_split, n_tiles)
    acc_d, acc_t = jax.lax.fori_loop(
        lo, hi, body,
        (jnp.full((tm, tn), jnp.inf, jnp.float32),
         jnp.full((tm, tn), lo, jnp.int32)),
    )
    best_d = jnp.min(acc_d, axis=1)
    gidx = acc_t * tn + jax.lax.broadcasted_iota(jnp.int32, (tm, tn), 1)
    best_i = jnp.min(
        jnp.where(acc_d == best_d[:, None], gidx, jnp.int32(2**31 - 1)), axis=1
    )
    min_ref[s, pl.ds(i * tm, tm)] = best_d
    idx_ref[s, pl.ds(i * tm, tm)] = best_i


def prepare_refs(refs, tile_n: int = _TILE_N):
    """One-time reference staging for the prepare-once/query-many path:
    replica-pad n to a tile multiple and transpose to dim-major (k, n_pad)
    (V4's transpose, done once instead of per query batch). Returns
    (r_dm, tn)."""
    k = refs.shape[1]
    tn = ref_tile(k, tile_n)
    r = layouts.pad_refs(jnp.asarray(refs, dtype=jnp.float32), tn)
    return layouts.to_dim_major(r), tn


@functools.partial(
    jax.jit, static_argnames=("tile_m", "tile_n", "interpret", "splits")
)
def _fused_on_prepared(queries, r_dm, tile_m: int, tile_n: int,
                       interpret: bool, splits: int | None = None):
    """Fused scan over already-prepared dim-major refs.

    Returns (min_dist2[m] f32, argmin_idx[m] i32) — the (dist, idx) winner
    pair the multi-device merge needs (V8, core.cu:1025-1030)."""
    m, k = queries.shape
    n_pad = r_dm.shape[1]
    p = fused_plan(m, n_pad, k, tile_m, tile_n, splits)
    q_dm = layouts.to_dim_major(layouts.pad_queries(queries, p["tm"]))
    mins, idxs = pl.pallas_call(
        functools.partial(
            _fused_kernel, k=k, tm=p["tm"], tn=p["tn"],
            tiles_per_split=p["tiles_per_split"], n_tiles=p["n_tiles"],
        ),
        grid=(p["m_pad"] // p["tm"], p["splits"]),
        out_shape=(
            jax.ShapeDtypeStruct((p["splits"], p["m_pad"]), jnp.float32),
            jax.ShapeDtypeStruct((p["splits"], p["m_pad"]), jnp.int32),
        ),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=_WARPS,
                                           num_stages=_STAGES),
        interpret=interpret,
        name="fused_scan",
    )(q_dm, r_dm)
    if p["splits"] > 1:
        # V7's second pass: argmin keeps the lowest split on exact ties, and
        # splits are ascending contiguous ranges -> lowest index overall.
        win = jnp.argmin(mins, axis=0)[None, :]
        mins = jnp.take_along_axis(mins, win, axis=0)
        idxs = jnp.take_along_axis(idxs, win, axis=0)
    return mins[0, :m], idxs[0, :m]


def _fused_call_min_idx(queries, refs, tile_m: int, tile_n: int, interpret: bool,
                        splits: int | None = None):
    r_dm, tn = prepare_refs(refs, tile_n)
    return _fused_on_prepared(queries, r_dm, tile_m, tn, interpret, splits)


def nns_fused(queries, refs, tile_m: int = _TILE_M, tile_n: int = _TILE_N,
              splits: int | None = None):
    """V4 and the exact scan of every fallback: fused distance + argmin over
    dim-major refs. ``splits`` forces the V7 reference split (default: as
    many as it takes to fill the card)."""
    queries, refs = stage_inputs(queries, refs)
    return _fused_call_min_idx(
        queries, refs, tile_m, tile_n, interpret_mode(), splits
    )[1]


def fused_fallback(queries, refs) -> "jnp.ndarray":
    """Exact full-scan fallback for certificate/traversal failures: pads the
    query count to a power-of-two bucket so repeated fallbacks with varying
    batch sizes reuse compiled kernels instead of recompiling per shape."""
    import numpy as np

    q = np.asarray(queries, dtype=np.float32)
    m = q.shape[0]
    bucket = layouts.pow2_at_least(max(m, 8))
    if bucket != m:
        q = np.pad(q, ((0, bucket - m), (0, 0)))
    return nns_fused(q, refs)[:m]


class FusedBruteForce:
    """Prepare-once / query-many engine over the fused scan — the serving
    shape: the reference set is staged (padded, dim-major, on device) a
    single time; each query batch runs only the kernel."""

    def __init__(self, refs, tile_m: int = _TILE_M, tile_n: int = _TILE_N):
        self.n = refs.shape[0]
        self.tile_m = tile_m
        self.r_dm, self.tile_n = prepare_refs(refs, tile_n)
        self.r_dm = jax.device_put(self.r_dm)
        jax.block_until_ready(self.r_dm)

    def query_min_idx(self, queries):
        q = jnp.asarray(queries, dtype=jnp.float32)
        return _fused_on_prepared(q, self.r_dm, self.tile_m, self.tile_n,
                                  interpret_mode())

    def query(self, queries):
        return self.query_min_idx(queries)[1]
