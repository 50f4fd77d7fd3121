"""v9 — the "best brute force" slot: triple-bf16 tensor-core expansion with
a carried two-minima band certificate and an exact refine fallback.

Reference analog: v9 (core.cu:856-1058) is the reference ladder's most-tuned
brute-force kernel. Here the distinct mechanism is moving the distance
FLOPs onto the tensor cores, which multiply bf16 at many times the CUDA
cores' f32 rate. Exact f32 arithmetic cannot ride bf16 products directly,
and an f32 product may run in TF32 (~3 decimal digits). Instead:

1. Split every coordinate into a bf16 (hi, mid, lo) triple outside the
   kernel: ``hi = bf16(x)``, ``mid = bf16(x - hi)``, ``lo = bf16(x - hi -
   mid)``; the triple carries ~24 mantissa bits, i.e. all of f32.
2. Compute the cross term ``q . r`` as the six product terms
   ``hh + hm + mh + hl + lh + mm``, six bf16 tensor-core products with f32
   accumulation. Dropped terms (``m.l``, ``l.m``, ``l.l``) and the split
   residuals bound the error of the half-expansion value
   e = |r|^2/2 - q.r at ``delta ~ k * 2^-21 * scale`` — comparable to the
   f32 rounding of the direct form itself.
3. TWO-PHASE reduction:
   - Phase 1 (Pallas kernel, Triton route): one program per query tile
     loops over the reference set in ts-wide subtiles, takes one min per
     subtile of the expansion values, and carries (min1, winning-subtile
     id, runner-up m2x) plus the tile-granular top-3 that feeds the band
     refine — six (tm,) vectors in registers, fused behind the products.
   - Phase 2 (XLA, same jit): gather ONLY each query's winning subtile of
     raw f32 reference points and rescan it in full f32 (explicit mul+sum,
     never a dot that could run in TF32), yielding the in-subtile argmin
     and the duplicate-aware in-subtile min2. The gather is chunked via
     lax.map to bound the temporary.
4. Certificate: ``min(in_tile_min2, m2x) > min1 + 2*delta`` proves arg1
   is the true f32 nearest neighbor: any other point j in the winning
   subtile has E(j) >= in_tile_min2 - delta2, any point outside it has
   E(j) >= its subtile's min - delta1 >= m2x - delta1, while E(arg1) <=
   min1 + delta2; delta >= delta1 >= delta2 covers both (phase 2 is
   strictly more accurate than phase 1). Exact duplicates land in
   in_tile_min2 (only the argmin POSITION is masked) or force
   m2x == min1 (cross-subtile), failing the certificate as they must.
   Queries that fail (near-exact ties / duplicate-heavy data) are
   re-answered by the band refine and the exact full scan — the package
   exactness contract holds unconditionally.

Reference points are padded in the *distance domain*: padded columns get
``r2 = +inf`` (their split coordinates are zero), so they can never win
regardless of the data's coordinate range — no sentinel-coordinate
assumption.

At k < 8 the direct form is cheap while 1M-density expansion gaps shrink
below any sound error band (the certificate then covers few queries), so
the dispatcher keeps the fused direct scan there.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from nns.kernels import layouts
from nns.kernels.pallas_fused import FusedBruteForce, interpret_mode

_COLS = 128       # column chunks are multiples of this
_ROWS = 8         # row chunks are multiples of this
_MIN_TILE = 16     # smallest bf16 tensor-core operand edge
_MAX_TILE_M = 128
_WARPS = 4
_STAGES = 3

# Error bound on the triple-bf16 half-expansion value e = |r|^2/2 - q.r,
# in units of (max|q|^2 + max|r|^2) per coordinate count k: dropped cross
# terms (~2^-27) + split residuals (~2^-26) + f32 accumulation, with a
# ~16x safety factor. k is folded in by the caller.
_DELTA_REL_PER_K = 2.0 ** -21


def _split_bf16x3(x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(hi, mid, lo) bf16 triple with hi + mid + lo ~ x to ~24 bits.

    The ``optimization_barrier`` on each cast is load-bearing: XLA may
    treat the f32 -> bf16 -> f32 round trip as value-preserving and fold
    ``x - f32(bf16(x))`` to exactly 0, which silently zeroes the mid/lo
    residuals and collapses the triple to a plain bf16 truncation (the
    phase-1 error would then exceed the certificate band). The barrier only
    pins the cast results — it costs no copies and does not block fusion
    around the split."""
    hi = jax.lax.optimization_barrier(x.astype(jnp.bfloat16))
    rem = x - hi.astype(jnp.float32)
    mid = jax.lax.optimization_barrier(rem.astype(jnp.bfloat16))
    lo = (rem - mid.astype(jnp.float32)).astype(jnp.bfloat16)
    return hi, mid, lo


def padded_dims(k: int) -> int:
    """Coordinates per split after zero padding (zero coordinates on both
    sides leave distances and q.r unchanged): a power of two of at least
    16, the smallest bf16 tensor-core operand edge."""
    return max(_MIN_TILE, layouts.pow2_at_least(k))


def phase1_plan(m: int, n_pad: int, kp: int, tile_m: int, tile_n: int,
                ts: int) -> dict:
    """Block shapes and grid of phase 1, from the shapes alone: query tile
    ``tm``, subtile ``ts`` (one set of six products per loop step), the
    tiles and subtiles each program walks, and the shared memory the
    pipelined (3, kp, ts) bf16 split tiles take."""
    tm = min(tile_m, max(_MIN_TILE, layouts.pow2_at_least(m)))
    for name, v in (("tile_m", tm), ("ts", ts), ("kp", kp)):
        if v < _MIN_TILE or v & (v - 1):
            raise ValueError(f"{name}={v} must be a power of two >= {_MIN_TILE}")
    if tile_n % ts or n_pad % tile_n:
        raise ValueError(f"ts={ts} must divide tile_n={tile_n}, and tile_n n_pad={n_pad}")
    return dict(tm=tm, ts=ts, ns=tile_n // ts, n_tiles=n_pad // tile_n,
                m_pad=layouts.round_up(m, tm),
                smem_bytes=_STAGES * (3 * kp * ts * 2 + ts * 4))


def _phase1_kernel(q_ref, rc_ref, r2h_ref, min1_ref, tid_ref, m2x_ref,
                   t2v_ref, tid2_ref, t3v_ref, *, tm: int, ts: int, ns: int,
                   n_tiles: int):
    """Min-only scan of one query tile over every reference tile.

    q_ref (3, m_pad, kp) and rc_ref (3, kp, n_pad) hold the bf16 (hi, mid,
    lo) splits; r2h_ref (n_pad,) the f32 half-norms (+inf on padding).
    Each tile spans ns subtiles of width ts. Carries (min1, winning
    SUBTILE id, cross-subtile runner-up m2x) plus the TILE-granular top-3
    (t2v, tid2, t3v) that feeds the band-limited refine of uncertified
    rows: the second-best tile's id (so its points can be rescanned
    alongside the winner's tile) and the third-best tile MIN (bounding
    everything outside those two). Ids are carried at subtile granularity
    so the phase-2 gather stays ts columns wide; ns == 1 degenerates to
    plain per-tile ids (in-tile runner-up == inf)."""
    rows = pl.ds(pl.program_id(0) * tm, tm)
    qh, qm, ql = (q_ref[p, rows, :] for p in range(3))
    inf = jnp.full((tm,), jnp.inf, jnp.float32)

    def subtile(c, carry):
        tmin, sarg, smin2 = carry
        cols = pl.ds(c * ts, ts)
        rh, rm, rl = (rc_ref[p, :, cols] for p in range(3))
        # The six split products on the tensor cores, f32 accumulation.
        cross = (pl.dot(qh, rh) + pl.dot(qh, rm) + pl.dot(qm, rh)
                 + pl.dot(qh, rl) + pl.dot(ql, rh) + pl.dot(qm, rm))
        # Half-expansion: e = |r|^2/2 - q.r (ranking-equivalent to the
        # distance; |q|^2 row-constant, the global 2x monotone).
        smin = jnp.min(r2h_ref[cols][None, :] - cross, axis=1)
        # Lowest subtile achieving the tile min; a tie with it lands in the
        # runner-up, so an in-tile cross-subtile duplicate is seen.
        lt = smin < tmin
        return (jnp.where(lt, smin, tmin), jnp.where(lt, c, sarg),
                jnp.where(lt, tmin, jnp.minimum(smin2, smin)))

    def tile(j, carry):
        c1, ct, c2, t2, i2, t3 = carry
        tmin, stid, smin2 = jax.lax.fori_loop(
            j * ns, (j + 1) * ns, subtile,
            (inf, jnp.full((tm,), j * ns, jnp.int32), inf),
        )
        # TILE-granular sorted-top-3 merge for the band refine, using the
        # PRE-duel carry (c1 is the best tile min so far, ct // ns its
        # tile). A tile tying the leader lands in (t2v, tid2) — so a
        # two-tile exact duplicate is still gathered and resolved by lowest
        # index in tier 1; a third tying tile lands in t3v, failing the
        # outside bound as it must.
        b1 = tmin < c1
        b2 = jnp.logical_and(jnp.logical_not(b1), tmin < t2)
        t2n = jnp.where(b1, c1, jnp.where(b2, tmin, t2))
        i2n = jnp.where(b1, ct // ns, jnp.where(b2, j, i2))
        t3n = jnp.where(jnp.logical_or(b1, b2), t2, jnp.minimum(t3, tmin))
        # Duel with the carry. Strict < in ascending tile order keeps the
        # earlier (lower-id) subtile on an exact cross-tile tie, which then
        # lands in m2x and fails the certificate — as a duplicate must. A
        # new winner demotes the old one AND competes with its own in-tile
        # runner-up; a loser competes with the carried runner-up.
        return (jnp.where(b1, tmin, c1), jnp.where(b1, stid, ct),
                jnp.where(b1, jnp.minimum(c1, smin2), jnp.minimum(c2, tmin)),
                t2n, i2n, t3n)

    zeros = jnp.zeros((tm,), jnp.int32)
    outs = jax.lax.fori_loop(0, n_tiles, tile,
                             (inf, zeros, inf, inf, zeros, inf))
    for ref, val in zip((min1_ref, tid_ref, m2x_ref, t2v_ref, tid2_ref,
                         t3v_ref), outs):
        ref[rows] = val


def _phase1(q, rc, r2h, kp, tile_m, tile_n, ts, interpret):
    """Phase 1 over zero-padded f32 queries q (m, kp): returns the six
    carries as (m_pad,) arrays."""
    m = q.shape[0]
    p = phase1_plan(m, rc.shape[2], kp, tile_m, tile_n, ts)
    qs = jnp.stack(_split_bf16x3(layouts.pad_queries(q, p["tm"])))
    f32 = jax.ShapeDtypeStruct((p["m_pad"],), jnp.float32)
    i32 = jax.ShapeDtypeStruct((p["m_pad"],), jnp.int32)
    return pl.pallas_call(
        functools.partial(_phase1_kernel, tm=p["tm"], ts=ts, ns=p["ns"],
                          n_tiles=p["n_tiles"]),
        grid=(p["m_pad"] // p["tm"],),
        out_shape=(f32, i32, f32, f32, i32, f32),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=_WARPS,
                                           num_stages=_STAGES),
        interpret=interpret,
        name="v9_phase1",
    )(qs, rc, r2h)


def _phase2_chunk(q, tid, m2x, refs_t, r2h_t, delta, tile_n):
    """Full-f32 rescan of each query's winning tile (one lax.map step).

    q (mc, kp) f32; tid (mc,) i32; m2x (mc,) f32;
    refs_t (n_tiles, tile_n, kp) f32 zero-padded; r2h_t (n_tiles, tile_n)
    f32 half-norms (+inf on padded columns, so padding never wins).
    Returns (idx, cert, min1) per row.
    """
    rsel = jnp.take(refs_t, tid, axis=0)           # (mc, tile_n, kp)
    r2sel = jnp.take(r2h_t, tid, axis=0)           # (mc, tile_n)
    # f32 mul+sum — a dot here could run in TF32 or bf16, blowing the
    # phase-2 error past the certificate band.
    cross = jnp.sum(rsel * q[:, None, :], axis=2)  # (mc, tile_n)
    ew = r2sel - cross
    wmin1 = jnp.min(ew, axis=1)
    cols = jax.lax.broadcasted_iota(jnp.int32, ew.shape, 1)
    warg = jnp.min(jnp.where(ew == wmin1[:, None], cols, tile_n), axis=1)
    # In-tile min2 masks only the argmin POSITION, so in-tile duplicates
    # are seen and fail the certificate.
    wmin2 = jnp.min(jnp.where(cols == warg[:, None], jnp.inf, ew), axis=1)
    idx = tid * tile_n + warg
    cert = (jnp.minimum(wmin2, m2x) > wmin1 + 2.0 * delta).astype(jnp.float32)
    return idx, cert, wmin1


def _phase12(q, rc, r2h, refs_t, r2h_t, delta, kp, tile_m, tile_n,
             ts, interpret):
    """Traced core shared by the packed query and the serving drain:
    k-pad + bf16 triple split + min-only Pallas phase 1 + winning-subtile
    f32 rescan phase 2 + certificate. Returns per-row
    (min1 (m,), idx (m,) i32, cert (m,) bool) plus the tile-granular band
    feed (tid2, t3v) as (m_pad,) arrays for the band-limited refine."""
    m = q.shape[0]
    q = layouts.pad_dims(q, kp)
    _, tid, m2x, _, tid2, t3v = _phase1(q, rc, r2h, kp, tile_m, tile_n, ts,
                                        interpret)
    m_pad = tid.shape[0]

    # Phase 2, chunked so the (mc, ts, kp) gather temp stays bounded
    # (~2M gathered points per step) even for concatenated query_many
    # queues.
    mc = min(m_pad, max(_ROWS, ((1 << 21) // ts) // _ROWS * _ROWS))
    m_pad2 = layouts.round_up(m_pad, mc)
    qp = jnp.pad(q[:m], ((0, m_pad2 - m), (0, 0)))
    tidp = jnp.pad(tid[:m], (0, m_pad2 - m))
    m2xp = jnp.pad(m2x[:m], (0, m_pad2 - m))
    nchunks = m_pad2 // mc

    def step(args):
        qck, tidk, m2xk = args
        return _phase2_chunk(qck, tidk, m2xk, refs_t, r2h_t, delta, ts)

    idx2, cert2, min12 = jax.lax.map(
        step,
        (
            qp.reshape(nchunks, mc, kp),
            tidp.reshape(nchunks, mc),
            m2xp.reshape(nchunks, mc),
        ),
    )
    return (
        min12.reshape(-1)[:m],
        idx2.reshape(-1)[:m].astype(jnp.int32),
        cert2.reshape(-1)[:m] > 0.5,
        tid2,
        t3v,
    )


@functools.partial(
    jax.jit, static_argnames=("kp", "tile_m", "tile_n", "ts", "interpret")
)
def _expansion_query(q, rc, r2h, refs_t, r2h_t, delta, kp, tile_m, tile_n,
                     ts, interpret):
    """ONE dispatch for the whole query: the _phase12 core packed as a
    (4, m) f32 [min1, idx_hi, idx_lo, cert] so the caller pays a single
    host fetch; ids transit as two f32-exact 12-/19-bit halves
    (idx = hi*4096 + lo), exact for any n < 2^31 — the engine's real
    bound is device memory, not id precision. This is the inspection path
    (query_min_idx_cert); the serving drain uses _expansion_drain."""
    min1, idx, cert, _, _ = _phase12(
        q, rc, r2h, refs_t, r2h_t, delta, kp, tile_m, tile_n, ts, interpret
    )
    idx_hi = (idx // 4096).astype(jnp.float32)
    idx_lo = (idx % 4096).astype(jnp.float32)
    return jnp.stack([min1, idx_hi, idx_lo, cert.astype(jnp.float32)])


@functools.partial(
    jax.jit,
    static_argnames=(
        "kp", "tile_m", "tile_n", "ts", "maxbad", "maxbad2", "interpret"
    ),
)
def _expansion_drain(q, rc, r2h, refs_t, r2h_t, delta, kp, tile_m, tile_n,
                     ts, maxbad, maxbad2, interpret):
    """The serving-drain program: _phase12 + IN-PROGRAM tier-1 band refine
    + IN-PROGRAM tier-2 full scan + sign-encoded single-int32 output —
    one dispatch, one (m,) i32 fetch, no host round trip in between:

    - uncertified rows are COMPACTED ON DEVICE (cumsum positions +
      drop-mode scatter) into a static ``maxbad``-row bucket,
    - the band-limited top-2-tile direct-f32 rescan (_band_refine_rows,
      soundness in its docstring) runs inside the same program under a
      ``lax.cond`` — a fully-certified batch pays nothing,
    - rows the band refine REFUSES (straddling ties) are compacted again
      into a ``maxbad2`` bucket and full-scanned IN-PROGRAM
      (_full_scan_rows: direct f32 over every reference point,
      lowest-index tie-break — exact by construction, no certificate
      needed), leaving the host fallback only for bucket-overflow floods,
    - results scatter back (drop-mode, pad slots aimed out of range) and
      the output is ONE int32 per row: ``idx`` where the answer is final,
      ``-idx - 1`` where the host must still re-answer by the exact full
      scan (bad rows beyond either static bucket — sound: negative rows
      are always re-answered).
    """
    m = q.shape[0]
    _, idx, cert, tid2, t3v = _phase12(
        q, rc, r2h, refs_t, r2h_t, delta, kp, tile_m, tile_n, ts, interpret
    )
    signed0 = jnp.where(cert, idx, -idx - 1)
    bad = jnp.logical_not(cert)
    nbad = jnp.sum(bad.astype(jnp.int32))
    qp = layouts.pad_dims(q, kp)

    def _compact(flags, cap):
        """Device-side compaction: slots of the <= cap rows where flags is
        True (cumsum positions + drop-mode scatter). Returns (rows (cap,)
        i32 with m on empty slots, valid (cap,) bool)."""
        rowid = jnp.arange(m, dtype=jnp.int32)
        pos = jnp.cumsum(flags.astype(jnp.int32)) - 1
        slot = jnp.where(flags, pos, cap)
        rows = jnp.full((cap,), m, dtype=jnp.int32)
        rows = rows.at[slot].set(rowid, mode="drop")
        return rows, rows < m

    def refine(signed):
        rows, valid = _compact(bad, maxbad)
        rsafe = jnp.where(valid, rows, 0)
        qb = jnp.take(qp, rsafe, axis=0)                 # (maxbad, kp)
        q2b = jnp.sum(qb * qb, axis=1)
        tile1 = jnp.take(idx, rsafe) // tile_n
        tile2 = jnp.take(tid2, rsafe)
        t3b = jnp.take(t3v, rsafe)
        n_total = refs_t.shape[0] * refs_t.shape[1]
        ridx, rok = _band_refine_rows(
            qb, q2b, jnp.stack([tile1, tile2], axis=1), t3b,
            refs_t, r2h_t, delta, tile_n, n_total,
        )
        back = jnp.where(valid, rows, m)                 # m -> dropped
        return signed.at[back].set(
            jnp.where(rok, ridx, -ridx - 1), mode="drop"
        )

    signed1 = jax.lax.cond(nbad > 0, refine, lambda s: s, signed0)

    bad2 = signed1 < 0
    nbad2 = jnp.sum(bad2.astype(jnp.int32))

    def full(signed):
        rows, valid = _compact(bad2, maxbad2)
        rsafe = jnp.where(valid, rows, 0)
        qb = jnp.take(qp, rsafe, axis=0)                 # (maxbad2, kp)
        fidx = _full_scan_rows(qb, refs_t, r2h_t)
        back = jnp.where(valid, rows, m)
        return signed.at[back].set(fidx, mode="drop")

    return jax.lax.cond(nbad2 > 0, full, lambda s: s, signed1)


def _full_scan_rows(qb, refs_t, r2h_t):
    """Tier-2 in-program exact scan: direct f32 (q - r)^2 over EVERY
    reference point for a small compacted row bucket, lowest-index
    tie-break — the v0-v9 family contract, exact by construction (it IS
    the definition of the answer on the f32 inputs; no certificate).
    Distance-domain padding via r2h_t's +inf half-norms (zero-coordinate
    padded rows would otherwise win at d2 = |q|^2).

    Cost model: B rows x n points x kp dims of f32 mul-add per TRIGGERED
    drain — at B=256, n=1M, k=16 that is ~12 GFLOP. lax.scan over
    reference chunks keeps the (B, cn) temporaries ~8 MB.

    qb (B, kp) f32 zero-padded; refs_t (n_sub, ts, kp) / r2h_t (n_sub, ts)
    — the engine's phase-2 staging, re-viewed flat (free reshape).
    Returns idx (B,) i32.
    """
    n_sub, ts_w, kp = refs_t.shape
    n_pad = n_sub * ts_w
    b = qb.shape[0]
    # Chunk width: column-aligned, bounding the (B, cn) step temporary.
    cn = min(n_pad, max(_COLS, (1 << 21) // max(b, 1) // _COLS * _COLS))
    # n_pad is a multiple of tile_n >= cn's alignment; pad defensively.
    n_c = -(-n_pad // cn)
    refs_flat = refs_t.reshape(n_pad, kp)
    r2h_flat = r2h_t.reshape(n_pad)
    if n_c * cn != n_pad:
        refs_flat = jnp.pad(refs_flat, ((0, n_c * cn - n_pad), (0, 0)))
        r2h_flat = jnp.pad(
            r2h_flat, (0, n_c * cn - n_pad), constant_values=jnp.inf
        )
    rch = refs_flat.reshape(n_c, cn, kp)
    r2ch = r2h_flat.reshape(n_c, cn)
    base = jnp.arange(n_c, dtype=jnp.int32) * cn

    def body(carry, chunk):
        bd2, bidx = carry
        rk, r2k, b0 = chunk
        # Direct f32, accumulated per-dim to avoid a (B, cn, kp) temp.
        d2 = jnp.zeros((b, cn), dtype=jnp.float32)
        for d in range(kp):
            diff = qb[:, d:d + 1] - rk[None, :, d]
            d2 = d2 + diff * diff
        d2 = jnp.where(jnp.isinf(r2k)[None, :], jnp.inf, d2)
        cmin = jnp.min(d2, axis=1)
        cols = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
        carg = jnp.min(
            jnp.where(d2 == cmin[:, None], cols, cn), axis=1
        ) + b0
        # Strict < keeps the earlier chunk's (lower) index on exact ties;
        # in-chunk carg is already the lowest tied column.
        better = cmin < bd2
        return (
            jnp.where(better, cmin, bd2),
            jnp.where(better, carg, bidx),
        ), None

    (_, bidx), _ = jax.lax.scan(
        body,
        (
            jnp.full((b,), jnp.inf, dtype=jnp.float32),
            jnp.zeros((b,), dtype=jnp.int32),
        ),
        (rch, r2ch, base),
    )
    return bidx


def _band_refine_rows(q_bad, q2_bad, t12, t3, refs_t, r2h_t, delta,
                      tile_n, n_total):
    """Band-limited refine of uncertified rows: a direct-f32 rescan of each
    row's TOP-2 tiles (winner's tile + phase-1's second-best tile),
    certified by the third-best tile min. Traced inside _expansion_drain,
    so it costs no host round trip. It replaces, for ~all uncertified
    rows, the full FusedBruteForce rescan of every reference point.

    Soundness: any point OUTSIDE the two gathered tiles lies in a tile
    whose phase-1 min is >= t3 (the third-smallest), so its true expansion
    value is >= t3 - delta. The gathered winner's true value is
    <= e_w + delta (e_w = d2/2 - |q|^2/2 in f32 direct arithmetic; delta
    bounds the six-product phase-1 accumulation, strictly wider than this
    16-term direct form). ``t3 > e_w + 2*delta`` therefore proves no
    outside point can beat OR TIE the winner; within the gathered set the
    scan is the contract's own direct-f32 arithmetic with an explicit
    lowest-index tie-break, so certified rows match FusedBruteForce
    exactly (v0-v9 family tie-break contract). Exact ties straddling the
    band (three tied tiles) fail the certificate — as they must — and
    fall through to the full scan. With n_tiles <= 2 everything is
    gathered and t3 stays +inf, so the bound passes vacuously — correct.

    q_bad (B, kp) f32 zero-padded; q2_bad (B,) f32 |q|^2; t12 (B, 2) i32
    [winner tile, second-best tile]; t3 (B,) f32 third-best tile min;
    refs_t (n_sub, ts, kp) / r2h_t (n_sub, ts) — the engine's phase-2
    staging, re-viewed at tile granularity (free reshape). Returns
    (idx (B,) i32, ok (B,) bool).
    """
    n_tiles = refs_t.shape[0] * refs_t.shape[1] // tile_n
    refs_tiles = refs_t.reshape(n_tiles, tile_n, -1)
    r2h_tiles = r2h_t.reshape(n_tiles, tile_n)
    b = q_bad.shape[0]
    # Chunk the (mc, 2, tile_n, kp) gather to bound the temporary — the
    # factor 2 counts BOTH gathered tiles, keeping the per-step gather at
    # the same ~2M-point bound phase 2 uses for its single-subtile gather.
    mc = min(b, max(_ROWS, ((1 << 21) // (2 * tile_n)) // _ROWS * _ROWS))
    nchunks = b // mc if b % mc == 0 else b // mc + 1
    bp = nchunks * mc
    if bp != b:
        q_bad = jnp.pad(q_bad, ((0, bp - b), (0, 0)))
        q2_bad = jnp.pad(q2_bad, (0, bp - b))
        t12 = jnp.pad(t12, ((0, bp - b), (0, 0)))
        t3 = jnp.pad(t3, (0, bp - b))

    def step(args):
        qk, q2k, tk, t3k = args
        rsel = jnp.take(refs_tiles, tk, axis=0)       # (mc, 2, tile_n, kp)
        r2sel = jnp.take(r2h_tiles, tk, axis=0)       # (mc, 2, tile_n)
        d2 = jnp.sum((rsel - qk[:, None, None, :]) ** 2, axis=3)
        d2 = jnp.where(jnp.isinf(r2sel), jnp.inf, d2)  # padding never wins
        cols = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 2)
        ids = tk[:, :, None] * tile_n + cols          # global ids
        d2f = d2.reshape(d2.shape[0], -1)
        idf = ids.reshape(d2.shape[0], -1)
        wmin = jnp.min(d2f, axis=1)
        # lowest global index among the direct-f32 minima
        warg = jnp.min(jnp.where(d2f == wmin[:, None], idf, n_total), axis=1)
        e_w = 0.5 * wmin - 0.5 * q2k
        ok = t3k > e_w + 2.0 * delta
        return warg.astype(jnp.int32), ok

    idx, ok = jax.lax.map(
        step,
        (
            q_bad.reshape(nchunks, mc, -1),
            q2_bad.reshape(nchunks, mc),
            t12.reshape(nchunks, mc, 2),
            t3.reshape(nchunks, mc),
        ),
    )
    return idx.reshape(-1)[:b], ok.reshape(-1)[:b]


class MXUExpansion:
    """Prepare-once / query-many engine for the triple-bf16 tensor-core
    path.

    ``tile_m`` is phase 1's query tile (a power of two in [16, 128]);
    ``tile_n`` the tile at which phase 1 ranks the reference set for the
    band refine; ``tile_s`` the subtile a winning id addresses, and so the
    width of phase 2's gather (the largest power of two dividing
    ``tile_n``, up to 256)."""

    def __init__(self, refs, tile_m: int | None = None,
                 tile_n: int | None = None, tile_s: int | None = None):
        tile_m = 64 if tile_m is None else tile_m
        tile_n = 4096 if tile_n is None else tile_n
        refs = np.asarray(refs, dtype=np.float32)
        self.refs = refs
        self.n, self.k = refs.shape
        # Ids transit as two f32-exact halves (hi = id // 4096 < 2^19,
        # lo < 2^12), exact for any n < 2^31; the bound here is device
        # staging, ~(96 + 64) B/point at k=16 (bf16 splits + f32 phase-2
        # tiles).
        if self.n >= 1 << 25:
            raise ValueError("MXUExpansion supports n < 2^25 (device staging)")
        self.tile_m = min(_MAX_TILE_M, max(_MIN_TILE, layouts.pow2_at_least(tile_m)))
        self.kp = padded_dims(self.k)
        n_pad = layouts.round_up(self.n, max(tile_n, _COLS))
        self.tile_n = min(tile_n, n_pad)
        self.ts = math.gcd(self.tile_n, 256 if tile_s is None else tile_s)
        if self.ts < _MIN_TILE:
            raise ValueError(f"tile_n={tile_n} leaves a subtile below {_MIN_TILE}")
        r = np.zeros((n_pad, self.kp), dtype=np.float32)
        r[: self.n, : self.k] = refs
        # (3, kp, n_pad) bf16: the (hi, mid, lo) splits, dim-major.
        self.rc = jax.device_put(jnp.stack(
            [x.T for x in _split_bf16x3(jnp.asarray(r))]
        ))
        # Distance-domain padding: +inf half-norms for padded columns — they
        # can never win for any query, with no coordinate-range assumption.
        r2h = np.full((n_pad,), np.inf, dtype=np.float32)
        r2h[: self.n] = (
            0.5 * (refs.astype(np.float64) ** 2).sum(axis=1)
        ).astype(np.float32)
        self.r2h = jax.device_put(jnp.asarray(r2h))
        # Phase-2 staging: raw f32 reference tiles + half-norms, tiled at
        # the subtile width so a winning subtile id addresses one gather row.
        n_sub = n_pad // self.ts
        self.refs_t = jax.device_put(
            jnp.asarray(r.reshape(n_sub, self.ts, self.kp))
        )
        self.r2h_t = jax.device_put(jnp.asarray(r2h.reshape(n_sub, self.ts)))
        self._r2_max = 2.0 * float(np.max(r2h[: self.n])) if self.n else 0.0
        # Per-dispatch query-row cap (see _packed_staged): deeper queues are
        # chunked so the phase-2 and refine temporaries stay bounded.
        self._m_cap = 1 << 19
        self._fallback: FusedBruteForce | None = None

    def stage_queries(self, queries) -> "StagedQueries":
        """Pre-stage a query set on device for the serving drain: the
        host->device upload and the host-side scale bound both move out of
        the timed region. Mirrors CellListEngine.stage_queue's prepare-once
        protocol."""
        q_np = np.asarray(queries, dtype=np.float32)
        m, k = q_np.shape
        if k != self.k:
            raise ValueError(f"dimension mismatch: queries k={k}, refs k={self.k}")
        # Host-side scale bound (avoids a device round-trip pre-kernel).
        q2_max = float((q_np.astype(np.float64) ** 2).sum(axis=1).max()) \
            if m else 0.0
        delta = _DELTA_REL_PER_K * max(self.k, 1) * (q2_max + self._r2_max)
        return StagedQueries(q_np, jax.device_put(q_np), float(delta))

    def _packed_staged(self, st: "StagedQueries") -> np.ndarray:
        """-> packed (4, m) numpy [min1, idx_hi, idx_lo, cert] — the
        inspection path behind query_min_idx_cert (the serving drain is
        _drain_staged). Very deep queues are chunked into separate
        dispatches whose outputs are device-concatenated, so the host still
        pays ONE packed fetch."""
        m = st.q_np.shape[0]
        if m == 0:
            return np.zeros((4, 0), dtype=np.float32)
        cap = self._m_cap
        packeds = [
            _expansion_query(
                st.q_dev[s : s + cap], self.rc, self.r2h, self.refs_t,
                self.r2h_t, jnp.float32(st.delta), self.kp, self.tile_m,
                self.tile_n, self.ts, interpret_mode(),
            )
            for s in range(0, m, cap)
        ]
        return np.asarray(jnp.concatenate(packeds, axis=1))

    def _maxbad(self, m: int) -> int:
        """Static tier-1 bucket for the in-program band refine: sized
        ~1.55x the uncertified fraction at k=16 and 1M-uniform density
        (~1.65%), capped so the always-compiled gather stays ~2 GB of
        device-memory traffic worst case. Bad rows beyond the bucket come
        back sign-encoded and are re-answered by the host full scan —
        sound on any data, just slower on adversarial tie floods."""
        return min(1 << 14, layouts.pow2_at_least(max(128, m // 40)))

    def _maxbad2(self, m: int) -> int:
        """Static tier-2 bucket for the in-program full scan of band-
        refine-refused rows (straddling ties, a few per 10K rows at k=16,
        1M-uniform density), sized well above that and capped so the
        always-compiled scan stays ~50 GFLOP worst case.
        Overflow rows stay sign-encoded for the host full scan — sound on
        adversarial tie floods, just slower."""
        return min(1 << 11, layouts.pow2_at_least(max(64, m // 2048)))

    def _drain_staged(self, st: "StagedQueries") -> np.ndarray:
        """-> signed (m,) int32: ``idx`` certified-final, ``-idx - 1``
        needs the host full scan. ONE dispatch + ONE 4 B/row fetch. Deep
        drains chunk like _packed_staged; each chunk runs its own
        in-program refine (self-contained rows), outputs are
        device-concatenated, one fetch."""
        m = st.q_np.shape[0]
        if m == 0:
            return np.zeros((0,), dtype=np.int32)
        cap = self._m_cap
        outs = [
            _expansion_drain(
                st.q_dev[s : s + cap], self.rc, self.r2h, self.refs_t,
                self.r2h_t, jnp.float32(st.delta), self.kp, self.tile_m,
                self.tile_n, self.ts,
                self._maxbad(min(cap, m - s)),
                self._maxbad2(min(cap, m - s)), interpret_mode(),
            )
            for s in range(0, m, cap)
        ]
        return np.asarray(jnp.concatenate(outs))

    def _query_packed(self, queries) -> np.ndarray:
        return self._packed_staged(self.stage_queries(queries))

    @staticmethod
    def _unpack_idx(packed: np.ndarray) -> np.ndarray:
        # idx = hi*4096 + lo, both halves f32-exact (see _expansion_query).
        return (packed[1].astype(np.int64) * 4096
                + packed[2].astype(np.int64)).astype(np.int32)

    def query_min_idx_cert(self, queries):
        packed = self._query_packed(queries)
        return packed[0], self._unpack_idx(packed), packed[3] > 0.5

    def query(self, queries):
        """Exact 1-NN indices; uncertified queries re-answered by the
        direct-f32 fused scan (rare: expansion ties / duplicates) over a
        staged-once reference set. A failed dispatch raises."""
        return self.query_staged(self.stage_queries(queries))

    def query_staged(self, st: "StagedQueries"):
        """query() on a pre-staged query set (see stage_queries) — the
        serving drain path: per-request device work only, upload untimed.
        The drain program folds BOTH refine tiers in (_expansion_drain:
        tier-1 band rescan + tier-2 full scan of straddling ties); the
        host only re-answers sign-encoded rows (static-bucket overflow —
        adversarial tie floods) by the exact full scan."""
        signed = self._drain_staged(st)
        idx = np.where(signed >= 0, signed, -signed - 1).astype(np.int32)
        bad = np.flatnonzero(signed < 0)
        if len(bad) == 0:
            return idx
        # Tier 2: full exact scan for rows the band could not certify
        # (exact or straddling ties — rare).
        if self._fallback is None:
            self._fallback = FusedBruteForce(self.refs)
        q_np = st.q_np[bad]
        bucket = layouts.pow2_at_least(max(len(bad), 8))
        if bucket != len(bad):  # shape-bucketed to bound recompiles
            q_np = np.pad(q_np, ((0, bucket - len(bad)), (0, 0)))
        idx[bad] = np.asarray(self._fallback.query(q_np))[: len(bad)]
        return idx


class StagedQueries:
    """A query set staged for MXUExpansion.query_staged: the host copy (for
    the exact-refine fallback), the device copy, and the pre-computed
    certificate band."""

    __slots__ = ("q_np", "q_dev", "delta")

    def __init__(self, q_np: np.ndarray, q_dev, delta: float):
        self.q_np = q_np
        self.q_dev = q_dev
        self.delta = delta


def nns_mxu_expansion(queries, refs, tile_m: int | None = None,
                      tile_n: int | None = None):
    """v9: triple-bf16 tensor-core expansion + band certificate + exact
    refine.

    Capability dispatch (SURVEY.md §5): k < 8 routes to the direct-f32
    fused kernel — at low k the direct form is cheap while 1M-density
    expansion-value gaps shrink below any sound error band, so the
    expansion path would mostly pay for its own fallback."""
    if refs.shape[1] < 8:
        from nns.kernels.pallas_fused import fused_fallback

        return np.asarray(fused_fallback(queries, refs))
    eng = MXUExpansion(refs, tile_m=tile_m, tile_n=tile_n)
    return eng.query(queries)
