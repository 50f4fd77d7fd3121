"""Unit tests for the v9 two-phase tensor-core expansion engine
(kernels/mxu_expansion.py): phase-1 min-only tile scan + phase-2
winning-tile f32 rescan + band certificate + exact-refine fallback.

Reference analog: v9 (core.cu:856-1058) is the reference's best brute
force; it has no tests there (SURVEY.md §4). These pin the rebuild's
exactness contract.
"""

from __future__ import annotations

import numpy as np
import pytest

from nns.kernels.mxu_expansion import MXUExpansion, nns_mxu_expansion
from nns.kernels.oracle import recall_at_1


def _oracle(queries, refs):
    d = (
        (queries[:, None, :].astype(np.float64) - refs[None].astype(np.float64))
        ** 2
    ).sum(-1)
    return d.argmin(1)


def test_certified_answers_exact_across_tiles():
    rng = np.random.default_rng(3)
    refs = rng.random((1000, 16), dtype=np.float32)
    queries = rng.random((57, 16), dtype=np.float32)
    eng = MXUExpansion(refs, tile_m=32, tile_n=128)  # 8 tiles, last padded
    min1, idx, cert = eng.query_min_idx_cert(queries)
    oracle = _oracle(queries, refs)
    assert cert.mean() > 0.9  # random data certifies almost everywhere
    assert (idx[cert] == oracle[cert]).all()
    # min1 is the phase-2 f32 half-expansion of the winner.
    e_win = 0.5 * (refs[idx].astype(np.float64) ** 2).sum(1) - (
        queries.astype(np.float64) * refs[idx].astype(np.float64)
    ).sum(1)
    np.testing.assert_allclose(min1, e_win, atol=1e-4)
    # The engine's public query() is unconditionally exact.
    assert recall_at_1(eng.query(queries), queries, refs) == 1.0


@pytest.mark.parametrize("dup_pos", [5, 700])
def test_duplicates_fail_certificate_but_stay_exact(dup_pos):
    # dup at 5: same phase-1 tile as the original (tile_n=512 would span
    # both; with tile_n=128 index 5 and 2 share tile 0) -> in-tile min2.
    # dup at 700: different tile -> cross-tile m2x == min1.
    rng = np.random.default_rng(4)
    refs = rng.random((1000, 16), dtype=np.float32)
    refs[dup_pos] = refs[2]
    q = refs[2:3].copy()
    eng = MXUExpansion(refs, tile_m=8, tile_n=128)
    _, idx, cert = eng.query_min_idx_cert(q)
    assert not cert[0], "exact duplicate must fail the certificate"
    # query() falls back to the exact scan; any true NN is valid, and both
    # copies are true NNs.
    out = int(eng.query(q)[0])
    assert out in (2, dup_pos)


def test_winner_in_last_padded_tile():
    rng = np.random.default_rng(5)
    refs = rng.random((130, 16), dtype=np.float32) + 4.0  # off-origin
    q = (refs[129] + 1e-3).reshape(1, -1).astype(np.float32)
    eng = MXUExpansion(refs, tile_m=8, tile_n=128)  # winner in tile 1 (2 cols real)
    _, idx, cert = eng.query_min_idx_cert(q)
    assert cert[0] and idx[0] == 129


def test_k_not_sublane_multiple():
    rng = np.random.default_rng(6)
    refs = rng.random((600, 10), dtype=np.float32)
    queries = rng.random((33, 10), dtype=np.float32)
    idx = nns_mxu_expansion(queries, refs)
    assert recall_at_1(idx, queries, refs) == 1.0


def test_subtile_ids_ns_gt_1_exact():
    # tile_n=1024 with the fixed 512-wide subtile gather -> ns=2: subtile
    # ids, in-tile runner-up, and the phase-2 rescan must stay exact.
    rng = np.random.default_rng(8)
    refs = rng.random((3000, 16), dtype=np.float32)
    queries = rng.random((65, 16), dtype=np.float32)
    eng = MXUExpansion(refs, tile_m=32, tile_n=1024)
    assert eng.ts == 256 and eng.tile_n // eng.ts == 4
    _, idx, cert = eng.query_min_idx_cert(queries)
    oracle = _oracle(queries, refs)
    assert cert.mean() > 0.9
    assert (idx[cert] == oracle[cert]).all()
    assert recall_at_1(eng.query(queries), queries, refs) == 1.0
    # In-tile cross-subtile duplicate: both copies inside one phase-1 tile
    # but different subtiles -> the runner-up subtile minimum must catch it.
    refs2 = refs.copy()
    refs2[700] = refs2[100]  # subtile 1 vs subtile 0 of tile 0
    eng2 = MXUExpansion(refs2, tile_m=32, tile_n=1024)
    _, idx2, cert2 = eng2.query_min_idx_cert(refs2[100:101].copy())
    assert not cert2[0]
    assert int(eng2.query(refs2[100:101].copy())[0]) in (100, 700)


def test_certificate_boundary_near_ties():
    """Adversarial near-ties: runner-up expansion gaps swept around the
    delta band. Whether the certificate passes is the engine's call, but
    whenever it passes the answer must be a true nearest neighbor, and
    query() must be exact regardless (tie-tolerant)."""
    rng = np.random.default_rng(12)
    k = 16
    base = rng.random((500, k)).astype(np.float32) + 2.0  # background cloud
    q = np.zeros((1, k), dtype=np.float32)
    # With q = 0, e = |r|^2/2: place winner at radius ~1 and runner-up at
    # a controlled e-gap g (delta at this scale ~ 2^-21 * 16 * (0 + ~70)).
    for g_rel in (0.0, 1e-7, 1e-6, 1e-5, 1e-3, 1e-1):
        refs = base.copy()
        refs[7] = 0.0
        refs[7, 0] = 1.0                     # e = 0.5
        refs[313] = 0.0
        refs[313, 0] = np.float32(np.sqrt(1.0 + 2.0 * g_rel))  # e ~ 0.5 + g
        eng = MXUExpansion(refs, tile_m=8, tile_n=128)
        _, idx, cert = eng.query_min_idx_cert(q)
        oracle = _oracle(q, refs)
        if cert[0]:
            d_win = ((refs[idx[0]].astype(np.float64)) ** 2).sum()
            d_true = ((refs[oracle[0]].astype(np.float64)) ** 2).sum()
            assert d_win == d_true, f"certified wrong answer at g={g_rel}"
        out = int(eng.query(q)[0])
        d_out = ((refs[out].astype(np.float64) - 0.0) ** 2).sum()
        d_true = ((refs[oracle[0]].astype(np.float64)) ** 2).sum()
        assert d_out == d_true, f"inexact answer at g={g_rel}"
        # Far past the band the certificate must actually engage (2*delta
        # at this scale is ~2.2e-3: k=16, r2_max ~ 144).
        if g_rel >= 1e-1:
            assert cert[0], f"certificate failed on a clear gap g={g_rel}"


def test_empty_query_batch():
    rng = np.random.default_rng(9)
    refs = rng.random((300, 16), dtype=np.float32)
    eng = MXUExpansion(refs, tile_m=8, tile_n=128)
    idx = eng.query(np.zeros((0, 16), dtype=np.float32))
    assert idx.shape == (0,)
    min1, idx2, cert = eng.query_min_idx_cert(np.zeros((0, 16), np.float32))
    assert min1.shape == idx2.shape == cert.shape == (0,)


def test_tile_n_not_multiple_of_ts_falls_back_to_per_tile_ids():
    rng = np.random.default_rng(10)
    refs = rng.random((2000, 16), dtype=np.float32)
    queries = rng.random((40, 16), dtype=np.float32)
    eng = MXUExpansion(refs, tile_m=16, tile_n=640)  # 640 % 256 != 0
    # The subtile a winning id addresses is the largest power of two that
    # divides tile_n (up to 256): five 128-wide subtiles per tile.
    assert eng.ts == 128
    assert recall_at_1(eng.query(queries), queries, refs) == 1.0


def test_id_halves_unpack_exactly_past_2_24():
    # Ids transit the packed fetch as two f32-exact halves; the unpack
    # must be exact up to the 2^25 staging cap (above the old f32 2^24
    # integer-exactness limit).
    ids = np.array([0, 4095, 4096, (1 << 24) + 12345, (1 << 25) - 1],
                   dtype=np.int64)
    packed = np.zeros((4, len(ids)), dtype=np.float32)
    packed[1] = (ids // 4096).astype(np.float32)
    packed[2] = (ids % 4096).astype(np.float32)
    assert (MXUExpansion._unpack_idx(packed) == ids).all()


def test_large_query_count_chunks():
    # m big enough to force several phase-2 lax.map chunks: at tile_n=512
    # the chunk is 2^21/512 = 4096 rows, so m=4100 runs 2 chunks with a
    # padded tail.
    rng = np.random.default_rng(7)
    refs = rng.random((1024, 16), dtype=np.float32)
    queries = rng.random((4100, 16), dtype=np.float32)
    eng = MXUExpansion(refs, tile_m=256, tile_n=512)
    assert recall_at_1(eng.query(queries), queries, refs) == 1.0


def test_band_refine_certifies_near_ties_without_full_scan():
    """Uncertified rows whose near-tie sits INSIDE the top-2 tiles must be
    answered exactly by the tier-1 band refine (top-2 tile direct-f32
    rescan, third-tile bound) with NO FusedBruteForce staging, matching
    the lowest-index tie-break."""
    rng = np.random.default_rng(21)
    k = 16
    refs = (rng.random((2000, k)) + 2.0).astype(np.float32)
    # Query equidistant-ish to refs[50] (tile 0) and refs[900] (tile 1 at
    # tile_n=512): a sub-band gap forces the main certificate to fail,
    # while tile 2+ stays far -> tier 1 certifies.
    q = refs[50].astype(np.float64)
    refs[900] = (q + 3e-6).astype(np.float32)  # near-duplicate, higher idx
    q = (q + 1.5e-6).astype(np.float32).reshape(1, -1)
    eng = MXUExpansion(refs, tile_m=8, tile_n=512)
    _, idx, cert = eng.query_min_idx_cert(q)
    assert not cert[0], "sub-band gap must fail the main certificate"
    out = eng.query_staged(eng.stage_queries(q))
    # Exact: one of the two near-tied points, and FusedBruteForce was
    # never staged (tier 1 resolved it).
    d50 = ((q[0].astype(np.float64) - refs[50]) ** 2).sum()
    d900 = ((q[0].astype(np.float64) - refs[900]) ** 2).sum()
    want = 50 if d50 <= d900 else 900
    assert int(out[0]) == want
    assert eng._fallback is None


def test_band_refine_two_tile_duplicate_resolved_by_tier1():
    """An exact duplicate in a DIFFERENT tile is still resolved by tier 1:
    the tied tile is one of the top-2 by tmin, so both copies are gathered,
    the lowest index wins, and the third-tile bound certifies."""
    rng = np.random.default_rng(22)
    k = 16
    refs = (rng.random((2000, k)) + 2.0).astype(np.float32)
    refs[1600] = refs[30]  # tile 3 duplicate of a tile-0 point
    q = refs[30:31].copy()
    eng = MXUExpansion(refs, tile_m=8, tile_n=512)
    _, _, cert = eng.query_min_idx_cert(q)
    assert not cert[0]
    out = eng.query_staged(eng.stage_queries(q))
    assert int(out[0]) == 30  # lowest index of the exact tie
    assert eng._fallback is None, "two-tile tie resolves in tier 1"


def test_band_refine_three_tile_tie_resolved_by_in_program_full_scan():
    """Exact copies in THREE tiles: the top-2 gather must miss one, the
    third-tile bound equals the winner value, tier 1 refuses, and the
    IN-PROGRAM tier-2 full scan (round 5: _full_scan_rows under the second
    lax.cond, replacing the per-drain host round trip) answers with the
    lowest reference index — without ever building the host fallback."""
    rng = np.random.default_rng(23)
    k = 16
    refs = (rng.random((2000, k)) + 2.0).astype(np.float32)
    refs[1100] = refs[30]  # tile 2
    refs[1600] = refs[30]  # tile 3
    q = refs[30:31].copy()
    eng = MXUExpansion(refs, tile_m=8, tile_n=512)
    _, _, cert = eng.query_min_idx_cert(q)
    assert not cert[0]
    out = eng.query_staged(eng.stage_queries(q))
    assert int(out[0]) == 30
    assert eng._fallback is None, "tier 2 must resolve in-program"


def test_tier2_bucket_overflow_reaches_host_full_scan():
    """More straddling-tie rows than the tier-2 static bucket: overflow
    rows stay sign-encoded and the host full scan re-answers them — the
    soundness backstop for adversarial tie floods."""
    rng = np.random.default_rng(29)
    k = 16
    n = 2000
    refs = (rng.random((n, k)) + 2.0).astype(np.float32)
    # Every query is a three-tile exact duplicate -> tier 1 refuses all.
    n_dup = 96
    for i in range(n_dup):
        refs[600 + i] = refs[i]    # tile 2
        refs[1700 + i] = refs[i]   # tile 3
    q = refs[:n_dup].copy()
    eng = MXUExpansion(refs, tile_m=8, tile_n=512)
    eng._maxbad2 = lambda m: 8  # force overflow past the tier-2 bucket
    out = eng.query_staged(eng.stage_queries(q))
    np.testing.assert_array_equal(out, np.arange(n_dup, dtype=np.int32))
    assert eng._fallback is not None, "overflow must reach the host scan"


def test_chunked_dispatch_matches_monolith():
    """Deep drains split into per-chunk dispatches (_m_cap) whose packed
    and band outputs are device-concatenated: answers, certificates, and
    the band refine's row indexing must be identical to the monolithic
    path (the last chunk carries row padding; full chunks must not)."""
    rng = np.random.default_rng(31)
    refs = (rng.random((3000, 16)) + 1.0).astype(np.float32)
    queries = (rng.random((150, 16)) + 1.0).astype(np.float32)
    # Near-ties to force uncertified rows THROUGH the band refine in the
    # chunked regime (rows 10 and 130 land in different chunks at cap=64).
    queries[10] = refs[900] + 2e-6
    queries[130] = refs[1700] + 2e-6
    refs[2500] = refs[900] + 4e-6  # runner-up in another tile
    eng_m = MXUExpansion(refs, tile_m=8, tile_n=512)
    eng_c = MXUExpansion(refs, tile_m=8, tile_n=512)
    eng_c._m_cap = 64  # 150 rows -> chunks of 64, 64, 22 (padded tail)
    pm = eng_m._query_packed(queries)
    pc = eng_c._query_packed(queries)
    np.testing.assert_array_equal(pm, pc)
    out_m = eng_m.query(queries)
    out_c = eng_c.query(queries)
    np.testing.assert_array_equal(out_m, out_c)
    assert recall_at_1(out_c, queries, refs) == 1.0

def test_drain_bucket_overflow_stays_exact():
    """More uncertified rows than the drain's static maxbad bucket: the
    overflow rows must come back sign-encoded (negative) from
    _expansion_drain and be re-answered exactly by the tier-2 full scan.
    512 exact-duplicate queries against a 1000-point set all fail the
    certificate, overflowing the 128-row minimum bucket by 4x."""
    rng = np.random.default_rng(41)
    k = 16
    refs = (rng.random((1000, k)) + 1.0).astype(np.float32)
    refs[700] = refs[30]  # every query has an exact duplicate pair
    q = np.repeat(refs[30:31], 512, axis=0).astype(np.float32)
    eng = MXUExpansion(refs, tile_m=8, tile_n=128)
    st = eng.stage_queries(q)
    assert eng._maxbad(512) == 128
    signed = eng._drain_staged(st)
    assert (signed < 0).sum() > 128, "flood must overflow the bucket"
    out = eng.query_staged(st)
    # both copies are true NNs; the brute-force family tie-break picks 30
    assert set(np.unique(out)) <= {30, 700}
    assert recall_at_1(out, q, refs) == 1.0


def test_split_bf16x3_residuals_survive_jit():
    """The triple-bf16 split must NOT collapse under jit: XLA may fold
    ``x - f32(bf16(x))`` to 0 unless the casts are pinned, which silently
    turns the in-jit query-side splits into a plain bf16 truncation and
    voids the phase-1 error band the v9 certificate relies on. Pins the
    optimization_barrier fix in _split_bf16x3."""
    import jax
    import jax.numpy as jnp

    from nns.kernels.mxu_expansion import _split_bf16x3

    x = jnp.asarray(
        np.random.default_rng(0).random((8, 16), dtype=np.float32) + 0.1
    )

    @jax.jit
    def split(x):
        hi, mid, lo = _split_bf16x3(x)
        err0 = jnp.max(jnp.abs(x - hi.astype(jnp.float32)))
        err2 = jnp.max(jnp.abs(
            x - hi.astype(jnp.float32) - mid.astype(jnp.float32)
            - lo.astype(jnp.float32)
        ))
        mid_max = jnp.max(jnp.abs(mid.astype(jnp.float32)))
        return err0, err2, mid_max

    err0, err2, mid_max = (float(v) for v in split(x))
    # bf16 alone truncates ~2^-9 relative; the triple must carry ~24 bits.
    assert err0 > 1e-5, "test vector too benign for bf16 truncation"
    assert mid_max > 0.0, "mid residual folded to zero under jit"
    assert err2 < 1e-6, f"triple reconstruction error {err2}"
