"""Uniform public API + the version registry (ladder v0..v13 + v14 flagship).

Reference analog: the single shared signature `vN::cudaCall(k, m, n,
s_points, r_points, results)` (core.cu:23-29) and the 14-way dispatch table
in main.cu:89-135. Here every version is a callable
``fn(queries[m,k] f32, refs[n,k] f32) -> idx[m] i32`` plus an optional
build/query split (``NNEngine``) so tree versions report build time
separately, as the reference does (core.cu:1158-1159).

The capability-fallback contract mirrors the reference (SURVEY.md §5):
- KD-tree versions (v10/v11) fall back to v0 for k > 16 (core.cu:1148-1149),
- octree versions (v12/v13) fall back to v0 for k != 3 (core.cu:1641-1644),
- the sharded version (v8) falls back to the single-device fused scan when
  only one device exists (core.cu:774-777).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from nns.config import DEFAULT_ENGINE_CONFIG, EngineConfig


def _as_idx(x: Any) -> np.ndarray:
    return np.asarray(x).astype(np.int32)


def _check_finite(arr: np.ndarray, name: str) -> None:
    """NaN/inf coordinates silently poison distance comparisons (NaN loses
    every < and so never updates a carry; inf-inf traps); reject them at the
    API boundary with a clear error instead."""
    if not np.isfinite(arr).all():
        raise ValueError(
            f"{name} contains non-finite values (NaN/inf); exact NN search "
            "is defined for finite float32 coordinates only"
        )


# --------------------------------------------------------------------------
# Version implementations (thin adapters over the kernel modules)
# --------------------------------------------------------------------------


def _v0(q, r, cfg):
    from nns.kernels.oracle import linear_scan

    return linear_scan(np.asarray(q), np.asarray(r))


def _v1(q, r, cfg):
    from nns.kernels.xla_bruteforce import nns_distance_matrix

    return _as_idx(nns_distance_matrix(q, r))


def _v2(q, r, cfg):
    from nns.kernels.xla_bruteforce import nns_expansion_matmul

    return _as_idx(nns_expansion_matmul(q, r))


def _fused(q, r, cfg, splits=None):
    from nns.kernels.pallas_fused import nns_fused

    return _as_idx(nns_fused(q, r, tile_m=cfg.tile_m, tile_n=cfg.tile_n,
                             splits=splits))


# On the GPU the CUDA ladder's memory-space rungs (v3 shared-memory fusion,
# v4 dim-major refs, v5 read-only streaming, v6 constant-memory queries) are
# one fused scan; v7 forces its reference split across programs.
_V7_SPLITS = 8


def _v4(q, r, cfg):
    return _fused(q, r, cfg)


def _v7(q, r, cfg):
    return _fused(q, r, cfg, splits=_V7_SPLITS)


def _v8(q, r, cfg):
    from nns.parallel.sharded import nns_sharded

    return _as_idx(nns_sharded(q, r, tile_m=cfg.tile_m, tile_n=cfg.tile_n))


def _v9(q, r, cfg):
    # The reference's "best brute force" (core.cu:856-1058). Ours moves the
    # distance FLOPs onto the tensor cores: split-bf16 expansion products +
    # band certificate + exact refine of uncertified queries
    # (mxu_expansion.py). It picks its own tiles.
    from nns.kernels.mxu_expansion import nns_mxu_expansion

    return _as_idx(nns_mxu_expansion(q, r))


def _v10(q, r, cfg):
    from nns.trees.kdtree import nns_kdtree_host

    return _as_idx(nns_kdtree_host(q, r, max_k=cfg.kd_max_k))


def _v11(q, r, cfg):
    from nns.trees.kdtree_device import nns_kdtree_device

    return _as_idx(nns_kdtree_device(q, r, max_k=cfg.kd_max_k))


def _v12(q, r, cfg):
    from nns.trees.octree import nns_octree_host

    return _as_idx(nns_octree_host(q, r, max_depth=cfg.octree_max_depth))


def _v13(q, r, cfg):
    from nns.trees.octree_device import nns_octree_device

    return _as_idx(nns_octree_device(q, r, max_depth=cfg.octree_max_depth))


@dataclasses.dataclass(frozen=True)
class VersionSpec:
    num: int
    name: str
    family: str  # "cpu" | "bruteforce" | "sharded" | "tree"
    fn: Callable[..., np.ndarray]
    description: str

    def __call__(self, queries, refs, config: EngineConfig | None = None) -> np.ndarray:
        return self.fn(queries, refs, config or DEFAULT_ENGINE_CONFIG)


def _v14(q, r, cfg):
    from nns.kernels.cell_list import nns_cell_list

    return _as_idx(nns_cell_list(q, r))


_SPECS = [
    VersionSpec(0, "cpu_scan", "cpu", _v0, "CPU linear scan (oracle; core.cu v0)"),
    VersionSpec(1, "distance_matrix", "bruteforce", _v1, "XLA distance + row argmin (v1)"),
    VersionSpec(2, "expansion_matmul", "bruteforce", _v2, "|q-r|^2 expansion matmul + exact refine + XLA argmin (v2, thrust analog)"),
    VersionSpec(3, "fused_point_major", "bruteforce", _v4, "fused scan (v3's shared-memory fusion)"),
    VersionSpec(4, "fused", "bruteforce", _v4, "fused scan, dim-major refs (v4, SoA analog)"),
    VersionSpec(5, "fused_streaming", "bruteforce", _v4, "fused scan, pipelined ref tiles (v5, read-only-path analog)"),
    VersionSpec(6, "fused_queries_resident", "bruteforce", _v4, "fused scan, query tile held in registers (v6, constant-memory analog)"),
    VersionSpec(7, "two_level", "bruteforce", _v7, "fused scan with the ref axis split across programs + second reduce (v7, multi-block analog)"),
    VersionSpec(8, "sharded", "sharded", _v8, "refs sharded over the mesh, on-device argmin merge (v8, 4-GPU analog)"),
    VersionSpec(9, "mxu_expansion", "bruteforce", _v9, "split-bf16 tensor-core expansion + band certificate + exact refine (v9, best-brute-force analog)"),
    VersionSpec(10, "kdtree_host", "tree", _v10, "KD-tree host build + host query (v10)"),
    VersionSpec(11, "kdtree_device", "tree", _v11, "KD-tree host build + beam frontier device query (v11 — actually runs, unlike core.cu:1345)"),
    VersionSpec(12, "octree_host", "tree", _v12, "octree host build + host query (v12)"),
    VersionSpec(13, "octree_device", "tree", _v13, "octree host build + beam frontier device query (v13 — actually runs, unlike core.cu:1793)"),
    # Beyond the reference ladder: the framework's own flagship spatial index.
    VersionSpec(14, "cells", "tree", _v14, "supercell dense spatial index, batched fused scan + exactness certificate (beyond-ladder flagship for 3-D)"),
]

REGISTRY: dict[int, VersionSpec] = {s.num: s for s in _SPECS}
_BY_NAME: dict[str, VersionSpec] = {s.name: s for s in _SPECS}


def get_version(version: int | str) -> VersionSpec:
    if isinstance(version, str) and version in _BY_NAME:
        return _BY_NAME[version]
    try:
        return REGISTRY[int(version)]
    except (KeyError, ValueError):
        raise KeyError(
            f"unknown version {version!r}; valid: 0..{max(REGISTRY)} or names {sorted(_BY_NAME)}"
        )


def list_versions() -> list[VersionSpec]:
    return list(_SPECS)


def nns(
    queries,
    refs,
    version: int | str = "auto",
    config: EngineConfig | None = None,
) -> np.ndarray:
    """Exact 1-NN: for each query, the index of its nearest reference point.

    ``version="auto"`` dispatches to the widest capable path: the sharded
    brute force when multiple devices are visible, else the single-chip
    fused kernel (the graceful-degradation contract of SURVEY.md §5).
    """
    queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
    refs = np.atleast_2d(np.asarray(refs, dtype=np.float32))
    if queries.shape[1] != refs.shape[1]:
        raise ValueError(
            f"dimension mismatch: queries k={queries.shape[1]}, refs k={refs.shape[1]}"
        )
    if refs.shape[0] == 0:
        raise ValueError("reference set is empty")
    _check_finite(queries, "queries")
    _check_finite(refs, "refs")
    cfg = config or DEFAULT_ENGINE_CONFIG
    if version == "auto":
        import jax

        # One-shot semantics: no index build amortization, so brute force —
        # sharded across every visible device, else the fused single-chip
        # kernel. (Index-building engines pay off via NNEngine, whose auto
        # dispatch picks the supercell flagship for large 3-D sets.)
        spec = REGISTRY[8] if len(jax.devices()) > 1 else REGISTRY[4]
    else:
        spec = get_version(version)
    return spec(queries, refs, cfg)


class NNEngine:
    """Build/query split over any version — how the harness times tree builds
    separately from queries (reference: core.cu:1154-1161 prints build and
    query phases separately).

    For brute-force versions "build" is reference-set staging (device
    placement + layout); for tree versions it is tree construction. Tree
    engines also support ``save``/``load`` (the checkpoint subsystem the
    reference lacks, SURVEY.md §5).
    """

    def __init__(self, version: int | str = "auto", config: EngineConfig | None = None):
        self.config = config or DEFAULT_ENGINE_CONFIG
        self._auto = version == "auto"
        self.spec = None if self._auto else get_version(version)
        self._built: Any = None
        self._refs: np.ndarray | None = None
        self._cov_miss = 0
        self._cov_seen = 0
        # High-k (v9) adaptation state — see _query_high_k.
        self._hk_seen = 0
        self._hk_probed = False
        self._hk_beam = 8
        self._hk_budget: int | None = None  # chunk-scan bucket budget
        self._hk_mxu: Any = None
        self._hk_recent: np.ndarray | None = None

    def _note_coverage(self, cov: float, m: int, good_cov: float,
                       miss_frac: float) -> bool:
        """Batch-weighted certificate-coverage hysteresis. Accumulates
        coverage-weighted misses; returns True (and clears the history)
        once a sustained miss rate over a real query budget (>= 128 seen,
        > miss_frac missed) says the engine should switch. Well-covered
        batches DECAY the history by half rather than resetting it: a
        reset let alternating good batches mask an aggregate 40% miss
        rate forever, while decay still shields one-off outlier batches
        (a singleton miss fixed-points at ~1 weighted miss)."""
        self._cov_miss += int(round((1.0 - cov) * m))
        self._cov_seen += m
        if cov >= good_cov:
            self._cov_miss //= 2
            self._cov_seen //= 2
            return False
        if self._cov_seen >= 128 and self._cov_miss > miss_frac * self._cov_seen:
            self._cov_miss = 0
            self._cov_seen = 0
            return True
        return False

    def _promote_to_beam(self) -> None:
        from nns.trees.octree import Octree

        self._built = Octree.build(
            self._refs, max_depth=self.config.octree_max_depth
        ).device_index()

    # -- high-k (v9) adaptation ladder ----------------------------------------

    def _hk_fallback(self, q_bad: np.ndarray) -> np.ndarray:
        """Exact re-answer of beam-uncertified rows by the retained MXU
        engine, pow2-shape-bucketed so a varying tail size cannot mint a
        fresh drain compile per call (the same bucketing MXUExpansion's own
        tier-2 uses)."""
        from nns.kernels.layouts import pow2_at_least

        nb = len(q_bad)
        bucket = pow2_at_least(max(nb, 8))
        if bucket != nb:
            q_bad = np.pad(q_bad, ((0, bucket - nb), (0, 0)))
        return self._hk_mxu.query(q_bad)[:nb]

    def _query_high_k(self, queries: np.ndarray) -> np.ndarray:
        """v9 serving path with the workload-adaptation ladder the 3-D
        flagship already has, one abstraction level up: the expansion full
        scan is the right engine for UNIFORM high-k data, but on
        structured/clustered data a KD beam-frontier index prunes the
        scanned set 10-100x at any k (beam.py is k-generic). After enough
        query volume, probe the beam's certificate coverage on live queries
        and promote when it prunes well; sustained coverage misses demote
        back to the retained expansion engine (not the fused scan).
        Exactness is unconditional on every rung: beam-uncertified rows are
        re-answered by the expansion engine,
        whose own uncertified rows take the exact fused scan."""
        from nns.trees.beam import BeamIndex

        if isinstance(self._built, BeamIndex):
            idx, cov = self._built.query_with_coverage(
                queries, beam=self._hk_beam, budget=self._hk_budget
            )
            if self._note_coverage(
                cov, queries.shape[0], good_cov=0.5, miss_frac=0.7
            ):
                if self._hk_budget is not None:
                    # The scan rung's chunk-locality assumption failed on
                    # the live stream (its probe only certified PER-QUERY
                    # beam-16 coverage): demote scan -> per-query beam with
                    # a fresh hysteresis window before giving up the index.
                    self._hk_budget = None
                else:
                    from nns.kernels.mxu_expansion import MXUExpansion

                    self._built = self._hk_mxu or MXUExpansion(self._refs)
            return _as_idx(idx)
        idx = _as_idx(self._built.query(queries))
        self._maybe_promote_high_k(queries)
        return idx

    def _maybe_promote_high_k(self, queries: np.ndarray) -> None:
        """One-time probe: build the KD beam index and measure its
        certificate coverage on the most recent live queries, exactly as the
        serving path would run it (base beam pass + 4x retry of the
        uncertified tail). High coverage promotes — preferring beam=4 when
        it already covers (half the bucket-gather traffic of 8); low
        coverage keeps the MXU scan and closes the avenue for this engine
        (uniform high-k data genuinely needs the full scan — measured
        coverage 0.0015 at 16-D uniform vs 1.0 clustered in-distribution).
        The probe is deferred behind hk_probe_after queries so one-shot
        callers never pay the index build stall (~1-3 s at 1M x 16)."""
        cfg = self.config
        if (
            self._hk_probed
            or self._refs.shape[0] < cfg.hk_promote_n_min
            or self._refs.shape[1] > cfg.kd_max_k
        ):
            return
        self._hk_seen += queries.shape[0]
        # Rolling probe buffer: the most recent <= 512 live queries, so a
        # tiny triggering batch (down to a single query) still probes on a
        # representative window of the workload.
        recent = queries[-512:]
        if self._hk_recent is not None and len(recent) < 512:
            recent = np.concatenate(
                [self._hk_recent[-(512 - len(recent)):], recent], axis=0
            )
        self._hk_recent = recent
        if self._hk_seen < cfg.hk_probe_after:
            return
        self._hk_probed = True  # probe once per built engine
        self._hk_recent = None  # buffer served its purpose
        from nns.trees.kdtree import KDTree

        bi = KDTree.build(self._refs).device_index()
        probe = recent

        def _promote(beam: int, budget: int | None = None) -> None:
            self._hk_mxu = self._built
            bi.exact_fallback = self._hk_fallback
            self._hk_beam = beam
            self._hk_budget = budget
            self._built = bi

        # Rung 1: the chunk-scan drain (beam._chunk_scan_core) — ONE shared
        # budget-bucket candidate set per locality-sorted chunk + the exact
        # fused Pallas scan, ~100x less gather traffic than any per-query
        # beam at equal coverage. The scan CANNOT be probed directly: the
        # 512-query probe window spans the whole workload's buckets, so
        # staged as ONE chunk its bucket union blows any budget — unlike a
        # real serving queue, whose locality-sorted chunks each concentrate
        # in a few blobs. Predictor instead: per-query beam-16 BASE
        # coverage (16 buckets/query suffice => a sorted chunk's shared
        # budget-bucket set covers its blob union). If the locality
        # assumption fails on the live stream, serving demotes scan ->
        # beam -> MXU (_query_high_k), so a mispredict costs one
        # hysteresis window, never exactness.
        scan_ready = bi.desc_dim is not None and bi.lo.shape[0] >= 4 * 16
        if scan_ready:
            _, ok = bi.query_with_flags(probe, beam=16)
            if float(ok.mean()) >= cfg.hk_promote_cov:
                budget = min(cfg.hk_scan_budget, bi.lo.shape[0] // 2)
                return _promote(16, budget=budget)
        # Rung 2: the smallest per-query beam whose BASE pass covers (a
        # serving path of base(beam) + retry(4*beam) on a thin tail; a beam
        # that only covers WITH the retry makes every drain pay base as a
        # dead pass plus the 4x-wider rescan of ~all rows — on 1M clustered
        # 16-D, base-4 coverage was 0.005). Skipped when the
        # rung-1 predictor already measured beam-16 base coverage short of
        # the bar: base coverage is monotone in beam, so 4/8 cannot pass.
        if not scan_ready:
            for beam in (4, 8, 16):
                if bi.lo.shape[0] < 4 * beam:
                    break  # beam covers >= 1/4 of the frontier: not pruning
                _, ok = bi.query_with_flags(probe, beam=beam)
                if float(ok.mean()) >= cfg.hk_promote_cov:
                    return _promote(beam)
        # No base pass covers — accept a retry-dependent beam (it scans far
        # fewer points than the certificate-collapsed full scan on
        # clustered data); keep the v9 engine if even that fails.
        for beam in (4, 8):
            _, ok = bi.query_with_flags(probe, beam=beam)
            bad = np.flatnonzero(~ok)
            if len(bad) and bi.lo.shape[0] > 4 * beam:
                _, ro = bi.query_with_flags(probe[bad], beam=beam * 4)
                ok[bad] = ro
            if float(ok.mean()) >= cfg.hk_promote_cov:
                return _promote(beam)

    def build(self, refs) -> "NNEngine":
        refs = np.atleast_2d(np.asarray(refs, dtype=np.float32))
        _check_finite(refs, "refs")
        self._refs = refs
        self._cov_miss = 0  # fresh index: forget prior coverage history
        self._cov_seen = 0
        self._hk_seen = 0   # fresh index: re-arm the high-k probe
        self._hk_probed = False
        self._hk_beam = 8
        self._hk_budget = None
        self._hk_mxu = None
        self._hk_recent = None
        if self._auto:
            import jax

            # Build/query semantics amortize index construction: prefer the
            # supercell flagship for large 3-D sets (its build shards over
            # the mesh on multi-device runtimes), the sharded brute force for
            # other shapes across several devices, the v9 expansion engine
            # (with its KD-beam promotion ladder) for high-k single-device
            # sets, else the fused kernel.
            if refs.shape[1] == 3 and refs.shape[0] >= 65536:
                self.spec = get_version(14)
            elif len(jax.devices()) > 1:
                self.spec = get_version(8)
            elif refs.shape[1] >= 8:
                self.spec = get_version(9)
            else:
                self.spec = get_version(4)
        if self.spec.family == "tree":
            if self.spec.num == 14:
                from nns.kernels.pallas_fused import FusedBruteForce

                if refs.shape[1] == 3 and refs.shape[0] >= 4096:
                    import jax

                    from nns.kernels.cell_list import CellListEngine

                    try:
                        if self._auto and len(jax.devices()) > 1:
                            # Multi-device flagship (AUTO only —
                            # explicit v14 stays the single-chip rung,
                            # matching the reference ladder where v8 is
                            # the multi-GPU version): halo groups
                            # partition over the mesh; the canonical
                            # queue drain and query/query_many surfaces
                            # are inherited, so the serving protocol is
                            # the same engine, sharded — including
                            # placement-free save/load (one npz restores
                            # single-chip or onto any mesh size,
                            # sharded_cells.py). Trade-off: the
                            # beam/brute adaptation ladder stays off
                            # (its indices are single-chip; the exact
                            # fallback still answers uncovered queries).
                            from nns.parallel.mesh import make_mesh
                            from nns.parallel.sharded_cells import (
                                ShardedCellEngine,
                            )

                            self._built = ShardedCellEngine(refs, make_mesh())
                        else:
                            self._built = CellListEngine(refs)
                    except ValueError:
                        # Too clustered for the cell index: degrade ONCE at
                        # build time to the staged fused engine (re-attempting
                        # the O(n) host build per query batch would be
                        # pathological).
                        self._built = FusedBruteForce(refs)
                else:
                    # Non-3-D / tiny sets: stage the fused engine ONCE —
                    # build/query semantics must not pay the per-call refs
                    # transfer.
                    self._built = FusedBruteForce(refs)
            elif self.spec.num == 10 and refs.shape[1] <= self.config.kd_max_k:
                from nns.trees.kdtree import KDTree

                self._built = KDTree.build(refs)
            elif self.spec.num == 11 and refs.shape[1] <= 6:
                # The device KD path only pays below ~7 dims (higher k
                # degenerates toward a full scan — nns_kdtree_device routes
                # it to the fused kernel, and so does the unbuilt fallback
                # below); stage the beam frontier now.
                from nns.trees.kdtree import KDTree

                self._built = KDTree.build(refs)
                self._built.device_index()
            elif self.spec.num == 11 and refs.shape[1] <= self.config.kd_max_k:
                # 6 < k <= max_k: the beam path degenerates toward a full
                # scan, so v11's build stages the fused engine ONCE instead
                # of transferring the refs on every query call.
                from nns.kernels.pallas_fused import FusedBruteForce

                self._built = FusedBruteForce(refs)
            elif self.spec.num in (12, 13) and refs.shape[1] == self.config.octree_k:
                from nns.trees.octree import Octree

                self._built = Octree.build(refs, max_depth=self.config.octree_max_depth)
                if self.spec.num == 13:
                    self._built.device_index()  # stage the beam frontier now
            elif self.spec.num == 13:
                # k != 3: v13's exact fallback is the fused device scan
                # — stage it ONCE at build, exactly as v11's high-k route
                # does. Left unbuilt, every query call pays the per-call
                # refs transfer.
                from nns.kernels.pallas_fused import FusedBruteForce

                self._built = FusedBruteForce(refs)
            else:
                self._built = None  # falls back to brute force at query time
        elif self.spec.num == 4:
            # Prepare-once/query-many staging for the fused flagship.
            from nns.kernels.pallas_fused import FusedBruteForce

            self._built = FusedBruteForce(
                refs, tile_m=self.config.tile_m, tile_n=self.config.tile_n
            )
        elif self.spec.num == 9 and refs.shape[1] >= 8:
            # v9's split-bf16 staging (triple split + transpose + device
            # placement) is the expensive half — prepare it once. Sets past
            # the engine's device staging bound (n >= 2^25) degrade ONCE at
            # build time to the staged fused engine (SURVEY.md §5 contract).
            from nns.kernels.mxu_expansion import MXUExpansion
            from nns.kernels.pallas_fused import FusedBruteForce

            try:
                self._built = MXUExpansion(refs)
            except ValueError:
                self._built = FusedBruteForce(refs)
        else:
            import jax

            staged = jax.device_put(refs)
            jax.block_until_ready(staged)
        return self

    def query(self, queries) -> np.ndarray:
        if self._refs is None:
            raise RuntimeError("call build(refs) first")
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        if queries.shape[1] != self._refs.shape[1]:
            raise ValueError(
                f"dimension mismatch: queries k={queries.shape[1]}, "
                f"refs k={self._refs.shape[1]}"
            )
        _check_finite(queries, "queries")
        if self.spec.num in (4, 9) and self._built is not None:
            if self.spec.num == 9:
                return self._query_high_k(queries)
            return _as_idx(self._built.query(queries))
        if self.spec.family == "tree" and self._built is not None:
            if self.spec.num == 14:
                from nns.kernels.cell_list import CellListEngine
                from nns.trees.beam import BeamIndex

                if isinstance(self._built, CellListEngine):
                    idx, cov = self._built.query_with_coverage(queries)
                    # Workload adaptation, step 1: when the fixed-halo
                    # certificate persistently misses the query distribution
                    # (e.g. sparse-region queries over clustered refs),
                    # promote to the adaptive-depth octree beam index, whose
                    # buckets track the data density (measured 99.8%
                    # coverage where the fixed halo certifies 18%). Promotion
                    # is batch-weighted WITH hysteresis (see _note_coverage):
                    # the octree build + beam staging is a synchronous stall
                    # (~1.8 s at 1M clustered), so a single stray outlier
                    # batch (cov 0.0 at m = 1) must never trigger it — only
                    # a sustained miss rate over a real query budget does.
                    if self._note_coverage(
                        cov, queries.shape[0], good_cov=0.95, miss_frac=0.3
                    ) and type(self._built) is CellListEngine:
                        self._promote_to_beam()
                    return _as_idx(idx)
                if isinstance(self._built, BeamIndex):
                    idx, cov = self._built.query_with_coverage(queries)
                    # Workload adaptation, step 2: if even the beam index's
                    # coverage stays poor (adversarial distributions), its
                    # passes are pure overhead on top of the exact scan —
                    # demote to the staged fused engine. Miss counts weight
                    # by batch size so stray single-query misses cannot
                    # demote a well-covered workload.
                    if self._note_coverage(
                        cov, queries.shape[0], good_cov=0.5, miss_frac=0.7
                    ):
                        from nns.kernels.pallas_fused import FusedBruteForce

                        self._built = FusedBruteForce(self._refs)
                    return _as_idx(idx)
                return _as_idx(self._built.query(queries))
            if self.spec.num == 10:
                return _as_idx(self._built.query_host(queries))
            if self.spec.num == 11:
                from nns.kernels.pallas_fused import FusedBruteForce

                if isinstance(self._built, FusedBruteForce):  # staged high-k route
                    return _as_idx(self._built.query(queries))
                return _as_idx(self._built.query_device(queries))
            if self.spec.num == 12:
                return _as_idx(self._built.query_host(queries))
            if self.spec.num == 13:
                from nns.kernels.pallas_fused import FusedBruteForce

                if isinstance(self._built, FusedBruteForce):  # staged k != 3 route
                    return _as_idx(self._built.query(queries))
                return _as_idx(self._built.query_device(queries))
        return self.spec(queries, self._refs, self.config)

    def query_many(self, batches) -> list[np.ndarray]:
        """Exact answers for several query batches in as few device
        round-trips as possible (the serving path bench.py measures). With
        a built supercell index the whole queue drains in ONE device
        dispatch (CellListEngine.query_queue); beam/fused engines answer
        the concatenated queue in one call (their queries are independent,
        so one dispatch + one fetch serves the whole queue); anything else
        answers per batch."""
        if self._refs is None:
            raise RuntimeError("call build(refs) first")
        from nns.kernels.cell_list import CellListEngine
        from nns.kernels.mxu_expansion import MXUExpansion
        from nns.kernels.pallas_fused import FusedBruteForce
        from nns.trees.beam import BeamIndex

        batches = [np.atleast_2d(np.asarray(b, dtype=np.float32)) for b in batches]
        # Same input contract as query(): the queue branches below go
        # straight to the engines, so validate here.
        for b in batches:
            if b.shape[1] != self._refs.shape[1]:
                raise ValueError(
                    f"dimension mismatch: queries k={b.shape[1]}, "
                    f"refs k={self._refs.shape[1]}"
                )
            _check_finite(b, "queries")
        # The supercell queue drain is natively RAGGED (per-batch pow2
        # q_max staging + per-tier canonical sub-drains), so mixed-m /
        # mixed-shape queues keep the one-program drain instead of
        # degrading to per-batch calls.
        if isinstance(self._built, CellListEngine):
            results, covs = self._built.query_queue(batches, return_coverage=True)
            # The serving path feeds the same promotion hysteresis as
            # query(): per-batch coverage accumulates, and a sustained miss
            # rate promotes AFTER the drain (the answers of this queue are
            # already exact via the fallback; the next queue gets the beam
            # index).
            promote = False
            for qb, cov in zip(batches, covs):
                if self._note_coverage(cov, qb.shape[0],
                                       good_cov=0.95, miss_frac=0.3):
                    promote = True
            if promote and type(self._built) is CellListEngine:
                self._promote_to_beam()
            return [_as_idx(i) for i in results]
        if (
            isinstance(self._built, (BeamIndex, FusedBruteForce, MXUExpansion))
            and batches
            and len({b.shape[1] for b in batches}) == 1
        ):
            allq = np.concatenate(batches, axis=0)
            idx = self.query(allq)  # one dispatch; hysteresis sees one batch
            offs = np.cumsum([b.shape[0] for b in batches])[:-1]
            return [_as_idx(part) for part in np.split(np.asarray(idx), offs)]
        return [self.query(b) for b in batches]

    def query_topk(self, queries, k_nn: int = 8):
        """Exact k-NN: (dist2[m, k], idx[m, k]) ascending. Uses the built
        supercell index when available (certificate-gated), else the exact
        chunked top-k scan."""
        if self._refs is None:
            raise RuntimeError("call build(refs) first")
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        if queries.shape[1] != self._refs.shape[1]:
            raise ValueError(
                f"dimension mismatch: queries k={queries.shape[1]}, "
                f"refs k={self._refs.shape[1]}"
            )
        from nns.kernels.cell_list import CellListEngine
        from nns.trees.beam import BeamIndex

        if isinstance(self._built, (CellListEngine, BeamIndex)):
            return self._built.query_topk(queries, k_nn)
        from nns.kernels.topk import nns_topk

        return nns_topk(queries, self._refs, k_nn)

    def save(self, path: str) -> None:
        if self.spec is None or self.spec.family != "tree" or self._built is None:
            raise ValueError("save() supports built tree/index engines only")
        if not hasattr(self._built, "save"):
            raise ValueError(
                f"the built {type(self._built).__name__} engine is not serializable"
            )
        self._built.save(path)

    @classmethod
    def load(cls, path: str, version: int | str, config: EngineConfig | None = None) -> "NNEngine":
        eng = cls(version, config)
        if eng.spec is None:
            raise ValueError("load() needs an explicit version, not 'auto'")
        spec = eng.spec
        if spec.num in (10, 11):
            from nns.trees.kdtree import KDTree

            eng._built = KDTree.load(path)
        elif spec.num in (12, 13):
            from nns.trees.octree import Octree

            eng._built = Octree.load(path)
        elif spec.num == 14:
            # v14 checkpoints come in two on-disk forms: the supercell halo
            # tensor, or the beam frontier a clustered workload promoted to.
            with np.load(path) as z:
                is_beam = "beam_pts" in z
            if is_beam:
                from nns.trees.beam import BeamIndex

                eng._built = BeamIndex.load(path)
            else:
                from nns.kernels.cell_list import CellListEngine

                eng._built = CellListEngine.load(path)
        else:
            raise ValueError("load() supports tree/index versions (10-14) only")
        eng._refs = eng._built.refs
        return eng
