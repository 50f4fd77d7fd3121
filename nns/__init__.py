"""nns — an exact nearest-neighbor-search engine for NVIDIA GPUs.

Built in JAX/XLA/Pallas with the same capabilities as the CUDA reference
ladder sty-hhh/NNS-CUDA (see SURVEY.md):

- a uniform query API (``nns``) with a 15-version registry (v0..v13 mirroring
  the reference's optimization ladder + the v14 supercell flagship; reference:
  core.cu namespaces v0..v13, dispatch table main.cu:89-135),
- a brute-force family where the m x n distance computation is a fused
  Pallas kernel compiled through Triton (distances never leave registers;
  reference analog: the fused shared-memory kernel of core.cu:216),
- a multi-card family sharding the reference set over a `jax.sharding.Mesh`
  with an on-device (dist, idx) argmin merge (reference analog: the 4-GPU
  OpenMP data parallelism of core.cu:761-852),
- a spatial-tree family (KD-tree, octree) with flat device-resident tree
  arrays and stackless batched traversal (reference analog: core.cu v10-v13),
- a benchmark harness reproducing the reference's seeded (k, m, n) config
  grid and build/query timing split (reference: main.cu:38-51, 62-80).

Exactness contract: recall@1 = 1.0 — every version returns a true nearest
neighbor of the float32 inputs (verified against a float64 oracle).
"""

__version__ = "0.3.0"

import os as _os


def _enable_compile_cache() -> None:
    """Persistent XLA compilation cache, so that a process after the first
    skips recompiling the kernels (the durable form of the reference's
    warm-up trick, core.cu:1900-1933). JAX itself reads
    ``JAX_COMPILATION_CACHE_DIR`` when it is set; otherwise the cache lives
    at a fixed, git-ignored path in the checkout (the path is part of the
    cache key, so it must not move)."""
    import jax

    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
        jax.config.update("jax_compilation_cache_dir",
                          _os.path.join(root, ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


_enable_compile_cache()

from nns.api import nns, get_version, list_versions, NNEngine  # noqa: F401
from nns.config import BenchConfig, REFERENCE_GRID, DEFAULT_SEED  # noqa: F401
from nns.kernels.topk import nns_topk  # noqa: F401
