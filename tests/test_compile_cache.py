"""Where ``import nns`` puts XLA's persistent compilation cache: the
directory JAX_COMPILATION_CACHE_DIR names when it is set, else a fixed,
git-ignored directory in the checkout — never a path outside it."""

from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir(env_extra: dict[str, str]) -> str:
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", **env_extra)
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, nns; print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
        check=True,
    )
    return out.stdout.strip().splitlines()[-1]


def test_cache_in_checkout_by_default():
    assert _cache_dir({}) == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_honours_env(tmp_path):
    assert _cache_dir({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) == str(tmp_path)
