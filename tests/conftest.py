"""Test configuration: an 8-device virtual CPU mesh, or the card.

By default the suite runs on the CPU, with the Pallas kernels in interpret
mode and an 8-device virtual CPU mesh for the sharded paths. This must run
before any JAX backend use. ``chip_smoke.py`` runs the tests marked ``gpu``
in its own process on the card; it sets NNS_TESTS_ON_DEVICE=1 so that the
backend it already opened is left alone.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("NNS_TESTS_ON_DEVICE") != "1":
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest

from nns.data import make_dataset


@pytest.fixture
def gpu():
    """For tests marked ``gpu``: skip unless JAX's backend is a GPU (decided
    here, at run time, never while a module is imported)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: chip_smoke.py runs it on the card")


@pytest.fixture(scope="session")
def small_dataset():
    return make_dataset(k=3, m=64, n=1000, seed=1000)


@pytest.fixture(scope="session")
def grid_datasets():
    """Scaled-down reference grid: same (k, m) corners, smaller n for CI."""
    cases = []
    for k, m, n in [(3, 1, 1024), (16, 1, 1024), (3, 128, 1024),
                    (16, 128, 1024), (3, 256, 4096), (16, 64, 4096)]:
        q, r = make_dataset(k, m, n, seed=1000)
        cases.append((k, m, n, q, r))
    return cases


def assert_exact(idx, queries, refs):
    from nns.kernels.oracle import recall_at_1

    idx = np.asarray(idx)
    assert idx.shape == (queries.shape[0],)
    r = recall_at_1(idx, queries, refs)
    assert r == 1.0, f"recall@1 = {r}, expected 1.0"
