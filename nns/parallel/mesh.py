"""Device-mesh construction helpers.

The reference discovers devices with cudaGetDeviceCount (core.cu:771) and
fans out one OpenMP thread per GPU. Here the devices form a 1-D
`jax.sharding.Mesh` and the fan-out is `jax.shard_map`: the collectives run
inside the jitted program (over NVLink between the cards of one host,
through NCCL) instead of bouncing through host memory (SURVEY.md §2.3).
Every card reaches every other at the same rate, so the mesh follows the
algorithm alone.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, axis: str = "shard") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
    return Mesh(np.array(devices[:n_devices]), (axis,))


def best_mesh(n: int, axis: str = "shard") -> Mesh:
    """Mesh sized for sharding ``n`` reference points: uses every device up
    to one per point (degenerate tiny-n case)."""
    n_dev = max(1, min(len(jax.devices()), n))
    return make_mesh(n_dev, axis)
