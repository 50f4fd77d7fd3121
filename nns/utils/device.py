"""The card a measurement ran on.

Every number this repository prints from a GPU run carries the card's name
and power limit (a card set below its 700 W maximum runs slower under
load), and a measurement path that finds no GPU stops instead of timing
the CPU.
"""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """``name, power.limit`` of every visible card, as nvidia-smi reports
    them (one card per line)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def require_gpu() -> dict:
    """The device as JAX reports it; raises when JAX found no GPU."""
    import jax

    if jax.default_backend() != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {jax.default_backend()!r}"
        )
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}
