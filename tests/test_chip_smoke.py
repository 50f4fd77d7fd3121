"""chip_smoke.py at toy size on the CPU: every phase runs and checks its
answers (kernels in interpret mode), the four-card phase runs on four
virtual CPU devices, and ``main`` refuses a backend that is not a GPU."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = """
import chip_smoke as cs
from nns.config import EngineConfig
cs.CHECK = 64
log = cs.Log("cpu")
"""

PHASES = {
    "kernels": "cs.phase_kernels(log, 20000, 256, 1000)",
    "cells": "cs.phase_cells(log, 65536, 256, 1000)",
    "high_k": "cs.phase_high_k(log, 1 << 17, 256, 1000)",
    "clustered": ("cs.phase_clustered(log, 1 << 16, 512, 1000, EngineConfig("
                  "hk_probe_after=256, hk_promote_n_min=1 << 15))"),
    "profile": "cs.phase_profile(log, 65536, 256, 1000)",
}


def _run(code: str, devices: int = 1) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "NNS_TESTS_ON_DEVICE"}
    env.update(JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    return subprocess.run([sys.executable, "-c", _PRELUDE + code], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("phase", list(PHASES))
def test_phase_at_toy_size(phase):
    r = _run(PHASES[phase])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[smoke]" in r.stdout and "(cpu)" in r.stdout


def test_four_card_phase_on_four_virtual_devices():
    r = _run("cs.phase_four_cards(log, 65536, 256, 1000)", devices=4)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("4 cards:") == 3


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_refuses_a_cpu_backend(argv, capsys):
    import chip_smoke

    assert chip_smoke.main(argv) != 0
    assert capsys.readouterr().out == ""  # no result line


def test_failed_check_raises():
    import chip_smoke

    chip_smoke.check(True, "fine")
    with pytest.raises(chip_smoke.SmokeFailure, match="recall 0.5"):
        chip_smoke.check(False, "recall 0.5")
