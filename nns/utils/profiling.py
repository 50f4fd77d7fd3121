"""Device-op profiling: trace a region and summarize WHERE device time goes.

The reference's only observability is a wall-clock bracket per cudaCall
(main.cu:73-76). A wall clock around asynchronous dispatch says little
about what the device did, so a perf investigation starts from the
profiler's trace instead:

    from nns.utils.profiling import profile_device_ops
    report = profile_device_ops(lambda: engine.query_many(batches))
    print(report)          # per-kernel device totals, sorted
    report.total_ms        # device-busy total (summed over kernels)
    report.ops["cell_scan"]  # (count, ms) per kernel name

``jax.profiler.trace`` writes an XSpace protobuf; ``ProfileData`` reads it
with nothing but JAX. On a GPU each ``/device:GPU:N`` plane holds one line
per CUDA stream (``Stream #...``) whose events are the kernels and copies
that ran on it, named after the kernel (a Pallas kernel by its ``name``, an
XLA fusion by its HLO name). Those events are what the report sums; a
backend without device planes (the CPU) yields an empty report.
"""

from __future__ import annotations

import glob
import os
import re
import shutil
import tempfile
from dataclasses import dataclass, field


@dataclass
class DeviceOpReport:
    """Per-kernel device time of one traced region.

    ``ops``/``total_ms`` SUM over every device plane in the trace (one per
    card on a multi-card run — divide by len(devices) for a per-card
    average); ``devices`` lists the planes that contributed."""

    devices: list[str] = field(default_factory=list)
    ops: dict[str, tuple[int, float]] = field(default_factory=dict)

    @property
    def device(self) -> str:
        return ", ".join(self.devices)

    @property
    def total_ms(self) -> float:
        return float(sum(t for _, t in self.ops.values()))

    def top(self, n: int) -> list[tuple[str, int, float]]:
        """The n kernels with the most device time: (name, count, ms)."""
        ranked = sorted(self.ops.items(), key=lambda kv: -kv[1][1])
        return [(k, c, t) for k, (c, t) in ranked[:n]]

    def __str__(self) -> str:
        lines = [
            f"{len(self.devices)} device plane(s) [{self.device}]: "
            f"{self.total_ms:.3f} ms busy (summed)"
        ]
        for k, n, t in self.top(len(self.ops)):
            lines.append(f"  {t:9.3f} ms x{n:5d}  {k}")
        return "\n".join(lines)


def _kind(name: str) -> str:
    """Kernel kind: the name without its HLO numbering (``%fusion.7 = ...``
    and ``fusion.7`` both count as ``fusion``)."""
    return re.sub(r"%|\.\d+| =.*", "", name).strip() or name


def report_from_profile(profile) -> DeviceOpReport:
    """Aggregate the kernel events of every device plane of a
    ``jax.profiler.ProfileData``."""
    rep = DeviceOpReport()
    for plane in profile.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            if plane.name not in rep.devices:
                rep.devices.append(plane.name)
            for ev in line.events:
                kind = _kind(ev.name)
                n, t = rep.ops.get(kind, (0, 0.0))
                rep.ops[kind] = (n + 1, t + ev.duration_ns / 1e6)
    return rep


def parse_xplane(path: str) -> DeviceOpReport:
    """Aggregate per-kernel device durations from one ``.xplane.pb`` file."""
    from jax.profiler import ProfileData

    return report_from_profile(ProfileData.from_file(path))


def profile_device_ops(fn, trace_dir: str | None = None) -> DeviceOpReport:
    """Run ``fn()`` under jax.profiler.trace and return per-kernel device
    times. ``fn`` must wait for its own results (``block_until_ready`` or a
    host fetch). With ``trace_dir`` the raw trace is kept; otherwise a
    temporary directory is used and removed."""
    import jax

    own = trace_dir is None
    d = tempfile.mkdtemp(prefix="nns_prof_") if own else trace_dir
    try:
        with jax.profiler.trace(d):
            fn()
        pbs = sorted(glob.glob(os.path.join(d, "plugins/profile/*/*.xplane.pb")))
        if not pbs:  # pragma: no cover - backend without xplane support
            return DeviceOpReport()
        return parse_xplane(pbs[-1])
    finally:
        if own:
            shutil.rmtree(d, ignore_errors=True)
