"""Timing utilities (reference analog: utils.h getTime ns timer, utils.h:9-13,
and the pre-main GPU warm-up object, core.cu:1900-1933).

Dispatch is async: a jitted call returns before the device finishes.
Every timed region therefore ends with ``jax.block_until_ready`` — the
equivalent of the implicit sync the reference gets from its blocking
cudaMemcpy D2H at the end of each cudaCall.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import jax


def now_ns() -> int:
    """Nanosecond wall clock (utils.h:9-13 analog)."""
    return time.perf_counter_ns()


class Timer:
    """Context manager measuring wall time in ms, blocking on a result."""

    def __init__(self) -> None:
        self.ms: float = 0.0
        self._result: Any = None

    def __enter__(self) -> "Timer":
        self._start = now_ns()
        return self

    def set_result(self, result: Any) -> Any:
        self._result = result
        return result

    def __exit__(self, *exc: object) -> None:
        if self._result is not None:
            jax.block_until_ready(self._result)
        self.ms = (now_ns() - self._start) / 1e6


def warmup(fn: Callable[..., Any], *args: Any, iters: int = 2) -> None:
    """Run ``fn`` a few times, blocking, so timed runs exclude compile cost.

    Reference analog: `static WarmUP warm_up(1, 1, 1<<15)` runs v9 ten times
    before main() to exclude CUDA context/JIT cost (core.cu:1900-1933). Here
    the analogous one-time cost is XLA compilation; one blocked call pays
    it, a couple more settle caches.
    """
    for _ in range(max(1, iters)):
        jax.block_until_ready(fn(*args))


def time_callable(
    fn: Callable[..., Any], *args: Any, iters: int = 3, warmup_iters: int = 2
) -> tuple[float, Any]:
    """Return (best_ms, last_result) over ``iters`` timed runs after warm-up."""
    warmup(fn, *args, iters=warmup_iters)
    best = float("inf")
    result = None
    for _ in range(max(1, iters)):
        start = now_ns()
        result = fn(*args)
        jax.block_until_ready(result)
        best = min(best, (now_ns() - start) / 1e6)
    return best, result
