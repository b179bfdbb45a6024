"""Timing / tracing helpers — the observability layer.

The reference's profiling story is criterion benches + wall-clock prints
(SURVEY.md §5); here the same wall-clock harness is a context manager, plus an
optional ``jax.profiler`` trace wrapper producing TensorBoard-compatible
device profiles.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional


class Timer:
    """Accumulating named wall-clock timer.

    >>> t = Timer()
    >>> with t("encode"): ...
    >>> t.report()
    """

    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def total(self, name: str) -> float:
        return sum(self.times.get(name, []))

    def report(self) -> str:
        lines = []
        for name, vals in self.times.items():
            lines.append(
                f"{name}: total={sum(vals):.4f}s n={len(vals)} "
                f"avg={sum(vals) / len(vals):.4f}s"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """jax.profiler trace scope; no-op when log_dir is None."""
    if not log_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median seconds per call, steady-state: each call ends in
    ``jax.block_until_ready``, so the time covers the device work and not
    only its enqueue. ``warmup`` untimed calls first (compilation)."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
