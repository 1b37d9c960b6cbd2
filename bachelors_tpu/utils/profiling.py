"""Profiling and tracing hooks.

The analog of the reference's timing machinery (CUDA-event timers
`simulation.cu:708-729`, wall-clock reports `main.cpp:560-564`) built on
``jax.profiler``: capture XLA device traces viewable in Perfetto/TensorBoard,
plus lightweight named step timers for always-on production telemetry.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import jax

from .logging import get_logger

log = get_logger("profile")


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """Capture a jax.profiler trace (TensorBoard/Perfetto) around a block."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        log.okay(f"trace written to {logdir}")


def annotate(name: str):
    """Named region that shows up in device traces."""
    return jax.profiler.TraceAnnotation(name)


class StepTimer:
    """Accumulating wall-clock timer keyed by phase name.

    Synchronizes on provided arrays so device work is attributed to the
    right phase (the role of cudaEventSynchronize in the reference timer).
    """

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                jax.block_until_ready(sync_on)
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.count[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.total, key=self.total.get, reverse=True):
            t = self.total[name]
            n = self.count[name]
            lines.append(f"{name:24s} {t:9.3f}s total  {t / max(n, 1) * 1e3:9.3f}ms avg  x{n}")
        return "\n".join(lines)

    def log_report(self):
        for line in self.report().splitlines():
            log.info(line)
