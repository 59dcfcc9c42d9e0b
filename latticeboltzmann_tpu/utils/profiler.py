"""Profiling hooks — the counterpart of the reference's self-timing
(GetWallTime, src/latticeboltzmann.c:643-648) and its externally-traced
MPI timelines (img/comms-*.png): jax.profiler traces viewable in
TensorBoard/Perfetto, plus a simple step timer.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace of the enclosed block:

        with profiler.trace('/tmp/lbm-trace'):
            sim.run(1000)
    """
    with jax.profiler.trace(log_dir):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a trace (shows as a span in the timeline)."""
    with jax.profiler.TraceAnnotation(name):
        yield


class StepTimer:
    """Wall-clock step timing with monotonic clock — GetWallTime's role."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.laps: list[float] = []

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - (self.t0 + sum(self.laps))
        self.laps.append(dt)
        return dt

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0
