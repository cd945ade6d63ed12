"""Profiling and observability.

Mirrors `tpucenterface/runtime/profiling.py` (`trace`, `annotate`,
`StepTimer`) over `torch.profiler`.

Usage:
    from tpucenterface_torch.runtime.profiling import annotate, trace
    with trace("runs/profile"):        # a Chrome trace (chrome://tracing, Perfetto)
        det.detect_batch(imgs)

    with annotate("decode"):           # a named region in the trace
        ...
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Profile the host and, where there is one, the CUDA device while the
    block runs; on exit write a Chrome trace into `logdir` (created if need
    be) as `trace_<pid>_<ns>.json`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A named region that shows up in profiler timelines."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Lightweight host-side step timing with EMA (the reference's FPS-print
    equivalent, but structured)."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema_ms: Optional[float] = None
        self._t: Optional[float] = None

    def tic(self) -> None:
        self._t = time.perf_counter()

    def toc(self) -> float:
        dt = (time.perf_counter() - self._t) * 1e3
        self.ema_ms = dt if self.ema_ms is None else (self.alpha * dt + (1 - self.alpha) * self.ema_ms)
        return dt

    @property
    def fps(self) -> float:
        return 1000.0 / self.ema_ms if self.ema_ms else 0.0
