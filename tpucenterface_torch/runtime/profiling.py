"""Profiling and observability.

Mirrors `tpucenterface/runtime/profiling.py` (`trace`, `annotate`) over
`torch.profiler`, and adds `counts_work`: the kernel wrappers' work ranges
that `bench.op_profile` reads.

Two kinds of named range, told apart by their separator:
- spans, `tcf.<layer>` (`annotate`): the layer boundaries of the entry
  points, `tcf.stage`, `tcf.preprocess`, `tcf.forward`, `tcf.decode`,
  `tcf.results` and `tcf.build` in `detector.py`, `tcf.tta.pad`,
  `tcf.tta.assemble` and `tcf.tta.merge` in `eval/batch_runner.py`. Names
  are fixed (no shape or id in them) so that a trace groups them, and none
  sits inside a per-image or per-block loop;
- work ranges, `tcf::<kernel> flops=<n> bytes=<n>` (`counts_work`), one a
  kernel wrapper's call.

Both check first whether a profiler records, and cost ~1 us when none does.

Usage:
    from tpucenterface_torch.runtime.profiling import annotate, trace
    with trace("runs/profile"):        # a Chrome trace (chrome://tracing, Perfetto)
        det.detect_batch(imgs)

    with annotate("tcf.decode"):       # a named region in the trace
        ...
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Callable, Iterator, Tuple

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


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """A named region of the profiler's timeline (a `tcf.<layer>` span, see
    the module doc) while torch.profiler records; else a null context, so
    that a span on the hot path costs one check (an unchecked
    `record_function` costs ~10x as much with no profiler running)."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


# The name of a kernel wrapper's work range: `tcf::<kernel> flops=<n> bytes=<n>`.
WORK_RANGE_PREFIX = "tcf::"


def counts_work(name: str, work: Callable[..., Tuple[int, int]]):
    """Decorator of a kernel wrapper: while torch.profiler records, each call
    runs inside a range named `tcf::<name> flops=<n> bytes=<n>`, where
    `work(*args, **kwargs)` gives the operations the call computes and the
    bytes it must move (each input read once, each output written once), read
    off the arguments' shapes. The profiler counts no work for a kernel
    launched through ctypes, so `bench.op_profile` credits the range's device
    time and this work to one row, whatever runs inside (the kernel on a card,
    the plain version on the CPU). Without a profiler the call goes straight
    through."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not torch.autograd._profiler_enabled():
                return fn(*args, **kwargs)
            flops, nbytes = work(*args, **kwargs)
            with torch.profiler.record_function(f"{WORK_RANGE_PREFIX}{name} flops={int(flops)} bytes={int(nbytes)}"):
                return fn(*args, **kwargs)

        return run

    return wrap
