"""Device timing of the port's programs.

Mirrors `tpucenterface/bench/timing.py` (`op_time_ms`, `chain_op_time_ms`,
`dep_op_time_ms`, `throughput_images_per_sec`, `fifo_ips`,
`fifo_ips_passes`, `median_spread`). The device is that of the caller's
tensors, never what the machine has: nothing falls back to the CPU.

- On a CUDA device the slope functions launch the op k times back to back
  between two CUDA events, for each k of `k_pair`, best of `reps`, and
  return (t_hi - t_lo) / (hi - lo): the fixed cost of the events, the first
  launch and the host's wait drop out, and what is left is the time a call
  adds to a stream that is kept busy. Where a call's host time exceeds its
  device time (small batches, many small kernels) the slope is the host's
  rate of issuing calls, which is what a caller of the op sees.
- The FIFO functions enqueue `iters` calls and wait once, on the stream of
  the last result: the stream runs its work in order, so that wait bounds
  every call before it.
- On the CPU the same functions time with `time.perf_counter`; the CPU runs
  each op to its end before it returns.

Eager PyTorch computes every call it is given, so no call needs the
perturbed inputs, carried scalars or barriers that keep the JAX loops from
being folded away: `op_time_ms` and `dep_op_time_ms` time the op as it is
(its output written on every call), `chain_op_time_ms` feeds each output
into the next call.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Sequence

import torch


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "shards"):  # runtime.sharding.ShardedTensor
        yield from tree.shards


def _device_of(tree) -> torch.device:
    """The device of the first tensor in `tree` (tensors, dicts, lists,
    tuples, ShardedTensors); raises when it holds none."""
    for t in _tensors(tree):
        return t.device
    raise ValueError("timing needs the op's tensor arguments, to know which device to time on")


def wait(tree) -> None:
    """Wait until the work that produced the tensors of `tree` has run: on a
    CUDA device, the current stream of each tensor's device; on the CPU the
    work ran already."""
    for dev in {t.device for t in _tensors(tree)}:
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()


def _loop_ms(run: Callable[[], None], dev: torch.device, reps: int) -> float:
    """Best of `reps` wall times of `run()` in ms, between CUDA events on a
    CUDA device, by the host's clock on the CPU."""
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
            run()
            end.record(stream)
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            run()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def _slope_ms(make_run, dev: torch.device, k_pair: Sequence[int], reps: int) -> float:
    lo, hi = k_pair
    t_lo = _loop_ms(make_run(lo), dev, reps)
    t_hi = _loop_ms(make_run(hi), dev, reps)
    return max((t_hi - t_lo) / (hi - lo), 0.0)


def op_time_ms(op: Callable, *args, k_pair: Sequence[int] = (4, 20), reps: int = 3) -> float:
    """Per-call time (ms) of `op(*args)` on the device of its tensors, by
    the slope over k_pair calls back to back (module docstring)."""
    dev = _device_of(args)
    wait(op(*args))  # warm: build, plan, allocate

    def make_run(k):
        def run():
            for _ in range(k):
                op(*args)
        return run

    return _slope_ms(make_run, dev, k_pair, reps)


def chain_op_time_ms(op: Callable, x, k_pair: Sequence[int] = (4, 16), reps: int = 3) -> float:
    """Per-call time (ms) of a same-shape `op(x) -> y`, each call's output
    the next call's input, by the slope over k_pair calls."""
    dev = _device_of(x)
    wait(op(x))

    def make_run(k):
        def run():
            y = x
            for _ in range(k):
                y = op(y)
        return run

    return _slope_ms(make_run, dev, k_pair, reps)


def dep_op_time_ms(op: Callable, x, k_pair: Sequence[int] = (3, 9), reps: int = 3) -> float:
    """Per-call time (ms) of `op(x)` whose output differs in shape from its
    input, each call writing its whole output, by the slope over k_pair
    calls. In eager PyTorch every call materializes its output, so this is
    `op_time_ms` at the JAX function's loop counts."""
    return op_time_ms(op, x, k_pair=k_pair, reps=reps)


def throughput_images_per_sec(fn: Callable, args, batch: int, iters: int = 30) -> float:
    """Pipeline throughput: enqueue `iters` calls of `fn(*args)`, wait on the
    last result, `batch * iters` over the wall time (one warm call first)."""
    _device_of(args)
    wait(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    wait(out)
    return batch * iters / (time.perf_counter() - t0)


def fifo_ips(fn, im, hw, batch: int, iters: int, warm: bool = True) -> float:
    """FIFO-bounded images/s of a `(images, hws) -> (boxes, scores, ...)`
    program: optionally warm, enqueue `iters` launches, then wait on the
    last result's stream, which bounds every launch before it. The serving
    rate measurement of `cli/bench_suite.py` and `bench/preset_sweep.py`."""
    _device_of((im, hw))
    if warm:
        wait(fn(im, hw))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(im, hw)
    wait(out[1])
    return batch * iters / (time.perf_counter() - t0)


def fifo_ips_passes(fn, im, hw, batch: int, iters: int, passes: int):
    """Warm once, then `passes` independent `fifo_ips` measurements (for the
    median and [min, max] that `median_spread` reports)."""
    wait(fn(im, hw))
    return [fifo_ips(fn, im, hw, batch, iters, warm=False) for _ in range(passes)]


def median_spread(vals, ndigits: int = 1):
    """(median, [min, max]) of a fifo_ips_passes result, rounded: the
    reporting form every benchmark prints."""
    return (
        round(statistics.median(vals), ndigits),
        [round(min(vals), ndigits), round(max(vals), ndigits)],
    )
