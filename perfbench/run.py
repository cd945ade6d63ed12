"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (imports, the kernels from the build
cache inside the checkout, weights and frames made from the seed on the
card, the Detector, a warm-up of every shape the cell's traffic uses) is
timed from the start of the process as `setup_s`. Then, with `--trace 0`,
the traffic's loop (`loops/<loop>.py`) drives the cell's entry point
(`entries/<entry>.py`) for `--seconds` and the cell's end-to-end metrics are
taken by the host's clock; with `--trace 1`, the same loop sends the
traffic file's `trace_calls` calls under torch.profiler and the per-layer
metrics are read from the trace. Either way a sample of
what the timed calls returned, drawn from the seed, is then held to the
plain reference (`check.py`), after the peak of device memory has been read
and the program's state freed. The last line of standard output is one JSON
object; the numbers compared, beside their limits, are also the last lines
of standard error.

Exits with another code than 0, and prints no result, without a CUDA device
(or with fewer than the cell asks for), and where the JAX package or JAX is
loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import check, registry  # noqa: E402
from perfbench.reference.detect import Detector as Reference  # noqa: E402
from perfbench.reference.model import to_device  # noqa: E402
from perfbench.trace import WINDOW_RANGE, read_trace  # noqa: E402
from perfbench.weights import make_variables  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tpucenterface")


def forbidden_modules(names=None):
    """Top-level names of loaded modules (or of `names`) that the run must
    not hold, compared whole (`tpucenterface_torch` is not `tpucenterface`)."""
    return sorted({m.split(".")[0] for m in (list(sys.modules) if names is None else names)} & set(FORBIDDEN))


def card(device) -> dict:
    name = torch.cuda.get_device_name(device)
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i",
                                str(torch.device(device).index or 0)],
                               capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return {"platform": "gpu", "kind": name, "power_limit": limit}


class Reservoir:
    """A uniform sample of `k` of the calls seen, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.kept = k, 0, []
        self.rng = np.random.default_rng(seed)

    def offer(self, call) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(call)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.kept[j] = call


def traced(window, driver, traffic: dict, sample: Reservoir, first: int):
    """The traffic's `trace_calls` calls, sent by its loop, under
    torch.profiler (operators' input shapes recorded) inside the
    WINDOW_RANGE range, one call ahead of it, untimed, since a profile can
    lose its first device events; the trace read and its file removed."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
            driver.call(first)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            with record_function(WINDOW_RANGE):
                calls = window(driver, 0.0, sample, traffic, calls=int(traffic["trace_calls"]), first=first + 1)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        return calls, read_trace(path)


def picks(driver, call, traffic: dict, rng) -> list:
    """The frames of a sampled call that the reference checks: all, or
    `check_images` of them drawn from the seed with the largest among them."""
    n = call.images
    k = traffic.get("check_images", n)
    if k >= n:
        return list(range(n))
    frames = driver.pool[call.index]
    largest = int(np.argmax([f.shape[0] * f.shape[1] for f in frames]))
    rest = [j for j in rng.permutation(n).tolist() if j != largest][: k - 1]
    return sorted([largest] + rest)


def run(cell_name: str, seed: int, seconds: float, trace: bool, device, root=registry.ROOT) -> dict:
    """One run of a cell on `device`; the result object (see module doc)."""
    cell = registry.cell(cell_name, root)
    cfg, traffic = cell.config, cell.traffic
    arch = registry.architecture(cfg)
    variables = make_variables(cfg, seed, device)
    det = arch.program.build(cfg, variables, device)
    driver = registry.driver(traffic["entry"], root)(det, cfg, traffic, seed, device)
    window = registry.loop(traffic["loop"], root)
    driver.warmup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)  # the peak of the timed calls, whose shapes warm-up ran
    setup_s = time.perf_counter() - T0
    sample = Reservoir(int(traffic["check_calls"]), seed)
    if trace:
        calls, tr = traced(window, driver, traffic, sample, len(driver.pool))
    else:
        calls, tr = window(driver, seconds, sample, traffic), None
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    ctx = SimpleNamespace(
        calls=calls, setup_s=setup_s, trace=tr, config=cfg,
        images=sum(c.images for c in calls),
        flops=sum(driver.flops(c) for c in calls),
    )
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = registry.reader(m["name"], root)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the program's state goes before the reference runs
    kept = sample.kept
    driver.pool = {c.index: driver.pool[c.index] for c in kept}
    del det
    driver.det = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = Reference(cfg, to_device(variables, device))
    rng = np.random.default_rng(seed)
    per_frame = []
    for c in kept:
        per_frame += driver.compare(ref, c, picks(driver, c, traffic, rng), device)
    numbers = {k: check.statistic(per_frame, k) for k in cell.limits}
    result = {
        "correct": check.judge(numbers, cell.limits),
        "attempted": ctx.images,
        "failed": 0,
        "metrics": metrics,
        "check": {k: {"value": numbers[k], "limit": cell.limits[k]} for k in cell.limits},
        "checked_frames": len(per_frame),
        "check_summary": check.summary(per_frame),
        "memory_peak_bytes": memory_peak,
    }
    if tr is not None:
        result["trace"] = tr
    return result


def result_line(result: dict, device_info: dict) -> dict:
    """The contract's result object: correct, attempted, failed, metrics,
    device (with busy_s and window_s from a trace), breakdown where traced,
    and last the numbers compared beside their limits."""
    dev = dict(device_info, memory_peak_bytes=result["memory_peak_bytes"])
    line = {k: result[k] for k in ("correct", "attempted", "failed", "metrics")}
    tr = result.get("trace")
    if tr is not None:
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
    line["device"] = dev
    if tr is not None:
        line["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    line["check"] = result["check"]
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    chips = int(next(w for w in registry.load_benchmark()["workloads"] if w["name"] == args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}; the benchmark runs the port alone", file=sys.stderr)
        return 3
    line = result_line(result, dict(card(device), count=chips))
    if "trace" in result:
        print("device seconds by category: " + json.dumps(result["trace"].by_category_s()), file=sys.stderr)
    print(f"checked frames {result['checked_frames']}; host peak RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB", file=sys.stderr)
    for k, v in line["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
