"""Reading a torch.profiler Chrome trace of the traced window.

A frozen copy of the categories of device kernels that the port's
`bench/op_profile.py` (`kernel_category`) gave them when this benchmark was
written, so that a later change to the program cannot move the yardstick;
and the reduction of a trace to device time by category, the device's busy
time, its idle gaps and what the host was doing in each, and the launches
of a kernel grouped by the forward that issued them (`launches_by_forward`).
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

WINDOW_RANGE = "perfbench::window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "python_function")

_PORT_KERNELS = re.compile(r"\b(mbconv_kernel|planar_chain_all|planar_chain_split|planar_block_stream|"
                           r"conv1x1_int8_kernel|int8_block_s[12]_kernel)\b")
_PORT_DECODE_KERNELS = re.compile(r"\b(band_kernel|merge_kernel|nms_kernel)\b")
MBCONV_KERNEL = re.compile(r"\bmbconv_kernel\b")


def kernel_category(name: str) -> str:
    """The category of a device event, from its name."""
    n = name.lower()
    if n.startswith("memcpy"):
        return "copy"
    if n.startswith("memset"):
        return "memset"
    if _PORT_KERNELS.search(name):
        return "conv"
    if _PORT_DECODE_KERNELS.search(name):
        return "decode"
    if any(k in n for k in ("nchwtonhwc", "nhwctonchw", "transpose", "padding")):
        return "data formatting"
    if any(k in n for k in ("conv", "fprop", "dgrad", "wgrad", "implicit_gemm", "implicit_convolve", "winograd")):
        return "convolution"
    if any(k in n for k in ("gemm", "gemv", "nvjet", "matmul", "cublas", "cutlass")):
        return "matmul"
    if "vectorized_elementwise" in n or "unrolled_elementwise" in n:
        return "elementwise"
    if "elementwise_kernel" in n:
        return "strided elementwise"
    if "reduce_kernel" in n or "reduction" in n:
        return "reduce"
    if any(k in n for k in ("sort", "topk", "radix", "bitonic")):
        return "sort"
    if "catarray" in n:
        return "cat"
    if "upsample" in n:
        return "upsample"
    if "pool" in n:
        return "pool"
    if any(k in n for k in ("index", "gather", "scatter")):
        return "index"
    return "other"


_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


class Event(NamedTuple):
    name: str
    start: float  # microseconds
    end: float
    corr: int = -1  # a device event's correlation id, linking it to its launch on the host


class Forward(NamedTuple):
    """A forward of the network as the host issued it: from its stem (the
    one convolution that takes the 3 channels of an image) on, at its input's
    rows and size."""

    start: float
    rows: int
    height: int
    width: int


class Trace(NamedTuple):
    """The traced window [start, end] (microseconds, the host's clock as
    the profiler writes it), the device events inside it, the host's
    events (operators, ranges, Python functions) of the thread that
    opened the window, the forwards it issued, and the host's time of
    each launch by correlation id."""

    start: float
    end: float
    device: List[Event]
    host: List[Event]
    forwards: List[Forward] = []
    launched: Dict[int, float] = {}

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_s(self) -> float:
        """Seconds in which a kernel, copy or memset ran."""
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        spans = sorted((max(e.start, self.start), min(e.end, self.end)) for e in self.device)
        out: List[Tuple[float, float]] = []
        for s, e in spans:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def device_s(self, pred) -> float:
        """Seconds of the device events whose name satisfies `pred`."""
        return sum(e.end - e.start for e in self.device if pred(e.name)) / 1e6

    def by_category_s(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for e in self.device:
            out[kernel_category(e.name)] += (e.end - e.start) / 1e6
        return dict(out)

    def top_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, float] = defaultdict(float)
        for e in self.device:
            tot[e.name[:160]] += (e.end - e.start) / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The `n` longest stretches of the window with nothing on the
        device, each named by the innermost host event running at its
        middle."""
        edges = [self.start] + [t for iv in self.busy_intervals() for t in iv] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = (s + e) / 2
            inner: Optional[Event] = None
            for h in self.host:
                if h.start <= mid <= h.end and (inner is None or h.end - h.start < inner.end - inner.start):
                    inner = h
            out.append([inner.name[:160] if inner else "(no host event)", (e - s) / 1e6])
        return out


    def launches_by_forward(self, pattern) -> Optional[List[Tuple[Forward, List[Event]]]]:
        """The device events whose name `pattern` finds, grouped by the
        forward that launched them (the last forward whose stem the host
        issued before the launch), in order; None where a launch has no
        launch on the host, or no forward before it."""
        groups: Dict[int, List[Event]] = defaultdict(list)
        starts = [f.start for f in self.forwards]
        for e in self.device:
            if not pattern.search(e.name):
                continue
            t = self.launched.get(e.corr)
            k = bisect.bisect_right(starts, t) - 1 if t is not None else -1
            if k < 0:
                return None
            groups[k].append(e)
        return [(self.forwards[k], groups[k]) for k in sorted(groups)]


def _stem_input(e: dict) -> Optional[Tuple[int, int, int]]:
    """(rows, height, width) of a convolution operator's input where it has
    3 channels (an image), from the shapes the profiler recorded."""
    dims = (e.get("args") or {}).get("Input Dims") or []
    x = dims[0] if dims else None
    if "conv" in e["name"] and isinstance(x, list) and len(x) == 4 and x[1] == 3:
        return int(x[0]), int(x[2]), int(x[3])
    return None


def read_trace(path: str) -> Trace:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    windows = [e for e in events if e["name"] == WINDOW_RANGE and e.get("cat", "").lower() == "user_annotation"]
    if len(windows) != 1:
        raise ValueError(f"the trace holds {len(windows)} '{WINDOW_RANGE}' ranges, not one")
    w = windows[0]
    start, end = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    dev, host, launched, stems = [], [], {}, []
    for e in events:
        s = float(e["ts"])
        corr = int((e.get("args") or {}).get("correlation", -1))
        ev = Event(e["name"], s, s + float(e.get("dur", 0.0)), corr)
        cat = e.get("cat", "").lower()
        if cat in _DEVICE_CATS and ev.end > start and ev.start < end:
            dev.append(ev)
        elif cat in _RUNTIME_CATS and corr >= 0:
            launched[corr] = s
        elif cat in _HOST_CATS:
            shape = _stem_input(e) if cat == "cpu_op" else None
            if shape is not None:  # from whichever thread issued it
                stems.append((ev, shape))
            if e.get("tid") == w.get("tid") and e is not w:
                host.append(ev)
    # an operator's nested calls (conv2d -> convolution -> ...) are one forward
    forwards: List[Forward] = []
    last_end = float("-inf")
    for ev, shape in sorted(stems, key=lambda x: (x[0].start, -x[0].end)):
        if ev.start >= last_end:
            forwards.append(Forward(ev.start, *shape))
            last_end = ev.end
    return Trace(start, end, dev, host, forwards, launched)
