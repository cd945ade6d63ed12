"""Per-op device-time profile of a detect program.

Mirrors `tpucenterface/bench/op_profile.py` (`capture_trace`,
`op_profile_table`, `profile_detect_program`, `main`): trace N calls of a
program with torch.profiler and reduce the Chrome trace to per-op rows
{category, name, ms_per_iter, gbytes_per_iter, gflops_per_iter,
occurrences}, sorted by time, which `bench.roofline` turns into whole-program
and per-section numbers.

Rows. On a card (a trace with device events) a row is a device kernel, copy
or memset by name, its time the device's; a row of the port's own kernels is
a kernel wrapper's work range (`runtime.profiling.counts_work`: every device
event launched inside it, e.g. B2's two kernels, is one row `tcf::decode`).
On the CPU a row is a top-level operator or work range, its time the host's.

Work is counted from what an op computes, read off its shapes, never from
which kernel computed it, so that two implementations of one model read the
same GFLOP and a later `mfu` moves with time, not with the count:
- a convolution: 2 x its multiply-adds; a matrix product: 2 M N K; an
  einsum: its matrix products';
- a port kernel: the operations and bytes of its work range, the same that
  the kernel table's bound counts;
- bytes: the inputs read once and the output written once; where the trace
  does not give an output's shape, it is taken as the largest input
  (elementwise), as the inputs' sum (cat) or as nothing (reductions, sorts,
  views); a tensor list's elements as float32; a copy or memset on the card
  its own bytes (both ends of a device-to-device copy);
- every other operator computes no FLOP: elementwise work is bound by its
  bytes.
An operator's work is credited once, to the longest of the device events it
launched. Attribution follows each device event to the host call that
launched it (its correlation id, else its External id) and up the host's
call stack to the innermost work range or, outside one, the outermost
operator.

CLI:  python -m tpucenterface_torch.bench.op_profile --batch 128 --int8-dw --k 100
"""

from __future__ import annotations

import ast
import json
import os
import re
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpucenterface_torch.bench.timing import _device_of, wait
from tpucenterface_torch.runtime.profiling import WORK_RANGE_PREFIX

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_RANGE = re.compile(re.escape(WORK_RANGE_PREFIX) + r"(\S+) flops=(\d+) bytes=(\d+)$")

# the port's kernels: work range -> category, and the device kernels' names
# (a kernel found outside its range keeps its category, with no work)
KERNEL_CATEGORY = {
    "mbconv": "conv", "planar_block": "conv", "planar_chain": "conv", "int8_conv1x1": "conv",
    "int8_block_s2": "conv", "int8_block_s1": "conv", "decode": "decode", "sigmoid_nms": "decode",
}
_PORT_KERNELS = re.compile(r"\b(mbconv_kernel|planar_chain_all|planar_chain_split|planar_block_stream|"
                           r"conv1x1_int8_kernel|int8_block_s[12]_kernel)\b")
_PORT_DECODE_KERNELS = re.compile(r"\b(band_kernel|merge_kernel|nms_kernel)\b")

# element bytes of the trace's type names, and of torch's dtype codes (`to`'s argument)
_ESIZE = {"float": 4, "double": 8, "c10::BFloat16": 2, "c10::Half": 2, "signed char": 1, "unsigned char": 1,
          "bool": 1, "short int": 2, "int": 4, "long int": 8}
_ESIZE_CODE = {0: 1, 1: 1, 2: 2, 3: 4, 4: 8, 5: 2, 6: 4, 7: 8, 11: 1, 15: 2}

# the convolutions and products the port calls (`F.conv2d`, `torch.matmul`,
# `torch.bmm`, `torch._int_mm`): the outermost operator of each call
_CONVS = ("aten::conv2d", "aten::convolution")  # arguments 3-5: stride, padding, dilation
_MATMULS = ("aten::mm", "aten::_int_mm", "aten::bmm", "aten::matmul")
_FROM_CHILDREN = ("aten::einsum",)
_COPIES = ("aten::copy_", "aten::to", "aten::_to_copy", "aten::contiguous", "aten::clone")
_OP_CATEGORY = {
    **{op: "convolution" for op in _CONVS}, **{op: "matmul" for op in _MATMULS + _FROM_CHILDREN},
    **{op: "copy" for op in _COPIES},
    "aten::topk": "sort", "aten::sort": "sort", "aten::argsort": "sort",
    "aten::index": "index", "aten::gather": "index", "aten::index_select": "index",
    "aten::take_along_dim": "index", "aten::scatter": "index",
    "aten::cat": "cat", "aten::stack": "cat",
    "aten::upsample_nearest2d": "upsample", "aten::upsample_bilinear2d": "upsample",
    "aten::max_pool2d": "pool", "aten::max_pool2d_with_indices": "pool",
    **{f"aten::{op}": "reduce" for op in ("sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
                                          "all", "any", "prod", "norm")},
}
_NO_OUTPUT = ("reduce", "sort", "index")
_TENSOR_CATEGORIES = ("convolution", "matmul")
_VIEWS = {f"aten::{op}" for op in (
    "view", "reshape", "_reshape_alias", "permute", "transpose", "t", "expand", "slice", "select", "unsqueeze",
    "squeeze", "as_strided", "flatten", "unflatten", "narrow", "unbind", "split", "chunk", "alias", "detach",
    "empty", "empty_like", "empty_strided", "resolve_conj", "resolve_neg", "lift_fresh", "view_as")}


# The range around capture_trace's warm-up call: the reducer drops every
# event that starts before it ends.
WARM_UP_RANGE = "op_profile::warm-up"


def capture_trace(fn, args, logdir: str, iters: int = 3) -> List[str]:
    """Run fn(*args) once to warm, then under torch.profiler (with CUDA
    activity where the tensors are on a card, and the operators' shapes)
    once more inside WARM_UP_RANGE, waited for, and `iters` times; return the
    paths of the Chrome traces written into `logdir`. The recorded warm-up
    call takes the start of the profile, where device events can be lost
    (seen on an H100: a program's first kernels, in one run of three), and
    `op_profile_table` leaves it out."""
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = _device_of(args)
    wait(fn(*args))
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=activities, record_shapes=True) as prof:
        with record_function(WARM_UP_RANGE):
            wait(fn(*args))
        for _ in range(iters):
            out = fn(*args)
        wait(out)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return [path]


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


def op_category(name: str) -> str:
    """The category of a host operator, from its name."""
    if name.startswith("aten::") and name not in _VIEWS:
        return _OP_CATEGORY.get(name, "elementwise")
    return "other"


def _concrete(args: dict, i: int):
    vals = args.get("Concrete Inputs") or []
    if i >= len(vals) or vals[i] == "":
        return None
    try:
        return ast.literal_eval(vals[i])
    except (ValueError, SyntaxError):
        return vals[i]


def _pair(v, n: int):
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


def _tensors_of(args: dict) -> List[Tuple[int, int]]:
    """(elements, bytes an element) of each tensor input of an operator."""
    out = []
    for dims, typ in zip(args.get("Input Dims") or [], args.get("Input type") or []):
        if typ == "TensorList":
            out += [(int(np.prod(d)), 4) for d in dims]
        elif typ in _ESIZE:
            out.append((int(np.prod(dims)) if dims else 1, _ESIZE[typ]))
    return out


def _conv_work(args: dict) -> Tuple[int, int]:
    dims, types = args["Input Dims"], args["Input type"]
    x, w = list(dims[0]), list(dims[1])
    if len(x) == len(w) - 1:  # unbatched
        x = [1] + x
    nsp = len(w) - 2
    stride = _pair(_concrete(args, 3) or 1, nsp)
    pad = _concrete(args, 4)
    dil = _pair(_concrete(args, 5) or 1, nsp)
    out_sp = []
    for i in range(nsp):
        size, k = x[2 + i], w[2 + i]
        if pad == "same":
            out_sp.append(size)
            continue
        p = 0 if pad in (None, "valid") else _pair(pad, nsp)[i]
        out_sp.append((size + 2 * p - dil[i] * (k - 1) - 1) // stride[i] + 1)
    out = x[0] * w[0] * int(np.prod(out_sp))
    flops = 2 * out * w[1] * int(np.prod(w[2:]))
    esize = _ESIZE.get(types[0], 4)
    return flops, sum(n * e for n, e in _tensors_of(args)) + out * esize


def _matmul_work(name: str, args: dict) -> Tuple[int, int]:
    dims, types = args["Input Dims"], args["Input type"]
    a, b = list(dims[0]), list(dims[1])
    a = [1] + a if len(a) == 1 else a
    b = b + [1] if len(b) == 1 else b
    batch = int(np.prod(np.broadcast_shapes(tuple(a[:-2]), tuple(b[:-2]))))
    m, k, n = a[-2], a[-1], b[-1]
    esize = 4 if name == "aten::_int_mm" else _ESIZE.get(types[0], 4)
    return 2 * batch * m * n * k, sum(n_ * e for n_, e in _tensors_of(args)) + batch * m * n * esize


def op_work(name: str, args: dict) -> Tuple[int, int]:
    """(FLOP, bytes) of one host operator from its recorded shapes (module
    docstring); (0, 0) where the trace holds no shapes."""
    if "Input Dims" not in args or name in _VIEWS:
        return 0, 0
    if name in _CONVS:
        return _conv_work(args)
    if name in _MATMULS:
        return _matmul_work(name, args)
    ins = _tensors_of(args)
    in_bytes = sum(n * e for n, e in ins)
    cat = op_category(name)
    if cat in _NO_OUTPUT or name == "aten::copy_":
        return 0, in_bytes
    if cat == "cat":
        return 0, 2 * in_bytes
    if name in ("aten::to", "aten::_to_copy") and ins:
        code = _concrete(args, 1)
        return 0, in_bytes + ins[0][0] * _ESIZE_CODE.get(code, ins[0][1])
    return 0, in_bytes + max((n * e for n, e in ins), default=0)


def _forest(events: List[dict]) -> Dict[int, Optional[int]]:
    """Parent (innermost enclosing event of the same thread) of each host
    event, by index into `events`; a thread's events nest."""
    parent: Dict[int, Optional[int]] = {}
    by_thread = defaultdict(list)
    for i, e in enumerate(events):
        by_thread[(e.get("pid"), e.get("tid"))].append(i)
    for idx in by_thread.values():
        idx.sort(key=lambda i: (events[i]["ts"], -events[i].get("dur", 0)))
        stack: List[int] = []
        for i in idx:
            t = events[i]["ts"]
            while stack and events[stack[-1]]["ts"] + events[stack[-1]].get("dur", 0) < t:
                stack.pop()
            parent[i] = stack[-1] if stack else None
            stack.append(i)
    return parent


class _Rows:
    def __init__(self):
        self.rows: Dict[Tuple[str, str], dict] = defaultdict(lambda: {"us": 0.0, "flops": 0, "bytes": 0, "n": 0})

    def add(self, key, us: float, flops: int = 0, nbytes: int = 0, n: int = 1):
        r = self.rows[key]
        r["us"] += us
        r["flops"] += flops
        r["bytes"] += nbytes
        r["n"] += n


def _range_work(name: str):
    m = _RANGE.match(name)
    return (m.group(1), int(m.group(2)), int(m.group(3))) if m else None


def _einsum_work(i: int, events, children) -> Tuple[int, int]:
    flops = nbytes = 0
    for c in children.get(i, ()):
        name = events[c]["name"]
        if name in _MATMULS:
            f, b = _matmul_work(name, events[c].get("args", {}))
        else:
            f, b = _einsum_work(c, events, children)
        flops, nbytes = flops + f, nbytes + b
    return flops, nbytes


def _work_of(i: int, events, children) -> Tuple[int, int]:
    name = events[i]["name"]
    if name in _FROM_CHILDREN:
        return _einsum_work(i, events, children)
    return op_work(name, events[i].get("args", {}))


class _Trace:
    """One Chrome trace's host call forest, and each device event's owners:
    the innermost work range and the outermost operator above the host call
    that launched it (its correlation id, else its External id). Events that
    start before a WARM_UP_RANGE ends are left out."""

    def __init__(self, events: List[dict]):
        warm = [e["ts"] + e.get("dur", 0.0) for e in events if e["name"] == WARM_UP_RANGE]
        events = [e for e in events if e["ts"] >= max(warm, default=float("-inf"))]
        self.host = [e for e in events if e.get("cat", "").lower() in ("cpu_op", "user_annotation") + _LAUNCH_CATS]
        self.device = [e for e in events if e.get("cat", "").lower() in _DEVICE_CATS]
        self.parent = _forest(self.host)
        self.children = defaultdict(list)
        for i, p in self.parent.items():
            if p is not None:
                self.children[p].append(i)
        self.by_corr = {e.get("args", {}).get("correlation"): i for i, e in enumerate(self.host)
                        if e.get("cat", "").lower() in _LAUNCH_CATS}
        self.by_ext = {e.get("args", {}).get("External id"): i for i, e in enumerate(self.host)
                       if e.get("cat", "").lower() in ("cpu_op", "user_annotation")}

    def is_op(self, i) -> bool:
        return self.host[i].get("cat", "").lower() == "cpu_op"

    def is_range(self, i) -> bool:
        return _range_work(self.host[i]["name"]) is not None

    def owners(self, e: dict):
        """(innermost work range, outermost operator) of device event `e`, as
        host indices or None."""
        a = e.get("args", {})
        i = self.by_corr.get(a.get("correlation"))
        if i is None:
            i = self.by_ext.get(a.get("External id"))
        rng = op = None
        while i is not None:
            if rng is None and self.is_range(i):
                rng = i
            if self.is_op(i):
                op = i
            i = self.parent[i]
        return rng, op

    def work(self, i: int) -> Tuple[int, int]:
        return _work_of(i, self.host, self.children)


def _reduce_host(tr: _Trace, rows: _Rows) -> None:
    """The CPU: a row is a top-level operator or work range, by host time."""
    for i, e in enumerate(tr.host):
        if not (tr.is_op(i) or tr.is_range(i)):
            continue
        p = tr.parent[i]
        while p is not None and not (tr.is_op(p) or tr.is_range(p)):
            p = tr.parent[p]
        if p is not None:
            continue
        rw = _range_work(e["name"])
        if rw:
            rows.add((KERNEL_CATEGORY.get(rw[0], "other"), WORK_RANGE_PREFIX + rw[0]), e.get("dur", 0.0), rw[1], rw[2])
        else:
            rows.add((op_category(e["name"]), e["name"]), e.get("dur", 0.0), *tr.work(i))


def _reduce_device(tr: _Trace, rows: _Rows) -> None:
    """A card: a row is a device event by name, or a work range."""
    ranges_done = set()
    op_kernels: Dict[int, List[Tuple[float, tuple]]] = defaultdict(list)
    for e in tr.device:
        dur = e.get("dur", 0.0)
        rng, op = tr.owners(e)
        if rng is not None:
            kname, flops, nbytes = _range_work(tr.host[rng]["name"])
            first = rng not in ranges_done
            ranges_done.add(rng)
            rows.add((KERNEL_CATEGORY.get(kname, "other"), WORK_RANGE_PREFIX + kname), dur,
                     flops if first else 0, nbytes if first else 0, int(first))
            continue
        cat = kernel_category(e["name"])
        key = (cat, e["name"])
        if cat in ("copy", "memset"):
            nbytes = int(e.get("args", {}).get("bytes", 0))
            rows.add(key, dur, 0, 2 * nbytes if "DtoD" in e["name"] else nbytes)
            continue
        rows.add(key, dur)
        if op is not None:
            op_kernels[op].append((dur, key))
    for op, kernels in op_kernels.items():
        # a conv's or a product's work goes to its longest tensor-core kernel
        # (cuDNN adds the bias in a separate elementwise kernel, which can take longer)
        if op_category(tr.host[op]["name"]) in _TENSOR_CATEGORIES:
            kernels = [k for k in kernels if k[1][0] in _TENSOR_CATEGORIES] or kernels
        _, key = max(kernels, key=lambda dk: dk[0])
        rows.add(key, 0.0, *tr.work(op), n=0)


def kernel_owners(paths: List[str]) -> Dict[str, Dict[str, int]]:
    """{device event name: {the work range or outermost operator that
    launched it: launches}} over the traces: which call of the program a
    kernel belongs to."""
    out: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
    for path in paths:
        with open(path) as f:
            tr = _Trace([e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"])
        for e in tr.device:
            rng, op = tr.owners(e)
            owner = rng if rng is not None else op
            out[e["name"]][tr.host[owner]["name"] if owner is not None else "(not found)"] += 1
    return {k: dict(v) for k, v in out.items()}


def op_profile_table(paths: List[str], iters: int = 3) -> List[dict]:
    """Chrome traces of `iters` calls -> [{category, name, ms_per_iter,
    gbytes_per_iter, gflops_per_iter, occurrences}], sorted by time (module
    docstring), unrounded, so that sums over rows keep every op's share.
    `occurrences` counts the events (a work range's calls) in all the
    traces."""
    rows = _Rows()
    for path in paths:
        with open(path) as f:
            tr = _Trace([e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"])
        (_reduce_device if tr.device else _reduce_host)(tr, rows)
    out = []
    for (cat, name), r in rows.rows.items():
        ms = r["us"] / iters / 1e3
        if ms <= 0:
            continue
        out.append({
            "category": cat,
            "name": name,
            "ms_per_iter": ms,
            "gbytes_per_iter": r["bytes"] / iters / 1e9,
            "gflops_per_iter": r["flops"] / iters / 1e9,
            "occurrences": r["n"],
        })
    out.sort(key=lambda r: -r["ms_per_iter"])
    return out


def profile_detect_program(
    batch: int = 128,
    size: int = 640,
    int8: bool = False,
    int8_dw: bool = False,
    max_dets: Optional[int] = 100,
    identity: bool = True,
    iters: int = 3,
    logdir: Optional[str] = None,
    device=None,
) -> Dict[str, object]:
    """Trace and summarize the serving detect program (`_batch_fn_auto`,
    inputs staged as a serving launch stages them) of a Detector with random
    weights from seed 0, on `device` (the card unless the caller names
    another)."""
    from tpucenterface_torch.bench.roofline import section_table, summarize_rows
    from tpucenterface_torch.config import DetectorConfig
    from tpucenterface_torch.detector import Detector, stage_inputs

    det = Detector(config=DetectorConfig(), device=device)
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 255, (batch, size, size, 3), np.uint8)
    hws = np.tile(np.array([[size, size]], np.int32), (batch, 1))
    if int8 or int8_dw:
        det.quantize(calib_images=imgs[:8], int8_dw=int8_dw)
    try:
        fn, fmt = det._batch_fn_auto(batch, (size, size), size, identity=identity, max_dets=max_dets)
        im, hw = stage_inputs(fmt, imgs, hws, det.device)
        logdir = logdir or tempfile.mkdtemp(prefix="tpucf_prof_")
        paths = capture_trace(fn, (im, hw), logdir, iters=iters)
        rows = op_profile_table(paths, iters=iters)
    finally:
        det.dequantize()
    total = sum(r["ms_per_iter"] for r in rows)
    by_cat: Dict[str, float] = {}
    for r in rows:
        by_cat[r["category"]] = by_cat.get(r["category"], 0.0) + r["ms_per_iter"]
    return {
        "total_ms": round(total, 3),
        "img_per_s": round(batch / total * 1e3, 1) if total else None,
        "roofline": summarize_rows(rows, int8=int8 or int8_dw),
        # the recorded floors attach only to the canonical serving shape
        "sections": section_table(
            rows, int8=int8 or int8_dw,
            recorded_floors=batch == 128 and size == 640 and identity and max_dets == 100,
        ),
        "by_category_ms": {k: round(v, 3) for k, v in sorted(by_cat.items(), key=lambda kv: -kv[1])},
        "top_ops": rows[:20],
    }


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Per-op device profile of the detect program")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--size", type=int, default=640)
    p.add_argument("--int8", action="store_true")
    p.add_argument("--int8-dw", action="store_true")
    p.add_argument("--k", type=int, default=100, help="decode top-K")
    p.add_argument("--letterbox", action="store_true", help="profile the resize path instead of identity")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = p.parse_args(argv)
    out = profile_detect_program(
        batch=args.batch,
        size=args.size,
        int8=args.int8,
        int8_dw=args.int8_dw,
        max_dets=args.k,
        identity=not args.letterbox,
        iters=args.iters,
        device=args.device,
    )
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
