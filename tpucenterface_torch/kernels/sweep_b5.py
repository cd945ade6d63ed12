"""Time B5 (`csrc/int8_conv.cu`) under every launch plan the planner weighs,
at the default model's 1x1 projects on a 640 input at batch 32 (and block
0's at batch 128, the JAX probe's default batch), planar, on one CUDA card:

    python3 -m tpucenterface_torch.kernels.sweep_b5
    python3 -m tpucenterface_torch.kernels.sweep_b5 --against DIR

It first prints the registers and local memory a thread of each compiled
variant holds, beside the planner's table (`ops.int8_conv.VARIANT_REGS`).
Then for each shape (random operands from a seed) it runs every plan of
`int8_conv_plans` through `launch_int8_conv1x1`, holds each result to
`conv1x1_int8_plain` bit for bit, and prints one JSON line a shape: the
planner's plan and its time, the fastest plans with theirs (device
milliseconds a launch, launches back to back between CUDA events), the
bound, the time of a device copy of the same traffic (half the bytes read,
half written: the rate a stream reaches on this card), the plain version's
time and the library route's (`torch._int_mm` on the NHWC operands and the
epilogue's elementwise passes, as the quantized engine computes a conv).
`plan_int8_conv1x1`'s cost model is checked against these lines.

With `--against DIR` (a checkout of another commit, e.g. the parent's) it
first times `int8_conv1x1` of DIR's package and of this one at the same
shapes, each in its own process, in turns (DIR, this, this, DIR), and prints
one JSON line for each run: one call between CUDA events (host time
included) and the device time a call as above; then each shape's medians.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

from tpucenterface_torch.ops import int8_conv as ic

# (B, Cin, P, Cout) of the default model's projects at a 640 input: block
# 0's (32 -> 16 at 320x320), blocks 1, 2 (160x160), 3 (80x80), 6 (40x40),
# 13 and 16 (20x20); block 0's again at batch 128
SHAPES = ((32, 32, 320 * 320, 16), (32, 96, 160 * 160, 24), (32, 144, 160 * 160, 24), (32, 144, 80 * 80, 32),
          (32, 192, 40 * 40, 64), (32, 576, 20 * 20, 160), (32, 960, 20 * 20, 320), (128, 32, 320 * 320, 16))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HBM_BYTES_PER_S, INT8_OPS_PER_S = 3.35e12, 1979e12


def _inputs(seed, b, cin, p, cout):
    """x, w, scale (Cout,), bias (Cout,) on the card: random int8 operands,
    scales that keep most sums off the clip."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(-127, 128, (b, cin, p), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (cout, cin), generator=gen, dtype=torch.int8)
    scale = torch.rand(cout, generator=gen) * 4.0 / (127 * 127 * cin ** 0.5)
    bias = torch.rand(cout, generator=gen) * 4 - 2
    return x.cuda(), w.cuda(), scale.cuda(), bias.cuda()


def bound_ms(b, cin, p, cout):
    """(least ms, what bounds it): x and out once, w, scale and bias once,
    against 2 B P Cin Cout int8 operations."""
    nbytes = b * p * (cin + cout) + cout * cin + 8 * cout
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 2 * b * p * cin * cout / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _ms_a_launch(fn, launches=20, runs=5):
    """Device milliseconds a launch: the median over `runs` of CUDA events
    around `launches` launches back to back, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def _one_call_ms(fn, iters=30):
    """Milliseconds of one call between two CUDA events (the median of
    `iters`), after warm-up: the wrapper's host time and the kernel's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def library_route(x_nhwc, w_t, scale, bias):
    """The quantized engine's way to this conv: `torch._int_mm` on the NHWC
    operands (`quant.int8_ops._mm`), then the epilogue's elementwise passes."""
    acc = ic._mm(x_nhwc.reshape(-1, x_nhwc.shape[-1]), w_t)
    return torch.round(acc.float() * scale + bias).clamp_(-127, 127).to(torch.int8)


def variant_registers():
    """{variant: [[regs, local bytes] magic, [..] cvt, table's (magic, cvt)]}
    for every compiled variant."""
    out = {}
    for v in ic.VARIANTS:
        out[str(v)] = [list(ic.variant_attributes(v, True)), list(ic.variant_attributes(v, False)),
                       list(ic.VARIANT_REGS[v])]
    return out


def sweep_shape(seed, b, cin, p, cout, top=6):
    """{"shape", "planner": [plan, ms, describe], "fastest": [[plan, ms], ...],
    "all", "bound_ms", "bound_by", "copy_ms" (a device-to-device copy of the
    same bytes), "plain_ms", "library_ms"} for one shape."""
    x, w, scale, bias = _inputs(seed, b, cin, p, cout)
    want = ic.conv1x1_int8_plain(x, w, scale, bias)
    out = torch.empty_like(want)
    times = {}
    for plan in ic.int8_conv_plans(b, cin, p, cout):
        out.fill_(0)
        ic.launch_int8_conv1x1(x, w, scale, bias, plan, out)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"B5 differs from its plain version at {(b, cin, p, cout)}, plan "
                                 f"{plan.describe()}: {(out != want).sum().item()} values")
        times[plan.key] = _ms_a_launch(lambda plan=plan: ic.launch_int8_conv1x1(x, w, scale, bias, plan, out))
    chosen = ic.plan_int8_conv1x1(b, cin, p, cout)
    fastest = sorted(times.items(), key=lambda kv: kv[1])[:top]
    x_nhwc, w_t = x.permute(0, 2, 1).contiguous(), w.t()
    bms, by = bound_ms(b, cin, p, cout)
    # the card's copy rate at the same traffic: half the bytes read, half written
    src = torch.empty(b * p * (cin + cout) // 2, dtype=torch.int8, device="cuda")
    dst = torch.empty_like(src)
    return {"shape": [b, cin, p, cout], "planner": [list(chosen.key), times[chosen.key], chosen.describe()],
            "fastest": [[list(k), v] for k, v in fastest], "all": [[list(k), v] for k, v in times.items()],
            "bound_ms": bms, "bound_by": by, "copy_ms": _ms_a_launch(lambda: dst.copy_(src)),
            "plain_ms": _ms_a_launch(lambda: ic.conv1x1_int8_plain(x, w, scale, bias), launches=3, runs=3),
            "library_ms": _ms_a_launch(lambda: library_route(x_nhwc, w_t, scale, bias), launches=5, runs=3)}


def wrapper_times():
    """`int8_conv1x1` of the imported package at every shape: one call, and
    the device time a call."""
    out = []
    for seed, shape in enumerate(SHAPES):
        x, w, scale, bias = _inputs(seed, *shape)

        def call():
            return ic.int8_conv1x1(x, w, scale, bias)

        if not torch.equal(call(), ic.conv1x1_int8_plain(x, w, scale, bias)):
            raise AssertionError(f"int8_conv1x1 differs from its plain version at {shape}")
        out.append({"shape": list(shape), "one_call_ms": _one_call_ms(call), "device_ms": _ms_a_launch(call)})
    return out


def against(other: str):
    """`wrapper_times` of `other`'s package and of this one, each in its own
    process (this file run as a script, the package from the checkout's
    root), in turns; then each shape's medians and the ratio other / this."""
    runs = []
    for name, root in (("against", other), ("this", ROOT), ("this", ROOT), ("against", other)):
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--wrapper-times"], cwd=root,
                           capture_output=True, text=True, env={**os.environ, "PYTHONPATH": root})
        if r.returncode != 0:
            raise RuntimeError(f"timing the wrapper of {root} failed:\n{r.stdout}{r.stderr}")
        times = json.loads(r.stdout.strip().splitlines()[-1])
        runs.append((name, times))
        print(json.dumps({"wrapper": name, "root": root, "times": times}), flush=True)
    summary = []
    for i, shape in enumerate(SHAPES):
        med = {f"{name}_{k}": float(np.median([t[i][k] for n, t in runs if n == name]))
               for name in ("against", "this") for k in ("device_ms", "one_call_ms")}
        summary.append({"shape": list(shape), **med, "speedup": med["against_device_ms"] / med["this_device_ms"]})
    print(json.dumps({"summary": summary}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", help="a checkout of another commit whose int8_conv1x1 to time in turns")
    parser.add_argument("--wrapper-times", action="store_true", help="print wrapper_times() of the imported package")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_b5 needs a CUDA card")
    if opts.wrapper_times:
        print(json.dumps(wrapper_times()), flush=True)
        return 0
    print(json.dumps({"card": torch.cuda.get_device_name(0), "variant_registers": variant_registers()}), flush=True)
    if opts.against:
        against(os.path.abspath(opts.against))
    for seed, shape in enumerate(SHAPES):
        print(json.dumps(sweep_shape(seed, *shape)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
