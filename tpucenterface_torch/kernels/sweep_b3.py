"""Time B3 (`csrc/mbconv.cu`) under every launch plan that fits, at the
default model's fused-block shapes at batch 32 (a 640 input, and the three
distinct shapes of a 320 input), on one CUDA card:

    python3 -m tpucenterface_torch.kernels.sweep_b3
    python3 -m tpucenterface_torch.kernels.sweep_b3 --against DIR

For each shape (random weights and input from a seed) it runs the planner's
plan and every plan of `ops.fused_mbconv.fused_mbconv_plans` (each tile of
MBCONV_TILES, cut to the map, with each variant of MBCONV_VARIANTS), holds
each result to `fused_mbconv_plain` under `chip_smoke.py`'s tolerance and
prints one JSON line a shape: the planner's plan and its time, and the
fastest plans with theirs (device milliseconds a launch: launches back to
back between CUDA events, so the host's time between launches is hidden, as
in a forward). `plan_fused_mbconv`'s cost model is checked against these
lines.

With `--against DIR` (a checkout of another commit, e.g. the parent's) it
first times `fused_mbconv` of DIR's package and of this one at the same
shapes, each in its own process, in turns (DIR, this, this, DIR), and prints
one JSON line for each run: one call between CUDA events (host time
included) and the device time a launch as above, on the six weights (the
call both commits take) and, where the package has it, on packed weights.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys

import numpy as np
import torch

from tpucenterface_torch.ops import fused_mbconv as fm

# (map, Cin, Ce, Cout, expand, skip) of the default model's fused blocks with
# distinct shapes at a 640 input (blocks 0, 2, 4, 7, 10, 11) and at 320
# (blocks 0, 2, 4)
SHAPES_640 = ((320, 32, 32, 16, False, False), (160, 24, 144, 24, True, True), (80, 32, 192, 32, True, True),
              (40, 64, 384, 64, True, True), (40, 64, 384, 96, True, False), (40, 96, 576, 96, True, True))
SHAPES_320 = ((160, 32, 32, 16, False, False), (80, 24, 144, 24, True, True), (40, 32, 192, 32, True, True))
BATCH = 32
# chip_smoke.py's MBCONV_ATOL, MBCONV_RTOL, MBCONV_MAX_DIFFERING
ATOL, RTOL, MAX_DIFFERING = 0.04, 2.0 ** -6, 0.01
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _inputs(gen, hw, cin, ce, cout, expand):
    """x (BATCH, hw, hw, cin) and the six weights, bf16 on the card, at the
    scales of chip_smoke.py's random blocks."""

    def rnd(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda", torch.bfloat16)

    x = rnd(BATCH, hw, hw, cin, scale=0.5)
    w1, b1 = (rnd(cin, ce, scale=0.3), rnd(ce, scale=0.1)) if expand else (None, None)
    return x, (w1, b1, rnd(3, 3, ce, scale=0.3), rnd(ce, scale=0.1), rnd(ce, cout, scale=2 * ce ** -0.5),
               rnd(cout, scale=0.1))


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


def _desc(plan: fm.MBConvPlan):
    """[tile_h, tile_w, warps, pm, pn, cout_group]"""
    return [plan.tile_h, plan.tile_w, plan.warps, plan.pm, plan.pn, plan.cout_group]


def _check(got, want, what):
    diff = (got.float() - want.float()).abs()
    over = (diff > ATOL + RTOL * want.float().abs()).sum().item()
    differing = (diff > 0).float().mean().item()
    if over or differing > MAX_DIFFERING or not torch.isfinite(got.float()).all():
        raise AssertionError(f"B3 differs from its plain version at {what}: {over} values over the tolerance, "
                             f"{differing:.2e} differing")


def sweep_shape(hw, cin, ce, cout, expand, skip, gen, top=6):
    """{"shape", "planner": [plan, ms], "fastest": [[plan, ms], ...]} for one
    block shape."""
    x, args = _inputs(gen, hw, cin, ce, cout, expand)
    packed = fm.pack_fused_mbconv(*args)
    want = fm.fused_mbconv_plain(x, *args, skip=skip)
    out = torch.empty((BATCH, hw, hw, cout), dtype=torch.bfloat16, device="cuda")
    chosen = fm.plan_fused_mbconv(BATCH, hw, hw, cin, ce, cout, expand)
    times = {}
    for plan in [chosen, *fm.fused_mbconv_plans(BATCH, hw, hw, cin, ce, cout, expand)]:
        key = tuple(_desc(plan))
        if key in times:
            continue
        call = functools.partial(fm.launch_fused_mbconv, x, packed, plan, out, skip, True)
        out.zero_()
        call()
        torch.cuda.synchronize()
        _check(out, want, f"{(BATCH, hw, hw, cin, ce, cout)}, plan {list(key)}")
        times[key] = _ms_a_launch(call)
    fastest = sorted(times.items(), key=lambda kv: kv[1])[:top]
    return {"shape": [BATCH, hw, hw, cin, ce, cout], "planner": [_desc(chosen), times[tuple(_desc(chosen))]],
            "fastest": [[list(k), v] for k, v in fastest]}


def wrapper_times():
    """`fused_mbconv` at every shape: on the six weights (a call every commit
    takes) and, where this package has them, on packed weights."""
    gen = torch.Generator().manual_seed(1)
    has_packed = hasattr(fm, "pack_fused_mbconv")
    out = []
    for hw, cin, ce, cout, expand, skip in SHAPES_640 + SHAPES_320:
        x, args = _inputs(gen, hw, cin, ce, cout, expand)
        six = functools.partial(fm.fused_mbconv, x, *args, skip=skip)
        row = {"shape": [BATCH, hw, hw, cin, ce, cout], "six_one_call_ms": _one_call_ms(six),
               "six_device_ms": _ms_a_launch(six)}
        if has_packed:
            packed = fm.pack_fused_mbconv(*args)
            one = functools.partial(fm.fused_mbconv, x, packed, skip=skip)
            row.update(one_call_ms=_one_call_ms(one), device_ms=_ms_a_launch(one))
        out.append(row)
    return out


def against(other: str):
    """`wrapper_times` of `other`'s package and of this one, each in its own
    process (this file run as a script, the package from the checkout's
    root), in turns."""
    for name, root in (("against", other), ("this", ROOT), ("this", ROOT), ("against", other)):
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--wrapper-times"], cwd=root,
                           capture_output=True, text=True, env={**os.environ, "PYTHONPATH": root})
        if r.returncode != 0:
            raise RuntimeError(f"timing the wrapper of {root} failed:\n{r.stdout}{r.stderr}")
        print(json.dumps({"wrapper": name, "root": root, "times": json.loads(r.stdout.strip().splitlines()[-1])}),
              flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", help="a checkout of another commit whose fused_mbconv to time in turns")
    parser.add_argument("--wrapper-times", action="store_true", help="print wrapper_times() of the imported package")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_b3 needs a CUDA card")
    if opts.wrapper_times:
        print(json.dumps(wrapper_times()), flush=True)
        return 0
    if opts.against:
        against(os.path.abspath(opts.against))
    gen = torch.Generator().manual_seed(0)
    for shape in SHAPES_640 + SHAPES_320:
        print(json.dumps(sweep_shape(*shape, gen)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
