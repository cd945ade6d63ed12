"""Time B6 (`csrc/int8_block.cu`) under every launch plan that fits, at the
default model's four stride-2 block shapes at batch 32 and a 640 input, on
one CUDA card:

    python3 -m tpucenterface_torch.kernels.sweep_b6
    python3 -m tpucenterface_torch.kernels.sweep_b6 --against DIR

For each block (random operands and input from a seed) it runs every plan of
`ops.int8_block.s2_plans` (each tile of `S2_TILES`, cut to the output map,
with each variant of `S2_VARIANTS` that fits) through
`launch_int8_block_s2`, holds each result to `fused_block_int8_plain` bit for
bit, and prints one JSON line a block: the planner's plan and its time, and
the fastest plans with theirs (device milliseconds a launch, launches back to
back between CUDA events). `plan_int8_block_s2`'s cost model is checked
against these lines.

With `--against DIR` (a checkout of another commit, e.g. the parent's) it
first times `int8_block_s2` of DIR's package and of this one at the same
blocks, each in its own process, in turns (DIR, this, this, DIR), and prints
one JSON line for each run: one call between CUDA events (host time
included) and the device time a call as above. A package whose
`int8_block_s2` takes the eleven operands rather than the packed form gets
them converted once, before timing (wd as int8, every operand contiguous),
so that its time is its kernel's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

from tpucenterface_torch.ops import int8_block as ib

# (block, H = W of x at a 640 input, Cin, Cmid, Cout) of the default model's
# stride-2 blocks
BLOCKS_640 = ((1, 320, 16, 96, 24), (3, 160, 24, 144, 32), (6, 80, 32, 192, 64), (13, 40, 96, 576, 160))
BATCH = 32
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _inputs(seed, hw, cin, cmid, cout):
    """x (BATCH, hw, hw, Cin) int8 and the block's eleven operands (JAX
    layout, on the card), at the scales of chip_smoke.py's random blocks."""
    gen = torch.Generator().manual_seed(seed)

    def ints(*shape):
        return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to("cuda")

    def rand(n, a, b=0.0):
        return (torch.rand(n, generator=gen) * a + b).to("cuda")

    ops = {"we": ints(cmid, cin), "e_scale": rand(cmid, 2e-4, 1e-4), "e_bias": rand(cmid, 0.5),
           "e_inv_sdw": rand(cmid, 40, 20), "wd": ints(9, cmid).float(), "d_scale": rand(cmid, 2e-4, 1e-4),
           "d_bias": rand(cmid, 0.5), "d_inv_sproj": rand(cmid, 40, 20), "wp": ints(cout, cmid),
           "p_scale": rand(cout, 2e-4, 1e-4), "p_bias": rand(cout, 0.5)}
    return ints(BATCH, hw, hw, cin), ops


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


def _desc(plan: ib.Int8BlockPlan):
    """[tile rows, tile columns, chunk width, warps, PM, PN]"""
    return [plan.tile_h, plan.tile_w, plan.ck, plan.warps, plan.pm, plan.pn]


def sweep_block(seed, block, hw, cin, cmid, cout, top=6):
    """{"block", "x", "planner": [plan, ms], "fastest": [[plan, ms], ...],
    "all": [[plan, ms], ...]} for one block."""
    x, ops = _inputs(seed, hw, cin, cmid, cout)
    packed = ib.pack_int8_block_s1(**ops)
    want = ib.fused_block_int8_plain(x, **ops)
    out = torch.empty_like(want)
    times = {}
    for plan in ib.s2_plans(BATCH, hw, hw, cin, cmid, cout):
        key = tuple(_desc(plan))
        out.fill_(0)
        ib.launch_int8_block_s2(x, packed, plan, out)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"B6 differs from its plain version at block {block}, plan {list(key)}: "
                                 f"{(out != want).sum().item()} values")
        times[key] = _ms_a_launch(lambda plan=plan: ib.launch_int8_block_s2(x, packed, plan, out))
    chosen = tuple(_desc(ib.plan_int8_block_s2(BATCH, hw, hw, cin, cmid, cout)))
    fastest = sorted(times.items(), key=lambda kv: kv[1])[:top]
    return {"block": block, "x": [BATCH, hw, hw, cin], "cmid": cmid, "cout": cout,
            "planner": [list(chosen), times[chosen]], "fastest": [[list(k), v] for k, v in fastest],
            "all": [[list(k), v] for k, v in times.items()]}


def wrapper_times():
    """`int8_block_s2` of the imported package at every block: one call, and
    the device time a call. The packed form where the package has it, else
    the eleven operands converted once (wd int8, contiguous)."""
    out = []
    for seed, (block, hw, cin, cmid, cout) in enumerate(BLOCKS_640):
        x, ops = _inputs(seed, hw, cin, cmid, cout)
        if hasattr(ib, "plan_int8_block_s2"):
            packed = ib.pack_int8_block_s1(**ops)

            def call():
                return ib.int8_block_s2(x, packed)
        else:
            raw = {k: (v.to(torch.int8) if k == "wd" else v).contiguous() for k, v in ops.items()}

            def call():
                return ib.int8_block_s2(x, **raw)

        if not torch.equal(call(), ib.fused_block_int8_plain(x, **ops)):
            raise AssertionError(f"int8_block_s2 differs from its plain version at block {block}")
        out.append({"block": block, "x": [BATCH, hw, hw, cin], "one_call_ms": _one_call_ms(call),
                    "device_ms": _ms_a_launch(call)})
    return out


def against(other: str):
    """`wrapper_times` of `other`'s package and of this one, each in its own
    process (this file run as a script, the package from the checkout's
    root), in turns; then each block's medians, the ratio other / this, and
    the four blocks' totals."""
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
    for i, (block, *_rest) in enumerate(BLOCKS_640):
        med = {name: float(np.median([t[i]["device_ms"] for n, t in runs if n == name])) for name in ("against", "this")}
        summary.append({"block": block, "against_device_ms": med["against"], "this_device_ms": med["this"],
                        "speedup": med["against"] / med["this"]})
    total = {k: sum(s[k] for s in summary) for k in ("against_device_ms", "this_device_ms")}
    print(json.dumps({"summary": summary, "total": {**total,
                                                    "speedup": total["against_device_ms"] / total["this_device_ms"]}}),
          flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", help="a checkout of another commit whose int8_block_s2 to time in turns")
    parser.add_argument("--wrapper-times", action="store_true", help="print wrapper_times() of the imported package")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_b6 needs a CUDA card")
    if opts.wrapper_times:
        print(json.dumps(wrapper_times()), flush=True)
        return 0
    if opts.against:
        against(os.path.abspath(opts.against))
    for seed, spec in enumerate(BLOCKS_640):
        print(json.dumps(sweep_block(seed, *spec)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
