"""Time B4a, the one-block planar kernel (`csrc/planar_chain.cu`,
`tcf_planar_block`), under every launch plan that fits, at five stride-1
blocks of the default model at batch 32 and a 640 input, on one CUDA card:

    python3 -m tpucenterface_torch.kernels.sweep_b4a
    python3 -m tpucenterface_torch.kernels.sweep_b4a --against DIR

For each block (random weights and input from a seed, garbage in the pad
columns) it runs the planner's plan and every plan of
`ops.planar_mbconv.one_block_plans` (each variant of ONE_BLOCK_VARIANTS with
each tile of ONE_BLOCK_TILES that fits), holds each result to
`planar_mbconv_plain` under chip_smoke.py's `_planar_compare` limits (one
bfloat16 step on at most 1% of the values, finite, pad columns zero) and
prints one JSON line a block: the planner's plan and its time, and the
fastest plans with theirs (device milliseconds a launch: launches back to
back between CUDA events). `plan_planar_mbconv`'s cost model is checked
against these lines.

With `--against DIR` (a checkout of another commit, e.g. the parent's) it
first times `planar_mbconv` of DIR's package and of this one on packed
weights at the same blocks, each in its own process, in turns (DIR, this,
this, DIR), and prints one JSON line for each run: one call between CUDA
events (host time included) and the device time a call as above.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

from tpucenterface_torch.ops import planar_mbconv as pm

# (block, H = W at a 640 input, Cin, Ce, Cout, skip) of the default model:
# block 0 has no expand (Ce == Cin)
BLOCKS_640 = ((0, 320, 32, 32, 16, False), (2, 160, 24, 144, 24, True), (4, 80, 32, 192, 32, True),
              (7, 40, 64, 384, 64, True), (14, 20, 160, 960, 160, True))
BATCH = 32
# chip_smoke.py's PLANAR_ATOL, PLANAR_RTOL, PLANAR_MAX_DIFFERING
ATOL, RTOL, MAX_DIFFERING = 0.04, 2.0 ** -6, 0.01
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _inputs(seed, hw, cin, ce, cout, skip):
    """x (BATCH, Cin, H*Wp) bf16 with garbage in the pad columns and the
    block's weights, at the scales of chip_smoke.py's random blocks."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda")

    wp = pm.padded_width(hw, hw)
    x = rnd(BATCH, cin, hw, wp, scale=0.5)
    x[..., hw:] *= 80.0
    expand = ce != cin
    blk = {"w1": rnd(cin, ce, scale=0.3) if expand else None, "b1": rnd(ce, scale=0.1) if expand else None,
           "wd": rnd(3, 3, ce, scale=0.3), "bd": rnd(ce, scale=0.1), "w2": rnd(ce, cout, scale=2 * ce ** -0.5),
           "b2": rnd(cout, scale=0.1), "skip": skip}
    return x.reshape(BATCH, cin, hw * wp).to(torch.bfloat16).contiguous(), blk


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


def _check(got, want, hw, what):
    """chip_smoke.py's `_planar_compare` for one block: finite, pad columns
    zero, real columns within one bfloat16 step on at most 1% of them."""
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"B4a gives non-finite values at {what}")
    wp = pm.padded_width(hw, hw)
    if (got.reshape(BATCH, got.shape[1], hw, wp)[..., hw:] != 0).any():
        raise AssertionError(f"B4a leaves pad columns that are not zero at {what}")
    g, r = pm.nhwc_from_planar(got, hw, hw).float(), pm.nhwc_from_planar(want, hw, hw).float()
    diff = (g - r).abs()
    over = (diff > ATOL + RTOL * r.abs()).sum().item()
    differing = (diff > 0).float().mean().item()
    if over or differing > MAX_DIFFERING:
        raise AssertionError(f"B4a differs from its plain version at {what}: {over} values over the tolerance, "
                             f"{differing:.2e} differing")
    return diff.max().item(), differing


def _desc(plan: pm.OneBlockPlan):
    """[warps, consumer warps, PMX, PNX, streamed, tile rows, tile columns, PM, PN, chunk buffers, blocks an
    SM, grid]"""
    return [*plan.variant, plan.tile_h, plan.tile_w, plan.pm, plan.pn, plan.chunk_buffers, plan.blocks_per_sm,
            plan.grid]


def sweep_block(seed, block, hw, cin, ce, cout, skip, top=6):
    """{"block", "x", "planner": [plan, ms, max |err|], "fastest": [[plan, ms], ...]}."""
    x, blk = _inputs(seed, hw, cin, ce, cout, skip)
    args = [blk[k] for k in ("w1", "b1", "wd", "bd", "w2", "b2")]
    want = pm.planar_mbconv_plain(x, *args, H=hw, W=hw, skip=skip)
    packed = pm.pack_planar_chain([blk], cin, x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    shape = packed.shapes[0]
    chosen = pm.plan_planar_mbconv(shape, BATCH, hw, hw, sms, skip=skip)
    out = torch.empty((BATCH, cout, x.shape[2]), dtype=torch.bfloat16, device=x.device)
    times, errs = {}, {}
    for plan in [chosen, *pm.one_block_plans(shape, BATCH, hw, hw, sms, skip=skip)]:
        key = tuple(_desc(plan))
        if key in times:
            continue
        out.fill_(float("nan"))
        pm.launch_planar_mbconv(x, packed, plan, out, H=hw, W=hw)
        torch.cuda.synchronize()
        errs[key] = _check(out, want, hw, f"block {block}, plan {list(key)}")
        times[key] = _ms_a_launch(lambda plan=plan: pm.launch_planar_mbconv(x, packed, plan, out, H=hw, W=hw))
    fastest = sorted(times.items(), key=lambda kv: kv[1])[:top]
    ck = tuple(_desc(chosen))
    return {"block": block, "x": [BATCH, cin, hw, hw], "ce": ce, "cout": cout, "planner": [list(ck), times[ck], errs[ck][0]],
            "planner_desc": chosen.describe(), "fastest": [[list(k), v] for k, v in fastest],
            "all": [[list(k), v] for k, v in times.items()]}


def wrapper_times():
    """`planar_mbconv` of the imported package at every block on packed
    weights (`pack_planar_chain`, or an older commit's `pack_planar_blocks`):
    one call, and the device time a call."""
    out = []
    for seed, (block, hw, cin, ce, cout, skip) in enumerate(BLOCKS_640):
        x, blk = _inputs(seed, hw, cin, ce, cout, skip)
        pack = getattr(pm, "pack_planar_blocks", None) or pm.pack_planar_chain
        packed = pack([blk], cin, x.device)

        def call():
            return pm.planar_mbconv(x, packed, H=hw, W=hw)

        out.append({"block": block, "x": [BATCH, cin, hw, hw], "one_call_ms": _one_call_ms(call),
                    "device_ms": _ms_a_launch(call)})
    return out


def against(other: str):
    """`wrapper_times` of `other`'s package and of this one, each in its own
    process (this file run as a script, the package from the checkout's
    root), in turns; then each block's medians and the ratio other / this."""
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
    first_two = [s for s in summary if s["block"] in (0, 2)]
    print(json.dumps({"summary": summary, "blocks_0_2": {
        "against_ms": sum(s["against_device_ms"] for s in first_two), "this_ms": sum(s["this_device_ms"] for s in first_two),
        "speedup": sum(s["against_device_ms"] for s in first_two) / sum(s["this_device_ms"] for s in first_two)}}),
        flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", help="a checkout of another commit whose planar_mbconv to time in turns")
    parser.add_argument("--wrapper-times", action="store_true", help="print wrapper_times() of the imported package")
    parser.add_argument("--blocks", default="", help="comma-separated blocks of BLOCKS_640 to sweep (default: all)")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_b4a needs a CUDA card")
    if opts.wrapper_times:
        print(json.dumps(wrapper_times()), flush=True)
        return 0
    if opts.against:
        against(os.path.abspath(opts.against))
    only = {int(b) for b in opts.blocks.split(",") if b}
    for seed, spec in enumerate(BLOCKS_640):
        if not only or spec[0] in only:
            print(json.dumps(sweep_block(seed, *spec)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
