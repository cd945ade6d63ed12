"""Time B4b (`csrc/planar_chain.cu`) under every launch plan that fits, at
the default model's three chains at batch 32 and a 640 input, on one CUDA
card:

    python3 -m tpucenterface_torch.kernels.sweep_b4b
    python3 -m tpucenterface_torch.kernels.sweep_b4b --against DIR

For each chain (random weights and input from a seed) it runs the planner's
plan and every plan of `ops.planar_mbconv.chain_plans` (each variant of
`CHAIN_VARIANTS` with each tile of `CHAIN_TILES` that fits, the same tile for
every block), holds each plan's result block by block to
`planar_mbconv_chain_plain` (the kernel's chain of k blocks against the plain
block on the kernel's chain of k-1: one bfloat16 step on at most 1% of the
values), and prints one JSON line a chain: the planner's plan and its time,
and the fastest plans with theirs (device milliseconds a launch, launches
back to back between CUDA events). `plan_planar_chain`'s cost model is
checked against these lines.

With `--against DIR` (a checkout of another commit, e.g. the parent's) it
first times `planar_mbconv_chain` of DIR's package and of this one on packed
chains (the planner's plan of each), each in its own process, in turns
(DIR, this, this, DIR), and prints one JSON line for each run and a summary:
each chain's median device time a call in both, and its spread (the largest
less the smallest of one package's two runs).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

from tpucenterface_torch.ops import planar_mbconv as pm

# (first block, H = W at a 640 input, C0, [(Ce, Cout) a block]) of the default
# model's chains (PlanarEngine at the Detector's PLANAR_CHAIN_RES)
CHAINS_640 = ((4, 80, 32, [(192, 32)] * 2), (7, 40, 64, [(384, 64)] * 3 + [(384, 96), (576, 96), (576, 96)]),
              (14, 20, 160, [(960, 160)] * 2 + [(960, 320)]))
# one bfloat16 step (chip_smoke.py's PLANAR_ATOL, PLANAR_RTOL) on at most 1% of the values
ATOL, RTOL, MAX_DIFFERING = 0.04, 2.0 ** -6, 0.01
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _blocks(gen, c0, spec, dev):
    def rnd(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    blocks, c = [], c0
    for ce, cout in spec:
        blocks.append({"w1": rnd(c, ce, scale=0.3), "b1": rnd(ce, scale=0.1), "wd": rnd(3, 3, ce, scale=0.3),
                       "bd": rnd(ce, scale=0.1), "w2": rnd(ce, cout, scale=2 * ce ** -0.5), "b2": rnd(cout, scale=0.1),
                       "skip": c == cout})
        c = cout
    return blocks


def _prefix(packed: pm.PackedChain, plan: pm.ChainPlan, k: int, b: int, h: int, w: int):
    """The first k blocks of a packed chain and of its plan, the shared
    memory and grid recomputed for them."""
    shapes = packed.shapes[:k]
    end = packed.offsets[k - 1] + pm.ChainLayout(shapes[-1]).nbytes
    sub = pm.PackedChain(packed.data[:end], shapes, packed.skips[:k])
    chunk = max(pm.ChainLayout(s).chunk_bytes for s in shapes)
    tile = max(pm.chain_tile_smem(bp.tile_h, bp.tile_w, s.cin, plan.consumers > 0) for bp, s in zip(plan.blocks, shapes))
    items = max(b * -(-h // bp.tile_h) * -(-w // bp.tile_w) for bp in plan.blocks[:k])
    return sub, dataclasses.replace(plan, blocks=plan.blocks[:k], smem_bytes=3 * chunk + tile,
                                    grid=min(items, plan.grid))


def _launch(x, packed, plan, h, w):
    out = torch.empty((x.shape[0], packed.shapes[-1].cout, x.shape[2]), dtype=torch.bfloat16, device=x.device)
    pm.launch_planar_chain(x, packed, plan, out, H=h, W=w)
    return out


def _check(x, blocks, packed, plan, h, w):
    """Block by block against the plain chain; raises on a difference over
    the bound."""
    b, prev = x.shape[0], x
    for k in range(1, len(blocks) + 1):
        cur = _launch(x, *_prefix(packed, plan, k, b, h, w), h, w)
        ref = pm.planar_mbconv_chain_plain(prev, blocks[k - 1:k], H=h, W=w)
        g, r = pm.nhwc_from_planar(cur, h, w).float(), pm.nhwc_from_planar(ref, h, w).float()
        diff = (g - r).abs()
        if (diff > ATOL + RTOL * r.abs()).any() or (diff > 0).float().mean().item() > MAX_DIFFERING:
            raise AssertionError(f"B4b differs from its plain version at block {k}, plan {_desc(plan)}")
        prev = cur


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


def _desc(plan: pm.ChainPlan):
    """[warps, consumer warps, [[tile rows, tile columns, PM, PN] a block]]"""
    return [plan.producers, plan.consumers, [[bp.tile_h, bp.tile_w, bp.pm, bp.pn] for bp in plan.blocks]]


def sweep_chain(first, hw, c0, spec, gen, b=32, top=6):
    dev = torch.device("cuda")
    blocks = _blocks(gen, c0, spec, dev)
    wp = pm.padded_width(hw, hw)
    x = (0.5 * torch.randn(b, c0, hw * wp, generator=gen)).to(dev, torch.bfloat16)
    packed = pm.pack_planar_chain(blocks, c0, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chosen = pm.plan_planar_chain(packed.shapes, b, hw, hw, sms)
    times = []
    for plan in [chosen, *pm.chain_plans(packed.shapes, b, hw, hw, sms)]:
        _check(x, blocks, packed, plan, hw, hw)
        times.append((_ms_a_launch(lambda plan=plan: _launch(x, packed, plan, hw, hw)), plan))
    fastest = sorted(times[1:], key=lambda t: t[0])[:top]
    return {"chain": [first, first + len(spec) - 1], "x": [b, c0, hw, hw], "planner": [_desc(chosen), times[0][0]],
            "fastest": [[_desc(plan), ms] for ms, plan in fastest]}


def wrapper_times():
    """`planar_mbconv_chain` of the imported package at every chain on its
    packed weights: the device time a call (calls back to back)."""
    gen = torch.Generator().manual_seed(1)
    out = []
    for first, hw, c0, spec in CHAINS_640:
        blocks = _blocks(gen, c0, spec, torch.device("cuda"))
        wp = pm.padded_width(hw, hw)
        x = (0.5 * torch.randn(32, c0, hw * wp, generator=gen)).to("cuda", torch.bfloat16)
        packed = pm.pack_planar_chain(blocks, c0, x.device)
        out.append({"chain": [first, first + len(spec) - 1],
                    "device_ms": _ms_a_launch(lambda: pm.planar_mbconv_chain(x, packed, H=hw, W=hw))})
    return out


def against(other: str):
    """`wrapper_times` of `other`'s package and of this one, each in its own
    process (this file run as a script, the package from the checkout's
    root), in turns; then each chain's medians and spreads."""
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
    for i, (first, _, _, spec) in enumerate(CHAINS_640):
        ms = {name: [t[i]["device_ms"] for n, t in runs if n == name] for name in ("against", "this")}
        summary.append({"chain": [first, first + len(spec) - 1],
                        **{f"{name}_ms": float(np.median(v)) for name, v in ms.items()},
                        **{f"{name}_spread_ms": max(v) - min(v) for name, v in ms.items()}})
    print(json.dumps({"summary": summary}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", help="a checkout of another commit whose planar_mbconv_chain to time in turns")
    parser.add_argument("--wrapper-times", action="store_true", help="print wrapper_times() of the imported package")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_b4b needs a CUDA card")
    if opts.wrapper_times:
        print(json.dumps(wrapper_times()), flush=True)
        return 0
    if opts.against:
        against(os.path.abspath(opts.against))
    gen = torch.Generator().manual_seed(0)
    for first, hw, c0, spec in CHAINS_640:
        print(json.dumps(sweep_chain(first, hw, c0, spec, gen)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
