"""Time B7 (`csrc/int8_block_s1.cu`) under every launch plan that fits, at
the default model's stride-1 block shapes at batch 32 and a 640 input, on
one CUDA card:

    python3 -m tpucenterface_torch.kernels.sweep_b7

For each shape (random operands and input from a seed) it runs every plan of
`ops.int8_block.s1_plans` (each tile of `S1_TILES`, cut to the map, with
each variant of `S1_VARIANTS` that fits), holds each result to
`fused_block_s1_plain` bit for bit, and prints one JSON line a shape: the
planner's plan and its time, and the fastest plans with theirs (device
milliseconds a launch, launches back to back between CUDA events).
`plan_int8_block_s1`'s cost model is checked against these lines.
"""

from __future__ import annotations

import functools
import json

import numpy as np
import torch

from tpucenterface_torch.ops import int8_block as ib

# (map at a 640 input, Cin, Cmid, Cout) of the default model's stride-1
# residual blocks with an expand (2, 4-5, 7-9, 11-12, 14-15)
BLOCKS_640 = ((160, 24, 144, 24), (80, 32, 192, 32), (40, 64, 384, 64), (40, 96, 576, 96), (20, 160, 960, 160))


def _operands(gen, cin, cmid, cout, dev):
    def ints(*shape):
        return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(dev)

    def rand(n, a, b=0.0):
        return (torch.rand(n, generator=gen) * a + b).to(dev)

    return {"we": ints(cmid, cin), "e_scale": rand(cmid, 2e-4, 1e-4), "e_bias": rand(cmid, 0.5),
            "e_inv_sdw": rand(cmid, 40, 20), "wd": ints(9, cmid).float(), "d_scale": rand(cmid, 2e-4, 1e-4),
            "d_bias": rand(cmid, 0.5), "d_inv_sproj": rand(cmid, 40, 20), "wp": ints(cout, cmid),
            "p_scale": rand(cout, 2e-4, 1e-4), "p_bias": rand(cout, 0.5)}


def _ms_a_launch(fn, launches=20, runs=5):
    """Device milliseconds a launch: the median over `runs` of CUDA events
    around `launches` launches back to back, after warm-up (so the host's
    time between launches is hidden, as in a forward)."""
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


def sweep_shape(b, h, w, cin, cmid, cout, gen, top=6):
    """{"shape", "planner": [plan, ms], "fastest": [[plan, ms], ...]} for one
    block shape; a plan is (tile_h, tile_w, warps, pm, pn)."""
    dev = torch.device("cuda")
    ops = _operands(gen, cin, cmid, cout, dev)
    x = (2.0 * torch.randn(b, h, w, cin, generator=gen)).to(dev, torch.bfloat16)
    packed = ib.pack_int8_block_s1(**ops)
    want = ib.fused_block_s1_plain(x, 37.5, **ops)
    out = torch.empty((b, h, w, cout), dtype=torch.bfloat16, device=dev)
    times = {}
    for plan in ib.s1_plans(b, h, w, cin, cmid, cout):
        key = (plan.tile_h, plan.tile_w, plan.warps, plan.pm, plan.pn)
        call = functools.partial(ib.launch_int8_block_s1, x, 37.5, packed, plan, True, out)
        call()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"B7 differs from its plain version at {(b, h, w, cin, cmid, cout)}, plan {key}")
        times[key] = _ms_a_launch(call)
    plan = ib.plan_int8_block_s1(b, h, w, cin, cmid, cout)
    chosen = (plan.tile_h, plan.tile_w, plan.warps, plan.pm, plan.pn)
    fastest = sorted(times.items(), key=lambda kv: kv[1])[:top]
    return {"shape": [b, h, w, cin, cmid, cout], "planner": [list(chosen), times[chosen]],
            "fastest": [[list(k), v] for k, v in fastest]}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("sweep_b7 needs a CUDA card")
    gen = torch.Generator().manual_seed(0)
    for hw, cin, cmid, cout in BLOCKS_640:
        print(json.dumps(sweep_shape(32, hw, hw, cin, cmid, cout, gen)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
