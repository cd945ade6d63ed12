"""Time B2 (`csrc/decode.cu`) under every launch plan, at four decode shapes
(K = 200), on one CUDA card:

    python3 -m tpucenterface_torch.kernels.sweep_b2
    python3 -m tpucenterface_torch.kernels.sweep_b2 --against DIR

For each shape (random heads from a seed, as the fused heads give them) it
runs the planner's plan and every plan of `decode.fused_decode.decode_plans`
(each band height of DECODE_ROWS cut to the map, with each block size of
DECODE_THREADS), holds each plan's result to
`decode_feats_fused_plain` (indices equal, scores within 1e-6, boxes within
1e-4) and prints one JSON line a shape: the planner's plan and its time, and
the fastest plans with theirs. A time is device milliseconds a call: the
calls back to back in one CUDA graph, so that the wrapper's host time, which
is longer than the kernel's, is not counted. `plan_decode`'s cost model is
checked against these lines.

With `--against DIR` (a checkout of another commit, e.g. the parent's) it
first times `decode_feats_fused` of DIR's package and of this one at the
same shapes, each in its own process, in turns (DIR, this, this, DIR), and
prints one JSON line for each run: one call between CUDA events, as
`chip_smoke.py` times a kernel (host time included), and the device time a
call as above.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

from tpucenterface_torch.config import DecodeConfig
from tpucenterface_torch.decode import fused_decode as fd

# (B, H, W) heads: bs32 at the 640 and 320 buckets, one 640 image, bs2 at 1024
SHAPES = ((32, 160, 160), (1, 160, 160), (32, 80, 80), (2, 256, 256))
K = 200
SCORE_ATOL, BOX_ATOL = 1e-6, 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _heads(gen, b, h, w):
    """Random heads on the card, hm/wh/off as views of one (B, H, W, 5) map."""
    y = torch.cat([3.0 * torch.randn(b, h, w, 1, generator=gen), 6.0 * torch.rand(b, h, w, 2, generator=gen) - 0.5,
                   torch.rand(b, h, w, 2, generator=gen) - 0.5], dim=-1).cuda()
    return {"hm": y[..., 0:1], "wh": y[..., 1:3], "off": y[..., 3:5], "whoff": y[..., 1:5]}


def _graph_ms(fn, calls=20, runs=5):
    """Device milliseconds a call: the median over `runs` of CUDA events
    around one replay of a CUDA graph of `calls` calls, after warm-up."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def _one_call_ms(fn, iters=50):
    """Milliseconds of one call between two CUDA events (the median of
    `iters`), after warm-up: the wrapper's host time and the kernels'."""
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


def _desc(plan: fd.DecodePlan):
    """[rows a band, stage-1 threads, candidates]"""
    return [plan.rows, plan.threads, plan.candidates]


def _check(feats, cfg, plan, want):
    kb, ks, ki = fd.launch_decode(feats, cfg, plan)
    pb, ps, pi = want
    torch.cuda.synchronize()
    if not (torch.equal(ki, pi) and (ks - ps).abs().max().item() <= SCORE_ATOL
            and (kb - pb).abs().max().item() <= BOX_ATOL):
        raise AssertionError(f"B2 differs from its plain version at heads {tuple(feats['hm'].shape[:3])}, "
                             f"plan {_desc(plan)}")


def sweep_shape(b, h, w, gen, top=6):
    feats = _heads(gen, b, h, w)
    cfg = DecodeConfig(max_dets=K)
    k = min(K, h * w)
    want = fd.decode_feats_fused_plain(feats, cfg)
    chosen = fd.plan_decode(b, h, w, k)
    times = []
    for plan in [chosen, *fd.decode_plans(b, h, w, k)]:
        _check(feats, cfg, plan, want)
        times.append((_graph_ms(lambda plan=plan: fd.launch_decode(feats, cfg, plan)), plan))
    fastest = sorted(times[1:], key=lambda t: t[0])[:top]
    return {"heads": [b, h, w], "k": k, "planner": [_desc(chosen), times[0][0]],
            "fastest": [[_desc(plan), ms] for ms, plan in fastest]}


def wrapper_times():
    """`decode_feats_fused` at SHAPES; uses nothing of the package that an
    earlier commit's lacks, so it runs against either checkout."""
    gen = torch.Generator().manual_seed(0)
    cfg = DecodeConfig(max_dets=K)
    out = []
    for shape in SHAPES:
        feats = _heads(gen, *shape)
        call = lambda: fd.decode_feats_fused(feats, cfg)  # noqa: E731
        out.append({"heads": list(shape), "one_call_ms": _one_call_ms(call), "device_ms": _graph_ms(call)})
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
    parser.add_argument("--against", help="a checkout of another commit whose decode_feats_fused to time in turns")
    parser.add_argument("--wrapper-times", action="store_true", help="print wrapper_times() of the imported package")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_b2 needs a CUDA card")
    if opts.wrapper_times:
        print(json.dumps(wrapper_times()), flush=True)
        return 0
    if opts.against:
        against(os.path.abspath(opts.against))
    gen = torch.Generator().manual_seed(0)
    for b, h, w in SHAPES:
        print(json.dumps(sweep_shape(b, h, w, gen)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
