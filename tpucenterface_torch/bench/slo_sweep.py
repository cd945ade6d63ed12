"""Serving latency-SLO curve: p50/p95/p99 request latency against offered load.

Mirrors `tpucenterface/bench/slo_sweep.py` (`_percentiles`,
`measure_saturation`, `lone_request_latency`, `loaded_latency`,
`measure_env_h2d`, `slo_sweep`, `main`). For one `runtime.serving.
ServingEngine` configuration it measures the submit -> result latency of
requests:

- "lone": closed loop, one request in flight (the floor: the small rung's
  program, its copy and the fetch);
- fractions of saturation: open-loop Poisson arrivals at r times the
  engine's measured closed-loop throughput, where the batch ladder and the
  coalescing set the latency's shape.

Every load point runs on a fresh engine, so that its latency window holds
that load alone.

The host-to-device copy. A live `submit()` copies each launch's uint8 batch
to the device; the engine's staging mode decides how: "formatted" assembles
it into a pinned host buffer and copies on a copy stream, beside the
previous launch's program; "plain" copies from pageable memory on the
compute stream. The sweep times that copy itself, a blocking copy of one
launch-sized batch in the engine's mode, median of 5, and records it as
`env_h2d_ms_per_launch` and `env_h2d_mb_s`: it is a property of the host's
link to the card, and a percentile less it reads the engine's own queueing
and compute. The copy is of the smallest ladder rung that holds a request
(the engine pads every launch to a rung), not of the request itself.

CLI: python -m tpucenterface_torch.bench.slo_sweep [--int8] [--size 640]
     [--request-bs 32] [--device-batch 128] [--seconds 8]
     [--staging formatted|plain] [--device cpu]
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def _percentiles(lat_ms: List[float]) -> Dict[str, float]:
    lat = sorted(lat_ms)

    def pct(p):
        return round(lat[min(len(lat) - 1, int(p * len(lat)))], 2)

    return {
        "n": len(lat),
        "p50_ms": pct(0.50),
        "p95_ms": pct(0.95),
        "p99_ms": pct(0.99),
        "max_ms": round(lat[-1], 2),
    }


def measure_saturation(engine, frames, n_requests: int = 40) -> float:
    """Closed-loop max throughput (img/s) with the pipeline kept full."""
    futs = [engine.submit(frames) for _ in range(n_requests)]
    t0 = time.perf_counter()
    futs2 = [engine.submit(frames) for _ in range(n_requests)]
    for f in futs + futs2:
        f.result(timeout=600)
    dt = time.perf_counter() - t0
    return n_requests * frames.shape[0] / dt


def lone_request_latency(engine, frames, n: int = 30) -> Dict[str, float]:
    """Closed-loop, one request in flight: the latency floor."""
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        engine.submit(frames).result(timeout=600)
        lat.append((time.perf_counter() - t0) * 1e3)
    return _percentiles(lat)


def loaded_latency(engine, frames, offered_img_s: float, seconds: float = 8.0, seed: int = 0) -> Dict[str, float]:
    """Open-loop Poisson arrivals at `offered_img_s`; per-request latency
    from the engine's stats window. Submission runs on this thread (submit
    does not block); results are collected afterwards, so collecting never
    slows the arrivals."""
    rng = np.random.RandomState(seed)
    bs = frames.shape[0]
    mean_gap = bs / offered_img_s
    t_end = time.perf_counter() + seconds
    futs = []
    nxt = time.perf_counter()
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        if now < nxt:
            time.sleep(min(nxt - now, 0.002))
            continue
        futs.append(engine.submit(frames))
        nxt += rng.exponential(mean_gap)
    for f in futs:
        f.result(timeout=600)
    s = engine.stats()
    return {
        "offered_img_s": round(offered_img_s, 1),
        "achieved_requests": len(futs),
        "p50_ms": s["latency_ms_p50"],
        "p95_ms": s["latency_ms_p95"],
        "p99_ms": s["latency_ms_p99"],
        "max_ms": s["latency_ms_max"],
    }


def measure_env_h2d(hw, batch: int, trials: int = 5, staging: str = "formatted", device=None) -> Dict[str, float]:
    """The host-to-device copy of one fresh launch-sized uint8 batch in the
    staging mode `staging` ("formatted": through a pinned staging ring;
    "plain": the pageable copy), blocking until it has landed on `device`
    (the card unless the caller names another): median of `trials`."""
    from tpucenterface_torch.config import resolve_device
    from tpucenterface_torch.detector import PinnedStaging, stage_inputs

    if staging not in ("formatted", "plain"):
        raise ValueError(f"staging must be 'formatted' or 'plain', got {staging!r}")
    dev = resolve_device(device)
    fmt = PinnedStaging(batch, tuple(hw), dev) if staging == "formatted" and dev.type == "cuda" else None
    rng = np.random.RandomState(1)
    times = []
    for _ in range(trials):
        imgs = rng.randint(0, 255, (batch, *hw, 3), np.uint8)
        hws = np.full((batch, 2), hw[0], np.int32)
        t0 = time.perf_counter()
        im, _ = stage_inputs(fmt, imgs, hws, dev)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        times.append(time.perf_counter() - t0)
        del im
    med = sorted(times)[len(times) // 2]
    nbytes = batch * hw[0] * hw[1] * 3
    return {
        "env_h2d_ms_per_launch": round(med * 1e3, 1),
        "env_h2d_mb_s": round(nbytes / 1e6 / med, 1),
    }


def slo_sweep(
    det,
    hw,
    request_bs: int = 32,
    device_batch: int = 128,
    fractions: Sequence[float] = (0.25, 0.5, 0.75, 0.95),
    seconds: float = 8.0,
    max_dets: Optional[int] = 100,
    int8_input: bool = False,
    staging: str = "formatted",
) -> Dict[str, object]:
    """Run the whole sweep on `det`'s device, a fresh engine per load point."""
    from tpucenterface_torch.runtime.serving import ServingEngine

    rng = np.random.RandomState(0)
    frames = rng.randint(0, 255, (request_bs, *hw, 3), np.uint8)

    def fresh_engine():
        return ServingEngine(
            det, hw, device_batch=device_batch, score_thresh=0.3,
            max_dets=max_dets, int8_input=int8_input, staging=staging,
        )

    # warm every ladder rung once (programs and staging rings stay on the
    # Detector, so later fresh engines start warm and each window is pure)
    with fresh_engine() as eng:
        eng.submit(frames).result(timeout=600)
        [f.result(timeout=600) for f in [eng.submit(frames) for _ in range(8)]]

    with fresh_engine() as eng:
        sat = measure_saturation(eng, frames)
    with fresh_engine() as eng:
        lone = lone_request_latency(eng, frames)
    points = []
    for frac in fractions:
        with fresh_engine() as eng:
            pt = loaded_latency(eng, frames, sat * frac, seconds=seconds)
            pt["load_frac"] = frac
            points.append(pt)
    out: Dict[str, object] = {
        "hw": list(hw),
        "request_bs": request_bs,
        "device_batch": device_batch,
        "staging": staging,
        "saturation_img_s": round(sat, 1),
        "lone_request": lone,
        "loaded": points,
    }
    # the copy at the lone request's launch size: the smallest rung of the
    # default ladder {device_batch // 4, device_batch} that holds request_bs
    rungs = sorted({max(1, device_batch // 4), device_batch})
    launch_bs = next((b for b in rungs if b >= request_bs), device_batch)
    out["env_h2d_launch_bs"] = launch_bs
    out.update(measure_env_h2d(hw, launch_bs, staging=staging, device=det.device))
    return out


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Serving latency-SLO sweep")
    p.add_argument("--size", type=int, default=640)
    p.add_argument("--request-bs", type=int, default=32)
    p.add_argument("--device-batch", type=int, default=128)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--int8", action="store_true", help="sweep the int8_dw serving forward")
    p.add_argument("--int8-input", action="store_true")
    p.add_argument("--staging", choices=("formatted", "plain"), default="formatted",
                   help="launch staging mode (see the module docstring), recorded in the JSON")
    p.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = p.parse_args(argv)

    from tpucenterface_torch.config import DetectorConfig
    from tpucenterface_torch.detector import Detector

    det = Detector(config=DetectorConfig(default_size=args.size), device=args.device)
    if args.int8 or args.int8_input:
        rng = np.random.RandomState(0)
        det.quantize(calib_images=rng.randint(0, 255, (8, args.size, args.size, 3), np.uint8), int8_dw=True)
    out = slo_sweep(
        det,
        (args.size, args.size),
        request_bs=args.request_bs,
        device_batch=args.device_batch,
        seconds=args.seconds,
        int8_input=args.int8_input,
        staging=args.staging,
    )
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
