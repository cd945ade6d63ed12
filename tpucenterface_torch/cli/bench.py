"""Headline benchmark: images/s of the bs32 @ 640 batch program and of the
bs128 serving programs (bf16, int8, int8-input), on the card.

Mirrors the root `bench.py` of the JAX package, step for step, with its
constants, its environment variables and its JSON keys, on the port's
measuring tools (`bench.timing.fifo_ips_passes` and `median_spread`,
`bench.roofline.roofline_of_fn`):
1. `Detector(config=DetectorConfig())`, random weights; 32 random 640x640
   uint8 images from `np.random.RandomState(0)`;
2. `value`: the bs32 @ 640 batch program's images/s, the median of
   BENCH_PASSES passes (5) of BENCH_ITERS launches (100), with its [min, max];
3. `serving_coalesced_img_s`: the same frames tiled to a bs128 program as
   `ServingEngine` launches it for pre-sized frames (identity preprocess,
   K = 100, inputs staged as `Detector._batch_fn_auto` gives them),
   max(200, BENCH_ITERS * 32 / 128) launches a pass, and its roofline;
4. `serving_int8_img_s`: `quantize(calib_images=imgs[:8], int8_dw=True)`
   (the library route, `fused_blocks=False`), the same program and roofline;
5. `serving_int8in_img_s`: the frames put through the stem's table on the
   host (`quant.engine.apply_stem_lut`), then the int8-input program on
   them; `dequantize()` in a `finally`.
One JSON line.

Where it differs from `bench.py`:
- `vs_baseline` and `serving_int8_vs_baseline` are null: `bench.py` divides
  by a rate target set for its TPU, and no target is set for a card yet (as
  in `cli/bench_suite.py`).
- Nothing is caught: a failed roofline, int8 or int8-input measurement
  raises, where `bench.py` prints "skipped" and leaves the field null.
- On a card the uint8 serving programs take their inputs from the pinned
  staging ring (`detector.PinnedStaging`), where JAX stages them in XLA's
  AUTO layouts; the int8-input program takes the pageable copy, as in JAX.
  Every rate is the device program's, on inputs staged once.

    python -m tpucenterface_torch.cli.bench [--device cpu]

BENCH_SERVE_ITERS, where set, replaces the serving programs' launches a
pass (`measure(serve_iters=)`): on the CPU the 200 of `bench.py` take long.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch


def frames(batch: int, side: int):
    """The headline's uint8 images (batch, side, side, 3) and their hws, from
    `np.random.RandomState(0)` as `bench.py` draws them."""
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 255, (batch, side, side, 3), np.uint8)
    return imgs, np.tile(np.array([[side, side]], np.int32), (batch, 1))


def measure(det, batch: int = 32, side: int = 640, dev_b: int = 128, serve_k: int = 100,
            iters: int = 100, passes: int = 5, serve_iters: Optional[int] = None) -> dict:
    """`bench.py`'s measurements on `det` (its device, its weights) and its
    JSON dict. `serve_iters`: the serving programs' launches a pass, by
    default `bench.py`'s max(200, iters * batch / dev_b)."""
    from tpucenterface_torch.bench.roofline import roofline_of_fn
    from tpucenterface_torch.bench.timing import fifo_ips_passes, median_spread
    from tpucenterface_torch.detector import stage_inputs
    from tpucenterface_torch.quant.engine import apply_stem_lut

    if dev_b % batch:
        raise ValueError(f"the serving batch {dev_b} must be a multiple of the batch {batch}")

    def stats(vals):
        return median_spread(vals, ndigits=2)

    imgs, hws = frames(batch, side)
    fn = det._batch_fn(batch, (side, side), side)
    im, hw = (torch.from_numpy(a).to(det.device) for a in (imgs, hws))
    ips, ips_spread = stats(fifo_ips_passes(fn, im, hw, batch, iters, passes))
    del im, hw

    imgs128 = np.tile(imgs, (dev_b // batch, 1, 1, 1))
    hws128 = np.tile(hws, (dev_b // batch, 1))
    iters128 = serve_iters if serve_iters is not None else max(200, (iters * batch) // dev_b)

    def serving(int8: bool = False, int8_in: bool = False, images=imgs128):
        """((median, spread), roofline or None) of the serving program."""
        fn_, fmt = det._batch_fn_auto(dev_b, (side, side), side, identity=True, max_dets=serve_k,
                                      int8_in=int8_in)
        im_, hw_ = stage_inputs(fmt, images, hws128, det.device)
        rate = stats(fifo_ips_passes(fn_, im_, hw_, dev_b, iters128, passes))
        roof = None if int8_in else roofline_of_fn(fn_, (im_, hw_), iters=3, int8=int8, recorded_floors=True)
        return rate, roof

    (serving_ips, serving_spread), rl_bf16 = serving()
    det.quantize(calib_images=imgs[:8], int8_dw=True)
    try:
        (serving_int8, serving_int8_spread), rl_int8 = serving(int8=True)
        i8 = apply_stem_lut(imgs128, det.stem_input_lut())
        (serving_int8in, serving_int8in_spread), _ = serving(int8_in=True, images=i8)
    finally:
        det.dequantize()

    return {
        "metric": f"images/sec/chip @{side}x{side} bs{batch} fused",
        "value": ips,
        "unit": "img/s",
        "vs_baseline": None,
        "value_spread": ips_spread,
        "serving_coalesced_img_s": serving_ips,
        "serving_coalesced_spread": serving_spread,
        "serving_int8_img_s": serving_int8,
        "serving_int8_spread": serving_int8_spread,
        "serving_int8_vs_baseline": None,
        "serving_int8in_img_s": serving_int8in,
        "serving_int8in_spread": serving_int8in_spread,
        # whole-program achieved TFLOP/s and HBM TB/s against the H100 SXM
        # data-sheet peaks (bench/roofline.py), and per-section ms beside
        # their roofline floors
        "serving_mfu": rl_bf16["mfu"],
        "serving_hbm_frac": rl_bf16["hbm_frac"],
        "serving_roofline": rl_bf16,
        "serving_sections": rl_bf16["sections"],
        "serving_int8_sections": rl_int8["sections"],
        "serving_int8_mfu": rl_int8["mfu"],
        "serving_int8_hbm_frac": rl_int8["hbm_frac"],
        "serving_int8_roofline": rl_int8,
        "serving_note": f"bs{batch} request stream coalesced to bs{dev_b} device programs as "
        "ServingEngine launches them for pre-sized frames (runtime/serving.py): identity preprocess "
        f"(stem-baked normalize), decode K={serve_k}, inputs staged once as Detector._batch_fn_auto "
        "gives them (the pinned staging ring on a card); int8 = opt-in W8A8 PTQ forward with "
        "per-channel int8 depthwise (Detector.quantize(int8_dw=True)) on its library route "
        "(torch._int_mm products, int32 depthwise sums), AP within 0.005 of the JAX int8_dw "
        "detector's on the flagship split (tests/test_torch_quant.py::"
        "test_flagship_int8_dw_ap_matches_jax); int8in = ServingEngine int8_input mode (the stem's "
        "table applied on the host, quant.engine.apply_stem_lut; pageable copy), detections equal to "
        "the int8 program's bit for bit (chip_smoke.py [headline]); "
        f"all fields median-of-{passes} passes with [min,max] spread",
    }


def main(argv=None):
    p = argparse.ArgumentParser(description="headline benchmark (bench.py's JSON line)")
    p.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = p.parse_args(argv)

    from tpucenterface_torch.config import DetectorConfig
    from tpucenterface_torch.detector import Detector

    det = Detector(config=DetectorConfig(), device=args.device)
    serve_iters = os.environ.get("BENCH_SERVE_ITERS")
    out = measure(
        det,
        iters=int(os.environ.get("BENCH_ITERS", "100")),
        passes=int(os.environ.get("BENCH_PASSES", "5")),
        serve_iters=int(serve_iters) if serve_iters else None,
    )
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
