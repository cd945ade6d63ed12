"""Model-zoo sweep: serving throughput per width preset (small/default/large).

Mirrors `tpucenterface/bench/preset_sweep.py` (`sweep_preset`, `main`): each
preset's serving program measured as the serving engine launches it, bs128
@ 640, identity preprocess (stem-baked normalize), decode K = 100, inputs in
the program's staging format (`Detector._batch_fn_auto`), in bf16 and in
int8_dw; median of `passes` FIFO-bounded rates with [min, max]. One JSON
line per preset, on the card unless `--device` names another device.

    python -m tpucenterface_torch.bench.preset_sweep [--presets small,default,large]

Where a preset has no int8 form (`detector.quantize_unsupported`), its int8
fields are None and `int8_unavailable` says why; a failure of the int8 sweep
itself raises, as any other failure does.
"""

import argparse
import json

import numpy as np


def _median(fn, im, hw, b, n, passes):
    from tpucenterface_torch.bench.timing import fifo_ips_passes, median_spread

    return median_spread(fifo_ips_passes(fn, im, hw, b, n, passes))


def sweep_preset(name: str, side=640, dev_b=128, iters=100, passes=3, device=None) -> dict:
    from tpucenterface_torch.config import preset
    from tpucenterface_torch.detector import Detector, quantize_unsupported, stage_inputs

    det = Detector(config=preset(name), device=device)
    n_params = sum(int(np.prod(np.shape(v))) for v in _leaves(det.variables))
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 255, (dev_b, side, side, 3), np.uint8)
    hws = np.tile(np.array([[side, side]], np.int32), (dev_b, 1))

    def serving_vals():
        fn, fmt = det._batch_fn_auto(dev_b, (side, side), side, identity=True, max_dets=100)
        im, hw = stage_inputs(fmt, imgs, hws, det.device)
        return _median(fn, im, hw, dev_b, iters, passes)

    bf16, bf16_spread = serving_vals()
    int8 = int8_spread = None
    unavailable = quantize_unsupported(det.config.model)
    if unavailable is None:
        det.quantize(calib_images=imgs[:8], int8_dw=True, size=side)
        try:
            int8, int8_spread = serving_vals()
        finally:
            det.dequantize()
    return {
        "preset": name,
        "params": n_params,
        "serving_bf16_img_s": bf16,
        "serving_bf16_spread": bf16_spread,
        "serving_int8_img_s": int8,
        "serving_int8_spread": int8_spread,
        "int8_unavailable": unavailable,
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None):
    p = argparse.ArgumentParser(description="width-preset serving sweep")
    p.add_argument("--presets", default="small,default,large")
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--passes", type=int, default=3)
    p.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = p.parse_args(argv)
    for name in args.presets.split(","):
        print(json.dumps(sweep_preset(name.strip(), iters=args.iters, passes=args.passes, device=args.device)),
              flush=True)


if __name__ == "__main__":
    main()
