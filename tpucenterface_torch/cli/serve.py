"""Serving CLI: dynamic-batching detection over an image directory or N
synthetic images.

    python -m tpucenterface_torch.cli.serve --source DIR --weights w.pth --out dets.jsonl

Mirrors `tpucenterface/cli/serve.py`, with the same arguments, the same
argument errors (argparse exits with code 2) and `--device` (the GPU unless
it names another, e.g. `--device cpu`). Every image goes through the port's
`runtime.serving.ServingRouter`, which coalesces same-bucket images into
launches of up to `--device-batch`. The last line of standard output is a
JSON summary: images, faces, wall seconds, images/s and each engine's
`stats()`.

`cv2` is imported only to read a `--source` directory and to resize
calibration frames that are not already `default_size` square (what
`cv2.resize` does to a frame of the target size is to return it unchanged),
so `--source synthetic` runs without it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time


def load_detector(weights, device, tag):
    """The Detector of a `.safetensors` or torch `.pth` file, or of random
    weights when there is none."""
    from tpucenterface_torch.detector import Detector

    if weights and weights.endswith(".pth"):
        return Detector.from_torch_pth(weights, device=device)
    if weights:
        return Detector.from_safetensors(weights, device=device)
    print(f"[{tag}] no --weights: random-init model (boxes are meaningless)")
    return Detector(device=device)


def _calibration_frames(images, size):
    import numpy as np

    def fit(im):
        if im.shape[:2] == (size, size):
            return im
        import cv2

        return cv2.resize(im, (size, size))

    return np.stack([fit(im) for im in images]).astype(np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser(description="tpucenterface serving runner")
    p.add_argument("--source", default="synthetic",
                   help="image directory, or 'synthetic' (N random images)")
    p.add_argument("--weights", default=None, help=".safetensors or torch .pth")
    p.add_argument("--n-synthetic", type=int, default=256)
    p.add_argument("--device-batch", type=int, default=128)
    p.add_argument("--size", type=int, default=None,
                   help="model input size (default: config default)")
    p.add_argument("--thresh", type=float, default=0.35)
    p.add_argument("--int8", action="store_true",
                   help="opt-in W8A8 serving forward (calibrates on the "
                   "first device_batch images; not the parity path)")
    p.add_argument("--int8-dw", action="store_true",
                   help="with --int8: depthwise convs int8 too (per-channel "
                   "activation scales)")
    p.add_argument("--int8-input", action="store_true",
                   help="with --int8: host-quantized staging (the stem's "
                   "u8->s8 table applied during batch assembly by the "
                   "threaded C++ kernel; bit-identical results)")
    p.add_argument("--calib-percentile", type=float, default=None,
                   help="with --int8: clip-calibrate activation scales at "
                   "this percentile of |x| (e.g. 99.9) instead of the max")
    p.add_argument("--max-dets", type=int, default=100,
                   help="serving decode top-K per image (eval default 200); "
                   "0 = detector K")
    p.add_argument("--ladder", default=None,
                   help="comma-separated launch-size ladder, e.g. '32,128' "
                   "(default: {device_batch//4, device_batch})")
    p.add_argument("--scales", default=None,
                   help="persisted activation-scale JSON (skip calibration; "
                   "weights.io.save_quant_scales)")
    p.add_argument("--save-scales", default=None,
                   help="after calibrating, persist the scales here")
    p.add_argument("--qat-steps", type=int, default=0,
                   help="with --int8 calibration: follow PTQ with "
                   "quantization-aware fine-tuning (bias correction and this "
                   "many STE steps on the calibration batch; quant.qat)")
    p.add_argument("--adaround-steps", type=int, default=0,
                   help="with --int8 calibration: learn per-weight rounding "
                   "by layer-wise reconstruction before QAT (quant.adaround; "
                   "reverted unless it improves the end-to-end head-map "
                   "loss); persists through --save-scales + "
                   "--save-qat-params")
    p.add_argument("--weight-bits", type=int, default=8,
                   help="with --int8: weight grid width (8 = W8A8; 4 = W4A8, "
                   "an accuracy and packed-size option; persisted scales are "
                   "self-describing)")
    p.add_argument("--qat-params", default=None,
                   help="persisted fine-tuned serving params (.safetensors "
                   "from --save-qat-params); use with --scales")
    p.add_argument("--save-qat-params", default=None,
                   help="after fine-tuning, persist the serving params here "
                   "(.safetensors; reinstall with --scales + --qat-params)")
    p.add_argument("--packed", default=None,
                   help="load a packed deployment artifact (.npz from "
                   "--save-packed / weights.io.save_packed_weights): implies "
                   "--int8, replaces --scales/--qat-params, self-describing")
    p.add_argument("--save-packed", default=None,
                   help="after quantizing, pack the serving weights into "
                   "one .npz (nibble-packed kernels at --weight-bits<=4; "
                   "weights.io.save_packed_weights)")
    p.add_argument("--out", default=None,
                   help="write one JSON line per image (boxes/scores)")
    p.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = p.parse_args(argv)
    if args.packed and (args.scales or args.qat_params or args.qat_steps
                        or args.adaround_steps):
        p.error("--packed is self-contained; drop --scales/--qat-params/"
                "--qat-steps/--adaround-steps")
    if args.save_packed and not (args.int8 or args.packed):
        p.error("--save-packed requires an int8 serving state (--int8 "
                "calibration/install or --packed)")
    if args.packed:
        args.int8 = True  # the artifact is an int8 serving forward
    if args.int8_input and not args.int8:
        p.error("--int8-input requires --int8 (the LUT is the int8 stem's)")
    if (args.qat_steps or args.adaround_steps) and args.scales:
        p.error("--qat-steps/--adaround-steps need calibration (omit "
                "--scales); reinstall persisted output via --scales + "
                "--qat-params")
    if args.qat_params and not args.scales:
        p.error("--qat-params requires --scales (both halves of the "
                "persisted QAT output)")

    import numpy as np

    from tpucenterface_torch.runtime.serving import ServingRouter
    from tpucenterface_torch.weights import io

    det = load_detector(args.weights, args.device, "serve")
    if args.size:
        det.config = dataclasses.replace(det.config, default_size=args.size)
    if args.source == "synthetic":
        rng = np.random.RandomState(0)
        size = det.config.default_size
        names = [f"synthetic_{i}" for i in range(args.n_synthetic)]
        images = [rng.randint(0, 255, (size, size, 3), np.uint8) for _ in names]
    else:
        import cv2

        names, images = [], []
        for name in sorted(os.listdir(args.source)):
            img = cv2.imread(os.path.join(args.source, name))
            if img is not None:
                names.append(name)
                images.append(img)
    if not images:
        raise SystemExit(f"no readable images in {args.source}")

    if args.packed:
        pk_scales, pk_params = io.load_packed_weights(args.packed)
        det.quantize(scales=pk_scales, quant_params=pk_params)
        print(f"[serve] packed artifact {args.packed}: weight_bits="
              f"{det._quant.weight_bits} int8_dw={det._quant.int8_dw}")
    elif args.int8:
        if args.scales:
            quant_params = None
            if args.qat_params:
                quant_params = io.load_safetensors(args.qat_params)["params"]
            scales = det.quantize(
                scales=io.load_quant_scales(args.scales), int8_dw=args.int8_dw,
                quant_params=quant_params, weight_bits=args.weight_bits,
            )
            print(f"[serve] int8 forward with persisted scales {args.scales}"
                  + (f" + QAT params {args.qat_params}" if args.qat_params else ""))
            if args.save_scales:  # re-export the installed scales
                io.save_quant_scales(scales, args.save_scales)
                print(f"[serve] scales persisted to {args.save_scales}")
        else:
            calib = _calibration_frames(images[: args.device_batch], det.config.default_size)
            scales = det.quantize(calib_images=calib, int8_dw=args.int8_dw,
                                  calib_percentile=args.calib_percentile,
                                  qat_steps=args.qat_steps,
                                  adaround_steps=args.adaround_steps,
                                  weight_bits=args.weight_bits)
            print(f"[serve] int8 forward calibrated on {len(calib)} images"
                  + (" (int8_dw per-channel)" if args.int8_dw else ""))
            if args.adaround_steps:
                r = det.last_adaround_report
                print(f"[serve] adaround: accepted={bool(r['_accepted'])} "
                      f"e2e {r['_e2e_first']:.6f}->{r['_e2e_last']:.6f}")
            if args.qat_steps:
                print(f"[serve] QAT fine-tune: {det.last_qat_metrics}")
            if args.save_scales:
                io.save_quant_scales(scales, args.save_scales)
                print(f"[serve] scales persisted to {args.save_scales}")
            if args.save_qat_params:
                io.save_safetensors(det.quant_variables, args.save_qat_params)
                print(f"[serve] QAT params persisted to {args.save_qat_params}")

    if args.save_packed:
        sz = io.save_packed_weights(det, args.save_packed)
        print(f"[serve] packed artifact -> {args.save_packed} "
              f"({sz['packed_bytes']/1e6:.2f} MB vs {sz['f32_bytes']/1e6:.2f} MB f32)")

    ladder = tuple(int(b) for b in args.ladder.split(",")) if args.ladder else None
    out_f = open(args.out, "w") if args.out else None
    try:
        t0 = time.perf_counter()
        with ServingRouter(
            det,
            device_batch=args.device_batch,
            score_thresh=args.thresh,
            max_dets=args.max_dets or None,
            batch_ladder=ladder,
            int8_input=args.int8_input,
        ) as router:
            futures = [(n, router.submit(im)) for n, im in zip(names, images)]
            n_faces = 0
            for name, fut in futures:
                d = fut.result()
                n_faces += len(d.scores)
                if out_f:
                    out_f.write(json.dumps({
                        "image": name,
                        "boxes": np.round(d.boxes, 2).tolist(),
                        "scores": np.round(d.scores, 4).tolist(),
                    }) + "\n")
            stats = {hw: eng.stats() for hw, eng in router._engines.items()}
        dt = time.perf_counter() - t0
    finally:
        if out_f:
            out_f.close()
    print(json.dumps({
        "images": len(images),
        "faces": n_faces,
        "wall_s": round(dt, 2),
        "img_per_s": round(len(images) / dt, 1),
        "engines": {str(k): v for k, v in stats.items()},
    }))


if __name__ == "__main__":
    main()
