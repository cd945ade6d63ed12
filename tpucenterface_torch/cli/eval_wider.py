"""WIDER FACE val evaluation CLI.

    python -m tpucenterface_torch.cli.eval_wider --gt-dir eval_tools/ground_truth \\
        --images-root WIDER_val/images --weights w.pth

Mirrors `tpucenterface/cli/eval_wider.py`, with the same arguments and
`--device` (the GPU unless it names another): bucketed batches with the
in-program flip (`eval.batch_runner`) or `--per-image` calls, `--tta`, the
int8 forward (`--int8`, `--int8-dw`, `--weight-bits`, `--quant-scales`), and
`--out-dets` through `data.wider.write_wider_detections`. Prints the AP per
difficulty as one JSON line. Images are read with `cv2`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os


def _calibration_frames(gt_dir, images_root, size, n=8):
    """The first `n` readable eval images of the easy split, resized to the
    model size."""
    import cv2
    import numpy as np

    from tpucenterface_torch.eval.wider_eval import load_wider_gt

    gt = load_wider_gt(gt_dir)["easy"]
    calib = []
    for ev, fs in zip(gt["events"], gt["files"]):
        for f in fs:
            img = cv2.imread(os.path.join(images_root, ev, f + ".jpg"))
            if img is not None:
                calib.append(cv2.resize(img, (size, size)))
            if len(calib) >= n:
                return np.stack(calib).astype(np.uint8)
    if not calib:
        raise SystemExit("[eval] --int8: no calibration images found")
    return np.stack(calib).astype(np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser(description="WIDER val AP evaluation")
    p.add_argument("--gt-dir", required=True,
                   help="eval_tools ground_truth dir with wider_face_val.mat etc.")
    p.add_argument("--images-root", required=True, help="WIDER_val/images")
    p.add_argument("--weights", default=None)
    p.add_argument("--tta", action="store_true", help="flip + multi-scale TTA")
    p.add_argument("--scales", default="0.5,1.0,1.5",
                   help="TTA scale multipliers (with --tta)")
    p.add_argument("--thresh", type=float, default=0.01)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--out-dets", default=None,
                   help="also dump WIDER-format detection txts here")
    p.add_argument("--per-image", action="store_true",
                   help="one call per image (default: bucketed batches with "
                   "the in-program flip)")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--size", type=int, default=None,
                   help="model input size (default: config default, 640)")
    p.add_argument("--int8", action="store_true",
                   help="evaluate the W8A8 serving forward's AP (calibrates "
                   "on the first 8 eval images unless --quant-scales)")
    p.add_argument("--int8-dw", action="store_true",
                   help="with --int8: per-channel int8 depthwise")
    p.add_argument("--weight-bits", type=int, default=8,
                   help="with --int8: weight grid width (8 = W8A8; 4 = W4A8)")
    p.add_argument("--quant-scales", default=None,
                   help="persisted activation-scale JSON "
                   "(weights.io.save_quant_scales) instead of calibrating")
    p.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = p.parse_args(argv)
    if args.int8_dw and not args.int8:
        p.error("--int8-dw requires --int8")

    from tpucenterface_torch.cli.serve import load_detector
    from tpucenterface_torch.eval.batch_runner import batched_detect, batched_detect_tta
    from tpucenterface_torch.eval.tta import detect_tta
    from tpucenterface_torch.eval.wider_eval import evaluate_wider

    det = load_detector(args.weights, args.device, "eval")
    if args.size:
        det.config = dataclasses.replace(det.config, default_size=args.size)

    if args.int8:
        if args.quant_scales:
            from tpucenterface_torch.weights.io import load_quant_scales

            det.quantize(scales=load_quant_scales(args.quant_scales), int8_dw=args.int8_dw,
                         weight_bits=args.weight_bits)
            print("[eval] int8 forward with persisted scales")
        else:
            calib = _calibration_frames(args.gt_dir, args.images_root, det.config.default_size)
            det.quantize(calib_images=calib, int8_dw=args.int8_dw, weight_bits=args.weight_bits)
            print(f"[eval] int8 forward calibrated on {len(calib)} eval images")

    scales = tuple(float(s) for s in args.scales.split(",")) if args.tta else (1.0,)

    def det_fn(img):
        if args.tta:
            return detect_tta(det, img, scales=scales, flip=True, score_thresh=args.thresh)
        return det.detect(img, score_thresh=args.thresh)[:2]

    def batch_det_fn(imgs):
        if args.tta:
            return batched_detect_tta(det, imgs, scales=scales, flip=True, score_thresh=args.thresh,
                                      batch_size=args.batch_size)
        return batched_detect(det, imgs, score_thresh=args.thresh, batch_size=args.batch_size)

    on_det = None
    if args.out_dets:
        from tpucenterface_torch.data.wider import write_wider_detections

        def on_det(rel, boxes, scores):
            write_wider_detections(args.out_dets, rel, boxes, scores)

    aps = evaluate_wider(
        det_fn if args.per_image else None,
        args.gt_dir,
        args.images_root,
        max_images=args.max_images,
        on_detection=on_det,
        batch_det_fn=None if args.per_image else batch_det_fn,
    )
    print(json.dumps({f"AP_{k}": round(v, 4) for k, v in aps.items()}))


if __name__ == "__main__":
    main()
