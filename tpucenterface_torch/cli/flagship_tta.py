"""TTA accuracy on the flagship model: single vs flip vs flip + multi-scale.

    python -m tpucenterface_torch.cli.flagship_tta --workdir runs/flagship

Mirrors `tpucenterface/cli/flagship_tta.py`, with the same arguments and
`--device` (the GPU unless it names another). On the trained model's
held-out synthetic val split (rendered with `data.synth.generate_dataset`,
which needs `cv2`), it measures the WIDER-protocol AP of single-scale detect
at `--input-size`, flip TTA and flip + multi-scale TTA
(`eval.synth_eval.ap_on_records` and `ap_on_records_tta`, the eval path's
bucketed batches with the in-program flip), with `--landmarks` the landmark
error of single-scale and TTA detect, and writes the table as JSON.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir", default="runs/flagship")
    p.add_argument("--weights", default=None,
                   help="default <workdir>/model_ema.safetensors")
    p.add_argument("--data-dir", default=None, help="default <workdir>/data")
    p.add_argument("--val-images", type=int, default=240)
    p.add_argument("--seed", type=int, default=0,
                   help="must match the training run (val split = seed+7777)")
    p.add_argument("--input-size", type=int, default=320)
    p.add_argument("--hw-min", type=int, default=384)
    p.add_argument("--hw-max", type=int, default=512)
    p.add_argument("--min-face", type=float, default=18.0)
    # scale 0.7 maps the 384-512 scenes mostly onto the trained 320 bucket;
    # 1.0 runs near-native resolution (the small-face recovery scale)
    p.add_argument("--scales", type=float, nargs="+", default=[0.7, 1.0])
    p.add_argument("--out", default=None,
                   help="default <workdir>/flagship_tta.json")
    p.add_argument("--landmarks", action="store_true",
                   help="weights carry the 5-point landmark head: the report "
                   "gains single-scale and TTA landmark-NME rows")
    p.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = p.parse_args(argv)

    from tpucenterface_torch.config import DecodeConfig, DetectorConfig, ModelConfig
    from tpucenterface_torch.data.synth import generate_dataset
    from tpucenterface_torch.detector import Detector
    from tpucenterface_torch.eval.synth_eval import ap_on_records, ap_on_records_tta, landmark_nme
    from tpucenterface_torch.weights.io import load_safetensors

    data_dir = args.data_dir or os.path.join(args.workdir, "data")
    val_recs = generate_dataset(
        os.path.join(data_dir, "val"), args.val_images, seed=args.seed + 7777,
        hw_range=(args.hw_min, args.hw_max), min_face=args.min_face,
    )
    weights = args.weights or os.path.join(args.workdir, "model_ema.safetensors")
    det = Detector(
        variables=load_safetensors(weights),
        config=DetectorConfig(
            model=ModelConfig(with_landmarks=args.landmarks),
            decode=DecodeConfig(max_dets=100),
            default_size=args.input_size,
        ),
        device=args.device,
    )

    table = {}
    table["single"] = ap_on_records(det, val_recs, size=args.input_size)
    print("single:", table["single"])
    table["flip"] = ap_on_records_tta(det, val_recs, scales=args.scales[:1], flip=True)
    print("flip:", table["flip"])
    table["flip_multiscale"] = ap_on_records_tta(det, val_recs, scales=args.scales, flip=True)
    print("flip_multiscale:", table["flip_multiscale"])

    report = {
        "weights": weights,
        "val_images": args.val_images,
        "input_size": args.input_size,
        "scales": list(args.scales),
        "ap": table,
    }
    if args.landmarks:
        # faces below ~25 px have landmark spacing near the stride-4 grid
        # pitch: the eligibility floor of train_flagship's NME row
        nme = {
            "single": landmark_nme(det, val_recs, size=args.input_size, min_side=25.0),
            "flip_multiscale": landmark_nme(det, val_recs, tta=True, scales=args.scales, min_side=25.0),
        }
        report["nme"] = nme
        print("nme:", json.dumps(nme))
    out = args.out or os.path.join(args.workdir, "flagship_tta.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(table))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
