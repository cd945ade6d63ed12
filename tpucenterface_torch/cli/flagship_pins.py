"""Flagship accuracy-pin table: float against every quantized serving config.

    python -m tpucenterface_torch.cli.flagship_pins --workdir runs/flagship

Mirrors `tpucenterface/cli/flagship_pins.py`, with the same arguments and
`--device` (the GPU unless it names another). On the flagship model's
held-out synthetic val split it measures the WIDER-protocol AP
(`eval.synth_eval.ap_on_records`) of

  float | int8 (per-tensor) | int8_dw | int8_dw+QAT | W4 nearest | W4+AdaRound

each quantized row through `Detector.quantize` on calibration frames from
the train split, and writes the table, the deltas against float and the
QAT and AdaRound reports as JSON. The scenes are rendered and read with
`cv2`.
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
    p.add_argument("--calib", type=int, default=16,
                   help="calibration scenes (from the train split stream)")
    p.add_argument("--qat-steps", type=int, default=60)
    p.add_argument("--adaround-steps", type=int, default=40)
    p.add_argument("--out", default=None,
                   help="default <workdir>/flagship_pins.json")
    p.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = p.parse_args(argv)

    import cv2
    import numpy as np

    from tpucenterface_torch.config import DecodeConfig, DetectorConfig, ModelConfig
    from tpucenterface_torch.data.synth import generate_dataset
    from tpucenterface_torch.detector import Detector
    from tpucenterface_torch.eval.synth_eval import ap_on_records
    from tpucenterface_torch.weights.io import load_safetensors

    data_dir = args.data_dir or os.path.join(args.workdir, "data")
    val_recs = generate_dataset(
        os.path.join(data_dir, "val"), args.val_images, seed=args.seed + 7777,
        hw_range=(args.hw_min, args.hw_max), min_face=args.min_face,
    )
    # calibration frames: train-split scenes resized square to the model
    # size on the host (calibration needs representative statistics, not
    # exact geometry)
    calib_recs = generate_dataset(
        os.path.join(data_dir, "train"), args.calib, seed=args.seed,
        hw_range=(args.hw_min, args.hw_max), min_face=args.min_face,
    )
    size = args.input_size
    calib = np.stack([cv2.resize(cv2.imread(r.path), (size, size)) for r in calib_recs]).astype(np.uint8)

    weights = args.weights or os.path.join(args.workdir, "model_ema.safetensors")
    det_cfg = DetectorConfig(model=ModelConfig(), decode=DecodeConfig(max_dets=100), default_size=size)
    det = Detector(variables=load_safetensors(weights), config=det_cfg, device=args.device)

    def ap():
        return ap_on_records(det, val_recs, size=size)

    table = {}
    table["float"] = ap()
    print("float:", table["float"])

    variants = [
        ("int8", dict()),
        ("int8_dw", dict(int8_dw=True)),
        ("int8_dw_qat", dict(int8_dw=True, qat_steps=args.qat_steps)),
        ("w4_nearest", dict(int8_dw=True, weight_bits=4)),
        ("w4_adaround", dict(int8_dw=True, weight_bits=4, adaround_steps=args.adaround_steps)),
    ]
    extras = {}
    for name, kw in variants:
        det.quantize(calib_images=calib, **kw)
        try:
            table[name] = ap()
            if det.last_qat_metrics is not None and "qat" in name:
                extras[name + "_qat_metrics"] = {k: float(v) for k, v in det.last_qat_metrics.items()}
            if det.last_adaround_report is not None and "adaround" in name:
                rep = det.last_adaround_report
                extras[name + "_adaround_e2e"] = {
                    k: float(v) for k, v in rep.items() if isinstance(v, (int, float))
                }
        finally:
            det.dequantize()
        print(f"{name}:", table[name])

    deltas = {
        name: {k: round(table[name][k] - table["float"][k], 4) for k in table["float"]}
        for name in table if name != "float"
    }
    report = {
        "weights": weights,
        "input_size": size,
        "val_images": args.val_images,
        "ap": table,
        "delta_vs_float": deltas,
        **extras,
    }
    out = args.out or os.path.join(args.workdir, "flagship_pins.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"delta_vs_float": deltas}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
