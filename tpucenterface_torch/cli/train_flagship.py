"""Flagship-scale training recipe on the procedural multi-face dataset.

    python -m tpucenterface_torch.cli.train_flagship --workdir runs/flagship

Mirrors `tpucenterface/cli/train_flagship.py`, the recipe behind the
committed flagship weights: the default-width model at 320 on thousands of
crowded multi-scale synth scenes (`data.synth`), through the whole training
stack (threaded loader, piecewise LR drops, EMA weights, gradient clipping,
FrozenBN after a warm-up, a checkpoint and a deliberate mid-run stop and
resume), then the float AP of the live and EMA exports on a held-out split
through the port's `Detector` and `eval.synth_eval.ap_on_records`, written
to `flagship_report.json`. Same arguments as the JAX CLI, and `--device`
(the GPU unless it names another). Rendering the scenes needs `cv2`.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_records(data_dir: str, n_train: int, n_val: int, seed: int,
                  hw_range=(384, 512), min_face: float = 18.0):
    from tpucenterface_torch.data.synth import generate_dataset

    # hw_range caps the scene size so that the smallest faces stay >= 9 px
    # after the 320 letterbox
    train_recs = generate_dataset(
        os.path.join(data_dir, "train"), n_train, seed=seed,
        hw_range=hw_range, min_face=min_face,
    )
    # a disjoint deterministic stream for the held-out split
    val_recs = generate_dataset(
        os.path.join(data_dir, "val"), n_val, seed=seed + 7777,
        hw_range=hw_range, min_face=min_face,
    )
    return train_recs, val_recs


def flagship_train_cfg(args, n_train: int):
    from tpucenterface_torch.config import TrainConfig

    steps_per_epoch = max(1, n_train // args.batch_size)
    total_epochs = max(1, -(-args.steps // steps_per_epoch))
    return TrainConfig(
        input_size=args.input_size,
        batch_size=args.batch_size,
        lr=args.lr,
        # compressed canonical schedule: drops at 60% / 85% of the run
        lr_drops=(
            max(1, int(total_epochs * 0.6)),
            max(2, int(total_epochs * 0.85)),
        ),
        epochs=total_epochs,
        ema_decay=args.ema_decay,
        grad_clip_norm=args.grad_clip,
        max_objs=32,
        freeze_bn_steps=args.freeze_bn,
        with_landmarks=getattr(args, "landmarks", False),
    )


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir", default="runs/flagship")
    p.add_argument("--data-dir", default=None, help="default <workdir>/data")
    p.add_argument("--train-images", type=int, default=2400)
    p.add_argument("--val-images", type=int, default=240)
    p.add_argument("--input-size", type=int, default=320)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--steps", type=int, default=6000)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--hw-min", type=int, default=384)
    p.add_argument("--hw-max", type=int, default=512)
    p.add_argument("--min-face", type=float, default=18.0)
    p.add_argument("--ema-decay", type=float, default=0.999)
    p.add_argument("--grad-clip", type=float, default=5.0)
    # FrozenBN boundary: after this step BatchNorm uses its running averages
    # in training too, so train and eval normalization are the same
    p.add_argument("--freeze-bn", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument(
        "--landmarks", action="store_true",
        help="train the optional 5-point landmark head on the generator's "
        "exact feature coordinates; the report gains a landmark NME row",
    )
    p.add_argument(
        "--resume-split", type=float, default=0.5,
        help="fraction of steps before a deliberate stop+resume (0 = one "
        "uninterrupted run)",
    )
    p.add_argument(
        "--eval-only", action="store_true",
        help="skip training; evaluate the exported weights in workdir",
    )
    p.add_argument("--device", default=None, help="torch device (default: the GPU)")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    data_dir = args.data_dir or os.path.join(args.workdir, "data")
    os.makedirs(args.workdir, exist_ok=True)
    t0 = time.time()
    train_recs, val_recs = build_records(
        data_dir, args.train_images, args.val_images, args.seed,
        hw_range=(args.hw_min, args.hw_max), min_face=args.min_face,
    )
    print(
        f"dataset: {len(train_recs)} train / {len(val_recs)} val scenes "
        f"({time.time() - t0:.0f}s)"
    )

    from tpucenterface_torch.config import ModelConfig

    model_cfg = ModelConfig(with_landmarks=args.landmarks)  # default width
    tcfg = flagship_train_cfg(args, len(train_recs))

    log_path = os.path.join(args.workdir, "log.jsonl")

    def log_fn(step, metrics):
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        with open(log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(
            f"step {step:6d}  loss {metrics.get('loss', float('nan')):.4f}"
            f"  hm {metrics.get('hm_loss', float('nan')):.4f}"
            f"  {metrics.get('imgs_per_sec', 0):.0f} img/s"
        )

    if not args.eval_only:
        from tpucenterface_torch.train.loop import train

        stages = [args.steps]
        if 0 < args.resume_split < 1:
            stages = [int(args.steps * args.resume_split), args.steps]
        for stage_steps in stages:
            print(f"--- training to step {stage_steps} ---")
            train(
                train_recs,
                model_cfg=model_cfg,
                train_cfg=tcfg,
                workdir=args.workdir,
                max_steps=stage_steps,
                ckpt_every=max(500, args.steps // 6),
                log_every=50,
                resume=True,
                log_fn=log_fn,
                seed=args.seed,
                loader_workers=args.workers,
                device=args.device,
            )

    # -- held-out AP, live + EMA weights --
    from tpucenterface_torch.config import DecodeConfig, DetectorConfig
    from tpucenterface_torch.detector import Detector
    from tpucenterface_torch.eval.synth_eval import ap_on_records, landmark_nme

    det_cfg = DetectorConfig(
        model=model_cfg,
        decode=DecodeConfig(max_dets=100),
        default_size=args.input_size,
    )
    report = {
        "steps": args.steps,
        "input_size": args.input_size,
        "train_images": args.train_images,
        "val_images": args.val_images,
        "wall_s": None,
        "ap": {},
    }
    if args.landmarks:
        report["nme"] = {}
    for name in ("model", "model_ema"):
        path = os.path.join(args.workdir, f"{name}.safetensors")
        if not os.path.exists(path):
            continue
        det = Detector.from_safetensors(path, config=det_cfg, device=args.device)
        aps = ap_on_records(det, val_recs, size=args.input_size)
        report["ap"][name] = aps
        print(f"{name}: " + "  ".join(f"{k} {v:.4f}" for k, v in aps.items()))
        if args.landmarks:
            # faces below ~25 px have landmark spacing near the stride-4
            # grid pitch: NME where the metric is meaningful
            nme = landmark_nme(det, val_recs, size=args.input_size, min_side=25.0)
            report["nme"][name] = nme
            print(
                f"{name}: landmark NME {nme['nme']:.4f} "
                f"(match {nme['match_rate']:.3f} of {nme['faces']} faces)"
            )
    report["wall_s"] = time.time() - t0
    with open(os.path.join(args.workdir, "flagship_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report["ap"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
