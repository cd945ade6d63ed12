"""Training CLI: `python -m tpucenterface_torch.cli.train --wider-root DIR`.

Mirrors `tpucenterface/cli/train.py`, with the same arguments and `--device`
(the GPU unless it names another, e.g. `--device cpu`). The data pipeline
decodes and warps with `cv2`. Data-parallel: start one process per card with
TPUCF_COORDINATOR=host:port, TPUCF_NUM_PROCS and TPUCF_PROC_ID set (or
TPUCF_MULTIHOST=1 and torch's own variables); each joins the process group
(`runtime.sharding.maybe_init_distributed`) and trains its rows of every
global batch; with `--device cpu` the group runs on gloo."""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="Train tpucenterface on WIDER FACE")
    p.add_argument("--wider-root", required=True,
                   help="dir containing WIDER_train/images and the bbx_gt txt")
    p.add_argument("--gt-file", default=None,
                   help="default: <root>/wider_face_split/wider_face_train_bbx_gt.txt")
    p.add_argument("--workdir", default="runs/train")
    p.add_argument("--input-size", type=int, default=640)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=140)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--n-devices", type=int, default=None)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--wh-log", action="store_true")
    p.add_argument("--workers", type=int, default=4,
                   help="loader threads decoding/augmenting ahead; NOTE: "
                   "workers>0 uses per-sample RNG streams, so the sample "
                   "order/augments differ from --workers 0 at equal seed")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="EMA of params inside the step (e.g. 0.9998);"
                   " exports model_ema.safetensors next to the live weights")
    p.add_argument("--grad-clip", type=float, default=0.0,
                   help="global-norm gradient clip ahead of Adam (0 = off)")
    p.add_argument("--bf16-bn", action="store_true",
                   help="bf16 BatchNorm activations (the statistics stay f32)")
    p.add_argument("--gt-format", choices=("bbx", "retinaface"), default="bbx",
                   help="annotation format: the official bbx_gt txt, or the "
                   "RetinaFace-distribution label.txt (carries 5-point "
                   "landmarks; default path <root>/WIDER_train/label.txt)")
    p.add_argument("--landmarks", action="store_true",
                   help="train the optional 5-point landmark head (needs "
                   "--gt-format retinaface for real landmark GT; records "
                   "without landmarks still train boxes)")
    p.add_argument("--freeze-bn", type=int, default=0,
                   help="freeze BN to running averages after this step "
                   "(0 = never; the flagship recipe uses 500)")
    p.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = p.parse_args(argv)

    import torch

    from tpucenterface_torch.config import ModelConfig, TrainConfig
    from tpucenterface_torch.data.wider import parse_bbx_gt, parse_retinaface_gt
    from tpucenterface_torch.runtime.sharding import maybe_init_distributed
    from tpucenterface_torch.train.loop import train

    # a no-op unless the TPUCF_* variables ask for a group: NCCL, or gloo
    # when the run is asked onto the CPU
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    maybe_init_distributed(backend="gloo" if cpu else None)

    images = os.path.join(args.wider_root, "WIDER_train", "images")
    if args.gt_format == "retinaface":
        gt = args.gt_file or os.path.join(
            args.wider_root, "WIDER_train", "label.txt"
        )
        records = parse_retinaface_gt(gt, images)
    else:
        gt = args.gt_file or os.path.join(
            args.wider_root, "wider_face_split", "wider_face_train_bbx_gt.txt"
        )
        records = parse_bbx_gt(gt, images)
    print(f"[train] {len(records)} images")

    tcfg = TrainConfig(
        input_size=args.input_size,
        batch_size=args.batch_size,
        epochs=args.epochs,
        lr=args.lr,
        ema_decay=args.ema_decay,
        grad_clip_norm=args.grad_clip,
        freeze_bn_steps=args.freeze_bn,
        with_landmarks=args.landmarks,
    )

    def log(step, m):
        print(f"[step {step}] " + json.dumps({k: round(v, 4) for k, v in m.items()}))

    train(
        records,
        model_cfg=ModelConfig(
            bn_compute_dtype="bfloat16" if args.bf16_bn else "float32",
            with_landmarks=args.landmarks,
        ),
        train_cfg=tcfg,
        workdir=args.workdir,
        n_devices=args.n_devices,
        max_steps=args.max_steps,
        resume=not args.no_resume,
        log_fn=log,
        wh_log=args.wh_log,
        loader_workers=args.workers,
        device=args.device,
    )


if __name__ == "__main__":
    main()
