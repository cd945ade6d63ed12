"""One-command parity report: reference `.pth` -> port + layers + boxes
(+ optional WIDER AP).

    python -m tpucenterface_torch.cli.parity_report --pth ref.pth [--auto-map]

Mirrors `tpucenterface/cli/parity_report.py`, with the same arguments, gates
and exit codes and `--device` (the GPU unless it names another). In order:

1. PORT: load the checkpoint (twin naming contract, or `--auto-map` for
   foreign module names), report the mapping and its ambiguities, and port
   it to JAX-layout variables (`weights.port`).
2. LAYERS: run the torch twin (`weights.torch_twin`, the plain unfolded
   `nn.Conv2d` + `nn.BatchNorm2d` network) and the port's unfolded network
   (`model.centernet.CenterFaceNet` on the ported variables) on one input,
   both in float32 on the device, and report the max-abs difference of each
   module's output, paired by module name through forward hooks, in network
   order. Gate: `--atol` (default 2e-3).
3. BOXES: the product path on sample images (`--images`, or rendered scenes
   of `data.synth.render_scene`): `Detector.detect` (letterbox -> folded,
   fused forward -> decode -> inverse letterbox) against the twin's head
   maps through the same letterbox and the reference decode. Reports the
   share of the top-k matched at IoU > 0.9 and the score deltas. Gate:
   `--min-box-match`.
4. AP: with `--gt-dir` and `--images-root`, the WIDER protocol's AP table
   (optionally flip + multi-scale TTA).

Exit code 0 only if every gate passes. The parity configuration computes in
float32 end to end: on a CUDA device the run turns TF32 off for its
duration. Reading `--images` and rendering the default scenes need `cv2`;
`layer_stage` and `boxes_stage` take scenes from the caller.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from typing import Dict, List

import numpy as np
import torch


@contextlib.contextmanager
def no_tf32():
    """float32 convolutions and matrix products in full float32."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def port_stage(args, cfg):
    """Load and port the checkpoint -> (report, twin-named state_dict, variables)."""
    from tpucenterface_torch.weights.port import propose_name_map, read_checkpoint, variables_from_torch_state

    ckpt = read_checkpoint(args.pth)
    report: Dict = {"mode": "twin-contract", "n_keys": len(ckpt)}
    if args.auto_map:
        prop = propose_name_map(ckpt, cfg)
        report.update(
            mode="auto-map",
            n_mapped=len(prop["mapping"]),
            unmatched_twin=prop["unmatched_twin"],
            unmatched_foreign=prop["unmatched_foreign"],
            ambiguous=[list(p) for p in prop["ambiguous"]],
            complete=prop["complete"],
        )
        if prop["unmatched_twin"]:
            raise SystemExit(f"[parity] auto-map incomplete — unmatched twin keys: {prop['unmatched_twin'][:10]}")
        if prop["ambiguous"] and not args.allow_ambiguous:
            raise SystemExit(
                "[parity] auto-map is order-ambiguous (same-signature "
                "units); verify the foreign net registers modules in "
                "data-flow order, then pass --allow-ambiguous:\n  "
                + "\n  ".join(f"{a} <-> {b}" for a, b in prop["ambiguous"][:10])
            )
        sd = {prop["mapping"][k]: v for k, v in ckpt.items() if k in prop["mapping"]}
    else:
        sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in ckpt.items()}
    return report, sd, variables_from_torch_state(sd, cfg)


def _hooked_outputs(net: torch.nn.Module, run, nhwc=()):
    """Run `run()` with a forward hook on every named submodule -> ({name:
    NHWC float64 numpy output}, names in the order their outputs came).
    Modules whose outputs are not one tensor are skipped; 4-D outputs are
    taken as NCHW and transposed, except those of the module types in
    `nhwc`."""
    acts: Dict[str, np.ndarray] = {}
    order: List[str] = []
    hooks = []
    for name, mod in net.named_modules():
        if not name:
            continue

        def hook(m, inp, out, name=name):
            if isinstance(out, torch.Tensor):
                if name not in acts:
                    order.append(name)
                a = out.detach().float().cpu().numpy()
                if a.ndim == 4 and not isinstance(m, nhwc):
                    a = a.transpose(0, 2, 3, 1)
                acts[name] = a.astype(np.float64)

        hooks.append(mod.register_forward_hook(hook))
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hooks:
            h.remove()
    return acts, order


def layer_stage(cfg, sd, variables, size: int, atol: float, device="cpu"):
    """Per-layer output differences, torch twin against the port's unfolded
    network on the ported variables, both float32 on `device`, on one
    uniform [-1, 1) input -> (report, twin)."""
    from tpucenterface_torch.model.centernet import CenterFaceNet
    from tpucenterface_torch.model.heads import Head
    from tpucenterface_torch.weights.convert import state_dict_from_variables
    from tpucenterface_torch.weights.torch_twin import TorchCenterFace

    if cfg.compute_dtype != "float32":
        raise ValueError("the layer stage compares float32 networks")
    dev = torch.device(device)
    twin = TorchCenterFace(cfg).eval()
    own = twin.state_dict()
    twin.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items() if k in own}, strict=False)
    twin.to(dev)
    net = CenterFaceNet(cfg).eval()
    net.load_state_dict(state_dict_from_variables(variables), strict=True)
    net.to(dev)

    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.rand(1, size, size, 3).astype(np.float32) * 2.0) - 1.0).to(dev)
    t_acts, order = _hooked_outputs(twin, lambda: twin(x.permute(0, 3, 1, 2)))
    p_acts, _ = _hooked_outputs(net, lambda: net(x), nhwc=(Head,))

    rows = []
    worst = 0.0
    for name in order:
        if name not in p_acts:
            continue
        t, p = t_acts[name], p_acts[name]
        if t.shape != p.shape:
            rows.append({"layer": name, "max_abs_diff": None, "note": f"shape {t.shape} vs {p.shape}"})
            continue
        d = float(np.abs(p - t).max())
        worst = d if d != d else max(worst, d)  # a NaN stays and fails the gate
        rows.append({"layer": name, "max_abs_diff": round(d, 8)})
    return {
        "input_size": size,
        "n_layers_compared": sum(r["max_abs_diff"] is not None for r in rows),
        "worst_abs_diff": worst,
        "atol": atol,
        "pass": worst <= atol and bool(rows),
        "layers": rows,
    }, twin


def boxes_stage(det, twin, images, size: int, k: int = 20):
    """Product-path boxes against twin + reference-decode boxes per image;
    the twin runs on the Detector's device."""
    from tpucenterface_torch.decode.reference import boxes_to_original, decode_feats_with_idx
    from tpucenterface_torch.eval.wider_eval import bbox_overlaps
    from tpucenterface_torch.preprocess import letterbox_normalize_batch

    dev = det.device
    twin = twin.to(dev)
    per_image = []
    for img in images:
        h, w = img.shape[:2]
        ours = det.detect(img, score_thresh=-1.0, size=size)

        hw = torch.tensor([[h, w]], dtype=torch.int32, device=dev)
        with torch.no_grad():
            x, scales, pads = letterbox_normalize_batch(
                torch.from_numpy(np.ascontiguousarray(img[None])).to(dev), hw, size, det.config.preprocess, raw=False
            )
            t_out = twin(x.float().permute(0, 3, 1, 2))
            feats = {kk: v.permute(0, 2, 3, 1) for kk, v in t_out.items()}
            boxes, scores, _ = decode_feats_with_idx(feats, det.config.decode)
            boxes = boxes_to_original(boxes, scales, pads, hw)
        ref_b = boxes[0].cpu().numpy()
        ref_s = scores[0].cpu().numpy()

        kk = min(k, len(ref_s), len(ours.scores))
        a, b = ours.boxes[:kk], ref_b[:kk]
        # greedy best-IoU pairing (the top-k order may differ on near-ties)
        iou = bbox_overlaps(a.astype(np.float64), b.astype(np.float64))
        matched = 0
        score_d = 0.0
        used = set()
        for i in range(kk):
            j = int(np.argmax(iou[i]))
            if iou[i, j] > 0.9 and j not in used:
                used.add(j)
                matched += 1
                score_d = max(score_d, abs(float(ours.scores[i]) - float(ref_s[j])))
        per_image.append({
            "hw": [h, w],
            "topk": kk,
            "match_frac": round(matched / max(kk, 1), 4),
            "max_score_delta_matched": round(score_d, 6),
        })
    worst = min((r["match_frac"] for r in per_image), default=0.0)
    return {"images": per_image, "worst_match_frac": worst}


def _sample_images(paths):
    if paths:
        import cv2

        images = []
        for path in paths:
            img = cv2.imread(path)
            if img is None:
                raise SystemExit(f"[parity] cannot read {path}")
            images.append(img)
        return images
    from tpucenterface_torch.data.synth import render_scene

    return [render_scene(np.random.RandomState(100 + i), (360, 480))[0] for i in range(4)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Reference-checkpoint parity report (port + layers + boxes + optional WIDER AP)"
    )
    p.add_argument("--pth", required=True, help="reference .pth checkpoint")
    p.add_argument("--width-mult", type=float, default=1.0)
    p.add_argument("--with-landmarks", action="store_true")
    p.add_argument("--auto-map", action="store_true",
                   help="foreign module names: align by shape/order")
    p.add_argument("--allow-ambiguous", action="store_true")
    p.add_argument("--size", type=int, default=320,
                   help="model input size for the layer/boxes stages")
    p.add_argument("--atol", type=float, default=2e-3,
                   help="per-layer activation gate (head-map units)")
    p.add_argument("--min-box-match", type=float, default=0.9,
                   help="boxes-stage gate: min greedy-IoU>0.9 match "
                   "fraction over the top-k")
    p.add_argument("--images", nargs="*", default=None,
                   help="sample images for the boxes stage (default: 4 "
                   "rendered multi-face scenes)")
    p.add_argument("--gt-dir", default=None,
                   help="WIDER eval_tools ground_truth dir -> adds AP stage")
    p.add_argument("--images-root", default=None, help="WIDER_val/images")
    p.add_argument("--tta", action="store_true", help="AP stage: flip + multi-scale TTA")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--out", default=None, help="write the JSON report here")
    p.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = p.parse_args(argv)

    from tpucenterface_torch.config import DetectorConfig, ModelConfig, resolve_device
    from tpucenterface_torch.detector import Detector

    dev = resolve_device(args.device)
    # float32 end to end: the parity configuration
    cfg = ModelConfig(compute_dtype="float32", width_mult=args.width_mult, with_landmarks=args.with_landmarks)
    report: Dict = {}
    with no_tf32():
        report["port"], sd, variables = port_stage(args, cfg)
        print(f"[parity] port: {report['port']['mode']}, "
              f"{report['port'].get('n_mapped', report['port']['n_keys'])} keys"
              + (", AMBIGUOUS units accepted" if report["port"].get("ambiguous") else ""))

        report["layers"], twin = layer_stage(cfg, sd, variables, args.size, args.atol, device=dev)
        print(f"[parity] layers: {report['layers']['n_layers_compared']} compared,"
              f" worst |diff| {report['layers']['worst_abs_diff']:.2e}"
              f" (atol {args.atol:g})"
              f" -> {'PASS' if report['layers']['pass'] else 'FAIL'}")

        det = Detector(variables=variables, config=DetectorConfig(model=cfg, default_size=args.size), device=dev)
        images = _sample_images(args.images)
        report["boxes"] = boxes_stage(det, twin, images, args.size)
        report["boxes"]["min_box_match"] = args.min_box_match
        report["boxes"]["pass"] = report["boxes"]["worst_match_frac"] >= args.min_box_match
        print(f"[parity] boxes: worst top-k match {report['boxes']['worst_match_frac']:.3f}"
              f" over {len(images)} images"
              f" -> {'PASS' if report['boxes']['pass'] else 'FAIL'}")

        if args.gt_dir and args.images_root:
            from tpucenterface_torch.eval.batch_runner import batched_detect, batched_detect_tta
            from tpucenterface_torch.eval.wider_eval import evaluate_wider

            run = batched_detect_tta if args.tta else batched_detect
            aps = evaluate_wider(
                None, args.gt_dir, args.images_root, max_images=args.max_images,
                batch_det_fn=lambda imgs: run(det, imgs, score_thresh=0.01),
            )
            report["ap"] = {k: round(float(v), 4) for k, v in aps.items()}
            print("[parity] AP: " + "  ".join(f"{k} {v:.4f}" for k, v in report["ap"].items()))

    ok = report["layers"]["pass"] and report["boxes"]["pass"]
    report["pass"] = ok
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"[parity] report -> {args.out}")
    print(f"[parity] overall: {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
