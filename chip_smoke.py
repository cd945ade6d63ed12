#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`tpucenterface_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one card

Phases, in order; any failure raises and the script exits non-zero:
1. device: require CUDA; print the card's name and power limit (nvidia-smi);
2. build: compile the CUDA source of the path (`csrc/decode.cu`) with nvcc
   into build/kernels/;
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, at the shapes the main path gives it and on tie-heavy inputs;
4. main path: `Detector.detect_batch` / `detect` on the flagship weights
   (artifacts/flagship.safetensors) with the fused decode kernel, at batch 32
   and 640x640, on odd image sizes, and at the flagship's own 320 against
   the port's CPU run; every kernel's launch count must rise;
5. times with CUDA events (median after warm-up), and a torch.profiler
   summary of one bs32@640 batch (device busy share, top device ops).

The images are procedural faces painted with numpy from a seed; the run
checks that the detector finds them. The last two lines are the
`{"kernels": [...]}` record and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "artifacts", "flagship.safetensors")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 non-tensor FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# The kernel's contract (tests/test_pallas_decode.py): indices equal.
SCORE_ATOL = 1e-6
BOX_ATOL = 1e-4
# Card against the port's CPU run at 320, both bfloat16: the bound the CPU
# tests state for port-against-JAX bfloat16 (tests/test_torch_detector.py).
BF16_BOX_ATOL, BF16_SCORE_ATOL, BF16_FIRM = 2.0, 0.03, 0.1


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------- #
# images: procedural faces, numpy only
# --------------------------------------------------------------------------- #

_SKIN_BGR = np.array(
    [(140, 170, 220), (120, 160, 210), (100, 140, 190), (80, 115, 165), (60, 90, 135), (45, 70, 105)],
    np.float32,
)


def _ellipse(img, cx, cy, ax, ay, color):
    h, w = img.shape[:2]
    y0, y1 = max(0, int(cy - ay) - 1), min(h, int(cy + ay) + 2)
    x0, x1 = max(0, int(cx - ax) - 1), min(w, int(cx + ax) + 2)
    if y1 <= y0 or x1 <= x0:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
    inside = ((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2 <= 1.0
    img[y0:y1, x0:x1][inside] = color


def paint_scene(rng, hw, n_faces):
    """(uint8 BGR image, (N, 4) xyxy face boxes): a noisy gradient with
    non-overlapping cartoon faces (head, eyes, brows, nose, mouth)."""
    h, w = hw
    g0, g1 = rng.uniform(20, 160, 3), rng.uniform(20, 160, 3)
    ramp = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    img = np.broadcast_to(g0 * (1 - ramp) + g1 * ramp, (h, w, 3)).astype(np.float32)
    img = img + rng.normal(0, 6, (h, w, 3)).astype(np.float32)
    boxes = []
    for _ in range(50 * n_faces):
        if len(boxes) == n_faces:
            break
        size = float(np.exp(rng.uniform(np.log(24), np.log(0.4 * min(h, w)))))
        h2 = size / 2
        w2 = h2 * rng.uniform(0.68, 0.82)
        cx = rng.uniform(w2 + 2, w - w2 - 2)
        cy = rng.uniform(h2 + 2, h - h2 - 2)
        box = (cx - w2, cy - h2, cx + w2, cy + h2)
        if any(box[0] < b[2] + 4 and b[0] < box[2] + 4 and box[1] < b[3] + 4 and b[1] < box[3] + 4 for b in boxes):
            continue
        tone = np.clip(_SKIN_BGR[rng.randint(len(_SKIN_BGR))] * rng.uniform(0.85, 1.15, 3), 0, 255)
        _ellipse(img, cx, cy, w2, h2, tone)
        dark = rng.uniform(10, 60, 3)
        for sx in (-0.38, 0.38):
            ex, ey, er = cx + sx * w2, cy - 0.18 * h2, max(1.0, 0.11 * h2)
            _ellipse(img, ex, ey, er, er * 0.62, np.clip(tone * 1.35 + 40, 0, 255))
            _ellipse(img, ex, ey, er * 0.5, er * 0.5, dark)
            _ellipse(img, ex, cy - 0.38 * h2, er, max(1.0, er * 0.3), dark * 0.8)
        _ellipse(img, cx, cy + 0.04 * h2, max(1.0, 0.05 * h2), 0.09 * h2, tone * 0.75)
        mouth = (rng.uniform(30, 70), rng.uniform(20, 60), rng.uniform(90, 180))
        _ellipse(img, cx, cy + 0.48 * h2, 0.26 * h2, max(1.0, 0.07 * h2), mouth)
        boxes.append(box)
    return np.clip(img, 0, 255).astype(np.uint8), np.array(boxes, np.float32).reshape(-1, 4)


def paint_batch(seed, n, hw, faces=4):
    rng = np.random.RandomState(seed)
    scenes = [paint_scene(rng, hw, faces) for _ in range(n)]
    return np.stack([s[0] for s in scenes]), [s[1] for s in scenes]


def iou(a, b):
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter)


# --------------------------------------------------------------------------- #
# timing
# --------------------------------------------------------------------------- #


def cuda_times(fn, iters, warmup=3):
    """Milliseconds of each of `iters` calls of `fn()`, each between two
    CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms(fn, iters, warmup=3):
    """Median milliseconds of `fn()` (see `cuda_times`)."""
    return float(np.median(cuda_times(fn, iters, warmup)))


def device_profile(fn, iters=3):
    """torch.profiler over `iters` calls of `fn()`: the device's busy share
    of the wall time and the device time of the top operators."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    # the events that ran on the device (kernels, copies, memsets): their
    # self times sum to the busy time, as kernels of one stream do not overlap
    busy_us, top = 0.0, {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("Activity Buffer"):
            continue
        dev_us = ev.self_device_time_total
        top[ev.key[:80]] = dev_us / iters / 1e3
        busy_us += dev_us
    busy_ms = busy_us / iters / 1e3
    top = dict(sorted(top.items(), key=lambda kv: -kv[1])[:12])
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms > 0 else None,
        "top_device_ms": top,
    }


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    # float32 references run in full float32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(smi)
    return smi


def phase_build():
    from tpucenterface_torch.kernels import build

    t0 = time.perf_counter()
    build.load("decode")
    log(f"[build] csrc/decode.cu built and loaded in {time.perf_counter() - t0:.1f} s")


def _fused_feats(hm, wh, off):
    """hm/wh/off as the port's fused heads give them: strided views of one
    (B, H, W, 5) float32 map, plus the contiguous wh+off view."""
    y = torch.cat([hm, wh, off], dim=-1).contiguous()
    return {"hm": y[..., 0:1], "wh": y[..., 1:3], "off": y[..., 3:5], "whoff": y[..., 1:5]}


def _random_feats(gen, b, h, w, dev):
    hm = 3.0 * torch.randn(b, h, w, 1, generator=gen)
    wh = 6.0 * torch.rand(b, h, w, 2, generator=gen)
    off = torch.rand(b, h, w, 2, generator=gen) - 0.5
    return _fused_feats(hm.to(dev), wh.to(dev), off.to(dev))


def _sparse_feats(gen, b, h, w, dev):
    """A flat -8 plateau with a few real peaks and plateaus of equal logits:
    every K slot after the peaks is decided by the lowest-index tie rule."""
    hm = torch.full((b, h, w, 1), -8.0)
    for i in range(b):
        ys = torch.randint(0, h, (6,), generator=gen)
        xs = torch.randint(0, w, (6,), generator=gen)
        for j, (y, x) in enumerate(zip(ys.tolist(), xs.tolist())):
            hm[i, y, x, 0] = 4.0 - 0.5 * j
        y0, x0 = (h // 3 + i) % (h - 3), (w // 2 + 2 * i) % (w - 4)
        hm[i, y0 : y0 + 3, x0 : x0 + 4, 0] = 1.5  # a tied plateau
    wh = 4.0 * torch.rand(b, h, w, 2, generator=gen) - 0.5  # some negative sizes
    off = torch.rand(b, h, w, 2, generator=gen) - 0.5
    return _fused_feats(hm.to(dev), wh.to(dev), off.to(dev))


def phase_kernels(det_feats):
    """decode_feats_fused (CUDA) against decode_feats_fused_plain on the card.
    Returns the largest error seen."""
    from tpucenterface_torch.config import DecodeConfig
    from tpucenterface_torch.decode.fused_decode import decode_feats_fused, decode_feats_fused_plain

    dev = det_feats["hm"].device
    gen = torch.Generator().manual_seed(1234)
    cases = [
        ("main-path heads bs32@640", det_feats, DecodeConfig(max_dets=200)),
        ("random 3*randn (32,160,160)", _random_feats(gen, 32, 160, 160, dev), DecodeConfig(max_dets=200)),
        ("sparse+plateaus (8,160,160)", _sparse_feats(gen, 8, 160, 160, dev), DecodeConfig(max_dets=200)),
        ("wh_log (32,160,160)", _random_feats(gen, 32, 160, 160, dev), DecodeConfig(max_dets=200, wh_log=True)),
        ("1024 bucket (2,256,256)", _random_feats(gen, 2, 256, 256, dev), DecodeConfig(max_dets=200)),
        ("K > H*W (3,7,9)", _random_feats(gen, 3, 7, 9, dev), DecodeConfig(max_dets=200)),
        ("separate heads (4,40,40)", {k: v.contiguous() for k, v in _random_feats(gen, 4, 40, 40, dev).items()
                                      if k != "whoff"}, DecodeConfig(max_dets=100)),
    ]
    worst = 0.0
    for name, feats, cfg in cases:
        kb, ks, ki = decode_feats_fused(feats, cfg)
        pb, ps, pi = decode_feats_fused_plain(feats, cfg)
        torch.cuda.synchronize()
        if not torch.equal(ki, pi):
            bad = (ki != pi).nonzero()[:5].tolist()
            raise AssertionError(f"[kernels] {name}: indices differ at {bad}")
        es = (ks - ps).abs().max().item()
        eb = (kb - pb).abs().max().item()
        log(f"[kernels] decode {name}: K={ks.shape[1]} indices equal, "
            f"max |score err| {es:.3g} (atol {SCORE_ATOL}), max |box err| {eb:.3g} (atol {BOX_ATOL})")
        if not (es <= SCORE_ATOL and eb <= BOX_ATOL):
            raise AssertionError(f"[kernels] {name}: errors {es}, {eb} over the limits")
        worst = max(worst, es, eb)
    return worst


def match_detections(a_det, b_det, box_atol, score_atol, firm):
    """Every detection of either side scoring >= `firm` finds one on the
    other side with all box corners within `box_atol` px and the score
    within `score_atol`."""
    for a, b in ((a_det, b_det), (b_det, a_det)):
        sel = a.scores >= firm
        if not sel.any():
            continue
        if not len(b.scores):
            raise AssertionError(f"no detections to match {a.scores[sel]}")
        dist = np.abs(a.boxes[sel][:, None, :] - b.boxes[None, :, :]).max(axis=-1)
        close = np.abs(a.scores[sel][:, None] - b.scores[None, :]) <= score_atol
        ok = ((dist <= box_atol) & close).any(axis=1)
        if not ok.all():
            raise AssertionError(f"unmatched {a.boxes[sel][~ok]} scores {a.scores[sel][~ok]}")


def check_result(dets, gts, hws, what):
    """Finite, in bounds, and the painted faces found (IoU >= 0.5, score
    >= 0.3) for at least 90% of them."""
    found = total = 0
    for d, g, (h, w) in zip(dets, gts, hws):
        if not (np.isfinite(d.boxes).all() and np.isfinite(d.scores).all()):
            raise AssertionError(f"[main] {what}: non-finite output")
        if d.boxes.shape != (len(d.scores), 4) or (np.diff(d.scores) > 0).any():
            raise AssertionError(f"[main] {what}: bad shapes or unsorted scores")
        if (d.boxes < 0).any() or (d.boxes[:, 0::2] > w).any() or (d.boxes[:, 1::2] > h).any():
            raise AssertionError(f"[main] {what}: boxes outside the {h}x{w} image")
        strong = d.boxes[d.scores >= 0.3]
        total += len(g)
        if len(g) and len(strong):
            found += int((iou(g, strong).max(axis=1) >= 0.5).sum())
    log(f"[main] {what}: {found}/{total} painted faces found (IoU>=0.5, score>=0.3)")
    if found < 0.9 * total:
        raise AssertionError(f"[main] {what}: only {found} of {total} faces found")


def phase_main(det, det320, det_cpu):
    """The detect path, with every launch counter set to 0 just before and
    read just after. Returns the launch counts."""
    from tpucenterface_torch.decode.fused_decode import decode_feats_fused

    b640, g640 = paint_batch(1, 32, (640, 640))
    lb_imgs, lb_gts, lb_hws = letterboxed_batch(2)
    odd = [paint_scene(np.random.RandomState(3), (480, 720), 3), paint_scene(np.random.RandomState(4), (123, 457), 1)]
    s320, g320 = paint_batch(5, 4, (384, 512))

    decode_feats_fused.launches = 0
    calls = 0
    d640 = det.detect_batch(b640, score_thresh=0.05)
    calls += 1
    dlb = det.detect_batch(lb_imgs, hws=lb_hws, score_thresh=0.05)
    calls += 1
    dodd = [det.detect(img, score_thresh=0.05) for img, _ in odd]
    calls += len(odd)
    d320 = det320.detect_batch(s320, score_thresh=0.05)
    calls += 1
    torch.cuda.synchronize()
    launches = {"decode_feats_fused": decode_feats_fused.launches}
    log(f"[main] decode calls {calls}, kernel launches {launches}")
    if launches["decode_feats_fused"] != calls:
        raise AssertionError(f"[main] the fused decode kernel ran {launches} times for {calls} decode calls")

    check_result(d640, g640, [(640, 640)] * 32, "detect_batch bs32 640x640")
    check_result(dlb, lb_gts, lb_hws, "detect_batch bs32 letterboxed to 640")
    check_result(dodd, [g for _, g in odd], [img.shape[:2] for img, _ in odd], "detect 480x720 and 123x457")
    check_result(d320, g320, [(384, 512)] * 4, "detect_batch bs4 at 320")
    ref = det_cpu.detect_batch(s320, score_thresh=0.05)
    n = 0
    for a, b in zip(d320, ref):
        match_detections(a, b, BF16_BOX_ATOL, BF16_SCORE_ATOL, BF16_FIRM)
        n += int((a.scores >= BF16_FIRM).sum())
    log(f"[main] 320: card and CPU agree on {n} detections >= {BF16_FIRM} "
        f"(box {BF16_BOX_ATOL} px, score {BF16_SCORE_ATOL})")
    return launches


def letterboxed_batch(seed):
    """32 images of mixed content sizes zero-padded to one 640x640 bucket:
    the letterbox resize runs for each."""
    rng = np.random.RandomState(seed)
    sizes = [(480, 640), (640, 480), (360, 640), (512, 512)]
    imgs = np.zeros((32, 640, 640, 3), np.uint8)
    gts, hws = [], []
    for i in range(32):
        h, w = sizes[i % len(sizes)]
        img, g = paint_scene(rng, (h, w), 3)
        imgs[i, :h, :w] = img
        gts.append(g)
        hws.append((h, w))
    return imgs, gts, np.array(hws, np.int32)


def phase_times(det, det_feats):
    """End-to-end times (pre-sized and letterboxed bs32@640, single 640),
    where the time goes at bs32@640, and the decode kernel's times at
    bs32@640, K=200."""
    from tpucenterface_torch.config import DecodeConfig
    from tpucenterface_torch.decode.fused_decode import decode_feats_fused, decode_feats_fused_plain
    from tpucenterface_torch.decode.reference import decode_feats_with_idx
    from tpucenterface_torch.preprocess import normalize_images

    before = decode_feats_fused.launches
    b640, _ = paint_batch(6, 32, (640, 640))
    lb_imgs, _, lb_hws = letterboxed_batch(8)
    one, _ = paint_batch(7, 1, (640, 640))
    batch = cuda_times(lambda: det.detect_batch(b640, score_thresh=0.05), iters=20)
    lbox = cuda_times(lambda: det.detect_batch(lb_imgs, hws=lb_hws, score_thresh=0.05), iters=20)
    single = cuda_times(lambda: det.detect(one[0], score_thresh=0.05), iters=100)

    cfg = DecodeConfig(max_dets=200)
    kernel_ms = cuda_ms(lambda: decode_feats_fused(det_feats, cfg), iters=50)
    plain_ms = cuda_ms(lambda: decode_feats_fused_plain(det_feats, cfg), iters=50)
    lib_cfg = DecodeConfig(max_dets=200, fast_topk=True)
    library_ms = cuda_ms(lambda: decode_feats_with_idx(det_feats, lib_cfg), iters=50)

    b, h, w, _ = det_feats["hm"].shape
    k = cfg.max_dets
    # least work: hm read once, wh/off read at the K peaks, boxes, scores
    # and indices written once
    nbytes = b * h * w * 4 + b * k * 4 * 4 + b * k * (4 + 1 + 1) * 4
    # per cell: the sigmoid (4), 8 window maxima and the peak select, float32
    ops = b * h * w * 13
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3

    imgs = torch.from_numpy(b640).to("cuda")
    pp, raw = det.config.preprocess, det.config.model.stem_preprocess
    with torch.inference_mode():
        x = normalize_images(imgs, pp, raw=raw)
        stages = {
            "h2d_copy": cuda_ms(lambda: torch.from_numpy(b640).to("cuda"), iters=10),
            "preprocess": cuda_ms(lambda: normalize_images(imgs, pp, raw=raw), iters=10),
            "forward": cuda_ms(lambda: det._forward(x), iters=10),
            "decode": kernel_ms,
        }
    prof = device_profile(lambda: det.detect_batch(b640, score_thresh=0.05))
    decode_feats_fused.launches = before  # timing launches are not main-path launches

    med = float(np.median(batch))
    times = {
        "detect_batch_bs32_640_ms": {"p50": med, "min": min(batch), "max": max(batch), "n": len(batch)},
        "detect_batch_bs32_640_img_s": 32e3 / med,
        "detect_batch_bs32_640_letterbox_ms": {"p50": float(np.median(lbox)), "min": min(lbox),
                                               "max": max(lbox), "n": len(lbox)},
        "detect_batch_bs32_640_letterbox_img_s": 32e3 / float(np.median(lbox)),
        "detect_single_640_ms": {"p50": float(np.median(single)), "p90": float(np.percentile(single, 90)),
                                 "n": len(single)},
        "stages_bs32_640_ms": stages,
        "profile_bs32_640": prof,
    }
    log("[times] " + json.dumps(times))
    return times, {
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def main() -> int:
    smi = phase_device()
    from tpucenterface_torch import DecodeConfig, Detector, DetectorConfig

    phase_build()
    cfg = DetectorConfig(decode=DecodeConfig(use_pallas=True))
    det = Detector.from_safetensors(FLAGSHIP, cfg)
    feats_imgs, _ = paint_batch(0, 32, (640, 640))
    with torch.inference_mode():
        x = torch.from_numpy(feats_imgs).to("cuda")
        from tpucenterface_torch.preprocess import normalize_images

        det_feats = det._forward(normalize_images(x, det.config.preprocess, raw=True))
    worst = phase_kernels(det_feats)

    det320 = Detector.from_safetensors(FLAGSHIP, DetectorConfig(decode=cfg.decode, default_size=320))
    det_cpu = Detector.from_safetensors(FLAGSHIP, DetectorConfig(decode=cfg.decode, default_size=320), device="cpu")
    launches = phase_main(det, det320, det_cpu)
    times, ktimes = phase_times(det, det_feats)

    record = {
        "kernels": [
            {
                "name": "decode_feats_fused",
                "route": "cuda",
                "source": "tpucenterface_torch/csrc/decode.cu",
                "replaces": "tpucenterface/decode/pallas_decode.py:134",
                "launches": launches["decode_feats_fused"],
                "max_abs_err": worst,
                **ktimes,
            }
        ]
    }
    log(smi)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
