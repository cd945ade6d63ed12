"""Flip and multi-scale test-time augmentation, merged by greedy NMS.

Mirrors `tpucenterface/eval/tta.py` (`nms`, `flip_detect`, `pick_bucket`,
`detect_tta`). `nms` takes the C++ kernel of `native` (`native/nms_ext.cpp`),
as the JAX package does whenever it can build it: it computes in float32.
`nms_plain` is the JAX package's numpy loop in float64, the plain version the
tests hold the kernel to; near the threshold on float64 input the two can
decide a box differently (ROADMAP §C).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from tpucenterface_torch import native
from tpucenterface_torch.detector import Detections


def nms(dets: np.ndarray, thresh: float = 0.4) -> np.ndarray:
    """Greedy IoU NMS over (N, 5) xyxy+score (+1 pixel convention), scores
    in stable descending order; returns the kept indices. A box is dropped
    when its IoU with a kept one exceeds `thresh`. The C++ kernel, on the
    detections cast to float32."""
    if len(dets) == 0:
        return np.zeros(0, np.int64)
    order = np.argsort(-dets[:, 4], kind="stable")
    return order[native.nms(dets[order], thresh)]


def nms_plain(dets: np.ndarray, thresh: float = 0.4) -> np.ndarray:
    """`nms` in numpy, in the detections' own dtype."""
    if len(dets) == 0:
        return np.zeros(0, np.int64)
    x1, y1, x2, y2, s = dets.T
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = np.argsort(-s, kind="stable")
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        iou = w * h / (areas[i] + areas[order[1:]] - w * h)
        order = order[1:][iou <= thresh]
    return np.asarray(keep, np.int64)


def flip_detect(detector, img: np.ndarray, **kw) -> Detections:
    """Detect on the horizontally mirrored image and un-mirror the boxes
    and landmarks (left/right point pairs swapped by
    DecodeConfig.lm_flip_perm)."""
    w = img.shape[1]
    det = detector.detect(img[:, ::-1], **kw)
    boxes, scores, lm = det.boxes, det.scores, det.landmarks
    if len(boxes):
        # img[:, ::-1] maps pixel index x -> w - 1 - x
        boxes = boxes.copy()
        x1 = w - 1 - boxes[:, 2]
        x2 = w - 1 - boxes[:, 0]
        boxes[:, 0], boxes[:, 2] = x1, x2
        if lm is not None:
            lm = lm.copy()
            lm[..., 0] = w - 1 - lm[..., 0]
            lm = lm[:, list(detector.config.decode.lm_flip_perm), :]
    return Detections(boxes, scores, lm)


def pick_bucket(buckets: Sequence[int], target: float) -> int:
    """Smallest bucket >= target, else the largest bucket."""
    for b in sorted(buckets):
        if b >= target:
            return b
    return max(buckets)


def merge_detections(parts, lm_parts, nms_thresh: float, max_dets: Optional[int]) -> Detections:
    """One image's TTA variants, (N_i, 5) xyxy+score arrays and their
    landmarks (or None), merged by `nms` and cut to the `max_dets` highest
    scores; each surviving detection keeps the landmarks of its variant."""
    if not parts:
        return Detections(np.zeros((0, 4), np.float32), np.zeros(0, np.float32), None)
    dets = np.concatenate(parts, axis=0)
    lms = np.concatenate(lm_parts, axis=0) if all(p is not None for p in lm_parts) else None
    keep = nms(dets, nms_thresh)
    order = np.argsort(-dets[keep][:, 4], kind="stable")
    idx = keep[order[:max_dets] if max_dets else order]
    return Detections(
        dets[idx][:, :4].astype(np.float32),
        dets[idx][:, 4].astype(np.float32),
        lms[idx].astype(np.float32) if lms is not None else None,
    )


def detect_tta(
    detector,
    img: np.ndarray,
    scales: Sequence[float] = (1.0,),
    flip: bool = True,
    score_thresh: float = 0.01,
    nms_thresh: float = 0.4,
    max_dets: Optional[int] = 750,
) -> Detections:
    """Flip and multi-scale TTA on one image, merged with NMS. Each scale
    times the image's longer side picks the model-input bucket."""
    h, w = img.shape[:2]
    parts, lm_parts = [], []
    for s in scales:
        size = pick_bucket(detector.config.buckets, max(h, w) * s)
        for flipped in ([False, True] if flip else [False]):
            if flipped:
                d = flip_detect(detector, img, score_thresh=score_thresh, size=size)
            else:
                d = detector.detect(img, score_thresh=score_thresh, size=size)
            if len(d.boxes):
                parts.append(np.concatenate([d.boxes, d.scores[:, None]], axis=1))
                lm_parts.append(d.landmarks)
    return merge_detections(parts, lm_parts, nms_thresh, max_dets)
