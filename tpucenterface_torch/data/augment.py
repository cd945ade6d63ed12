"""Training augmentation: random scale/shift affine, hflip, color jitter.

Mirrors `tpucenterface/data/augment.py` line for line, with the same draws
from the RandomState in the same order, so a seed gives the JAX package's
canvases bit for bit. Host-side; emits uint8 canvases (normalization runs on
the device in `train.step`). The warp is `cv2.warpAffine`, imported inside
`random_affine` so that importing this module needs no `cv2`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from tpucenterface_torch.config import TrainConfig


def random_affine(
    img: np.ndarray,
    boxes_xyxy: np.ndarray,
    input_size: int,
    rng: np.random.RandomState,
    scale_range: Tuple[float, float] = (0.6, 1.4),
    shift_ratio: float = 0.1,
    landmarks: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, ...]:
    """Random scale + center shift, mapped onto a square canvas.

    The source window (centered at a jittered image center, side =
    max_side / scale) maps to [0, input_size)^2 via one warpAffine call;
    boxes — and landmarks (N,10), when given — get the same affine (the
    landmark return slot appears only when landmarks is not None).
    """
    import cv2

    h, w = img.shape[:2]
    s = rng.uniform(*scale_range)
    cx = w / 2 + rng.uniform(-shift_ratio, shift_ratio) * w
    cy = h / 2 + rng.uniform(-shift_ratio, shift_ratio) * h
    side = max(h, w) / s
    a = input_size / side
    # x' = a*(x - cx) + input_size/2
    m = np.array(
        [[a, 0, input_size / 2 - a * cx], [0, a, input_size / 2 - a * cy]],
        np.float32,
    )
    out = cv2.warpAffine(
        img, m, (input_size, input_size), flags=cv2.INTER_LINEAR, borderValue=0
    )
    if len(boxes_xyxy):
        b = boxes_xyxy.copy().astype(np.float32)
        b[:, [0, 2]] = a * (b[:, [0, 2]] - cx) + input_size / 2
        b[:, [1, 3]] = a * (b[:, [1, 3]] - cy) + input_size / 2
    else:
        b = boxes_xyxy
    if landmarks is not None:
        lm = landmarks.copy().astype(np.float32)
        if len(lm):
            lm[:, 0::2] = a * (lm[:, 0::2] - cx) + input_size / 2
            lm[:, 1::2] = a * (lm[:, 1::2] - cy) + input_size / 2
        return out, b, lm
    return out, b


# mirror permutation for the canonical 5-point order [left eye, right eye,
# nose, left mouth, right mouth] — same pairs DecodeConfig.lm_flip_perm
# swaps on the inference flip-TTA path
_LM_FLIP_PERM = (1, 0, 2, 4, 3)


def hflip(
    img: np.ndarray,
    boxes_xyxy: np.ndarray,
    landmarks: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, ...]:
    w = img.shape[1]
    img = np.ascontiguousarray(img[:, ::-1])
    if len(boxes_xyxy):
        b = boxes_xyxy.copy()
        b[:, [0, 2]] = w - boxes_xyxy[:, [2, 0]]
    else:
        b = boxes_xyxy
    if landmarks is not None:
        lm = landmarks.copy()
        if len(lm):
            lm[:, 0::2] = w - lm[:, 0::2]
            # mirroring turns the image-left eye into the image-right eye:
            # re-order points so the label semantics survive the flip
            lm = lm.reshape(-1, 5, 2)[:, list(_LM_FLIP_PERM)].reshape(-1, 10)
        return img, b, lm
    return img, b


def color_jitter(
    img: np.ndarray, rng: np.random.RandomState, strength: float = 0.4
) -> np.ndarray:
    """Brightness/contrast jitter on uint8."""
    f = img.astype(np.float32)
    f *= rng.uniform(1 - strength, 1 + strength)               # brightness
    mean = f.mean(axis=(0, 1), keepdims=True)
    f = (f - mean) * rng.uniform(1 - strength, 1 + strength) + mean  # contrast
    return np.clip(f, 0, 255).astype(np.uint8)


def filter_boxes(
    boxes_xyxy: np.ndarray, input_size: int, min_side: float = 2.0
) -> np.ndarray:
    """Clip to canvas and drop boxes that became too small."""
    b, keep = _clip_and_keep(boxes_xyxy, input_size, min_side)
    return b[keep]


def _clip_and_keep(
    boxes_xyxy: np.ndarray, input_size: int, min_side: float
) -> Tuple[np.ndarray, np.ndarray]:
    """(clipped boxes, survivor mask) — shared so landmark rows can follow
    exactly the boxes filter_boxes keeps."""
    if len(boxes_xyxy) == 0:
        return boxes_xyxy.reshape(0, 4), np.zeros((0,), bool)
    b = np.clip(boxes_xyxy, 0, input_size - 1)
    wh = b[:, 2:4] - b[:, 0:2]
    return b, (wh > min_side).all(axis=1)


def augment_train(
    img: np.ndarray,
    boxes_xyxy: np.ndarray,
    cfg: TrainConfig,
    rng: Optional[np.random.RandomState] = None,
    landmarks: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, ...]:
    """Full train-time augmentation -> (uint8 canvas, surviving boxes
    [, surviving landmark rows when landmarks is not None]).

    With landmarks given, the RNG draw sequence is IDENTICAL to the
    boxes-only path (points ride the same transforms, no extra draws), so
    enabling landmark training does not perturb the image/box stream."""
    rng = rng or np.random.RandomState()
    if landmarks is None:
        img, boxes = random_affine(
            img, boxes_xyxy, cfg.input_size, rng,
            cfg.scale_range, cfg.shift_ratio,
        )
        if rng.rand() < cfg.flip_prob:
            img, boxes = hflip(img, boxes)
        if cfg.color_jitter > 0:
            img = color_jitter(img, rng, cfg.color_jitter)
        return img, filter_boxes(boxes, cfg.input_size)

    img, boxes, lms = random_affine(
        img, boxes_xyxy, cfg.input_size, rng,
        cfg.scale_range, cfg.shift_ratio, landmarks=landmarks,
    )
    if rng.rand() < cfg.flip_prob:
        img, boxes, lms = hflip(img, boxes, landmarks=lms)
    if cfg.color_jitter > 0:
        img = color_jitter(img, rng, cfg.color_jitter)
    boxes, keep = _clip_and_keep(boxes, cfg.input_size, 2.0)
    return img, boxes[keep], lms[keep]
