"""CenterNet target rendering: Gaussian heatmaps + wh/offset/index tensors.

Mirrors `tpucenterface/data/targets.py` (`gaussian_radius`, `_gaussian2d`,
`draw_gaussian`, `make_targets`) line for line: host-side numpy, bit-equal
output. Layout matches `train.losses`: hm (H,W,C), ind/mask (M,), wh/off (M,2).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def gaussian_radius(height: float, width: float, min_overlap: float = 0.7) -> float:
    """CornerNet-geometry radius: largest shift keeping IoU >= min_overlap.

    The three quadratic cases bound corner displacement for (1) both corners
    inside, (2) both outside, (3) one in one out.

    The roots are the corrected (b - sqrt)/(2a), the smaller root, as in the
    JAX package (the original CornerNet code's (b + sqrt)/2 roots give
    oversized radii). Callers pass ceil'd box extents.
    """
    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    sq1 = np.sqrt(max(b1 ** 2 - 4 * a1 * c1, 0.0))
    r1 = (b1 - sq1) / (2 * a1)

    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    sq2 = np.sqrt(max(b2 ** 2 - 4 * a2 * c2, 0.0))
    r2 = (b2 - sq2) / (2 * a2)

    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    sq3 = np.sqrt(max(b3 ** 2 - 4 * a3 * c3, 0.0))
    r3 = (b3 + sq3) / (2 * a3)
    return max(0.0, min(r1, r2, r3))


def _gaussian2d(shape, sigma: float) -> np.ndarray:
    m, n = [(s - 1.0) / 2.0 for s in shape]
    y, x = np.ogrid[-m : m + 1, -n : n + 1]
    h = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def draw_gaussian(heatmap: np.ndarray, center, radius: int, k: float = 1.0) -> None:
    """Splat a 2D Gaussian of given integer radius at center (x, y), in place,
    taking the elementwise max with existing values (umich style)."""
    diameter = 2 * radius + 1
    gaussian = _gaussian2d((diameter, diameter), sigma=diameter / 6.0)
    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[:2]

    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)
    if right + left <= 0 or bottom + top <= 0:
        return
    masked_heatmap = heatmap[y - top : y + bottom, x - left : x + right]
    masked_gaussian = gaussian[
        radius - top : radius + bottom, radius - left : radius + right
    ]
    np.maximum(masked_heatmap, masked_gaussian * k, out=masked_heatmap)


def make_targets(
    boxes_xyxy: np.ndarray,
    input_size: int,
    stride: int = 4,
    max_objs: int = 128,
    num_classes: int = 1,
    wh_log: bool = False,
    landmarks: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Render one image's training targets from boxes in input-pixel coords.

    boxes_xyxy: (N, 4) in [0, input_size) pixel coordinates (post-augment).
    Returns hm (H,W,C), ind (M,), mask (M,), wh (M,2), off (M,2)
    [+ lm (M,10), lm_mask (M,) when landmarks given].
    """
    h = w = input_size // stride
    hm = np.zeros((h, w, num_classes), np.float32)
    ind = np.zeros((max_objs,), np.int64)
    mask = np.zeros((max_objs,), np.float32)
    wh = np.zeros((max_objs, 2), np.float32)
    off = np.zeros((max_objs, 2), np.float32)
    lm = np.zeros((max_objs, 10), np.float32)
    lm_mask = np.zeros((max_objs,), np.float32)

    n = 0
    for j, (x1, y1, x2, y2) in enumerate(np.asarray(boxes_xyxy, np.float32)):
        if n >= max_objs:
            break
        x1, x2 = np.clip([x1, x2], 0, input_size - 1) / stride
        y1, y2 = np.clip([y1, y2], 0, input_size - 1) / stride
        bw, bh = x2 - x1, y2 - y1
        if bw <= 0 or bh <= 0:
            continue
        cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
        ci, cj = int(cx), int(cy)
        if not (0 <= ci < w and 0 <= cj < h):
            continue
        radius = max(0, int(gaussian_radius(np.ceil(bh), np.ceil(bw))))
        draw_gaussian(hm[..., 0], (ci, cj), radius)
        ind[n] = cj * w + ci
        mask[n] = 1.0
        wh[n] = (np.log(max(bw, 1e-4)), np.log(max(bh, 1e-4))) if wh_log else (bw, bh)
        off[n] = (cx - ci, cy - cj)
        if landmarks is not None and not np.isnan(landmarks[j]).any():
            pts = landmarks[j].reshape(5, 2) / stride
            lm[n] = (pts - np.array([ci, cj])).reshape(-1)
            lm_mask[n] = 1.0
        n += 1

    out = {"hm": hm, "ind": ind, "mask": mask, "wh": wh, "off": off}
    if landmarks is not None:
        out["lm"] = lm
        out["lm_mask"] = lm_mask
    return out
