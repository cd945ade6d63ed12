"""WIDER FACE annotation records, parsers and the submission writer.

Mirrors `tpucenterface/data/wider.py`: `WiderImage`, `parse_bbx_gt` (the
official `wider_face_{split}_bbx_gt.txt`: blocks of a relative image path, a
face count and that many `x y w h blur expression illumination invalid
occlusion pose` lines), `parse_retinaface_gt` (the RetinaFace-distribution
`label.txt` with 5-point landmarks), `iter_event_images` and
`write_wider_detections` (the WIDER submission txt).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional

import numpy as np


@dataclasses.dataclass
class WiderImage:
    path: str              # absolute path to the jpg
    rel_path: str          # event/img.jpg relative path
    boxes: np.ndarray      # (N, 4) float32 x1,y1,w,h (WIDER native layout)
    invalid: np.ndarray    # (N,) bool: annotation flagged invalid
    # optional 5-point landmarks, (N, 10) float32 x1,y1,...,x5,y5 in image
    # pixels, point order [left eye, right eye, nose, left mouth corner,
    # right mouth corner] (image-left; DecodeConfig.lm_flip_perm pairs);
    # None when the annotation source has none; NaN rows mark faces whose
    # landmarks are unknown
    landmarks: Optional[np.ndarray] = None

    @property
    def xyxy(self) -> np.ndarray:
        b = self.boxes.copy()
        b[:, 2:4] += b[:, 0:2]
        return b


def parse_bbx_gt(
    gt_file: str, images_root: str, min_size: float = 0.0
) -> List[WiderImage]:
    """Parse a `wider_face_*_bbx_gt.txt` file into WiderImage records."""
    out: List[WiderImage] = []
    with open(gt_file, "r") as f:
        lines = [ln.strip() for ln in f]
    i = 0
    while i < len(lines):
        rel = lines[i]
        i += 1
        if not rel:
            continue
        n = int(lines[i])
        i += 1
        boxes, invalid = [], []
        # the quirk in the official file: n==0 entries still carry one
        # all-zeros annotation line
        rows = max(n, 1) if i < len(lines) and lines[i].count(" ") >= 3 else n
        for _ in range(rows):
            vals = lines[i].split()
            i += 1
            x, y, w, h = map(float, vals[:4])
            inv = bool(int(vals[7])) if len(vals) > 7 else False
            if n > 0 and w > min_size and h > min_size:
                boxes.append([x, y, w, h])
                invalid.append(inv)
        out.append(
            WiderImage(
                path=os.path.join(images_root, rel),
                rel_path=rel,
                boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                invalid=np.asarray(invalid, bool).reshape(-1),
            )
        )
    return out


def parse_retinaface_gt(
    label_file: str, images_root: str, min_size: float = 0.0
) -> List[WiderImage]:
    """Parse the RetinaFace-distribution `label.txt` (the standard WIDER
    train annotation carrying 5-point landmarks).

    Format: repeated blocks of
        # <event>/<img>.jpg
        x y w h  px1 py1 f1  px2 py2 f2  ...  px5 py5 f5  conf
    One face per line; 4 tokens means box-only (val-style). A face whose
    landmark coords are all negative (the file's "no annotation" marker)
    gets a NaN landmark row — the loader renders lm_mask=0 for it, so it
    still trains boxes. Point order in the file is already the canonical
    [left eye, right eye, nose, left mouth, right mouth].
    """
    out: List[WiderImage] = []
    rel = None
    boxes: List[List[float]] = []
    lms: List[np.ndarray] = []

    def flush():
        if rel is None:
            return
        b = np.asarray(boxes, np.float32).reshape(-1, 4)
        lm = np.asarray(lms, np.float32).reshape(-1, 10)
        out.append(
            WiderImage(
                path=os.path.join(images_root, rel),
                rel_path=rel,
                boxes=b,
                invalid=np.zeros((len(b),), bool),
                landmarks=lm if not np.isnan(lm).all() else None,
            )
        )

    with open(label_file, "r") as f:
        for ln in f:
            ln = ln.strip()
            if not ln:
                continue
            if ln.startswith("#"):
                flush()
                rel = ln.lstrip("#").strip()
                boxes, lms = [], []
                continue
            vals = [float(v) for v in ln.split()]
            x, y, w, h = vals[:4]
            if not (w > min_size and h > min_size):
                continue
            boxes.append([x, y, w, h])
            if len(vals) >= 19:
                # 5 x (px, py, flag): drop every third (annotator flag)
                pts = np.asarray(vals[4:19], np.float32).reshape(5, 3)[:, :2]
                if (pts < 0).all():  # "-1 -1 ... " = no landmark annotation
                    pts = np.full((5, 2), np.nan, np.float32)
                lms.append(pts.reshape(-1))
            else:
                lms.append(np.full((10,), np.nan, np.float32))
    flush()
    return out


def iter_event_images(val_images_root: str) -> Iterator[str]:
    """Yield event/img.jpg relative paths by walking the val images tree."""
    for event in sorted(os.listdir(val_images_root)):
        ev_dir = os.path.join(val_images_root, event)
        if not os.path.isdir(ev_dir):
            continue
        for name in sorted(os.listdir(ev_dir)):
            if name.lower().endswith((".jpg", ".jpeg", ".png")):
                yield os.path.join(event, name)


def write_wider_detections(
    out_root: str, rel_path: str, boxes: np.ndarray, scores: np.ndarray
) -> None:
    """Write one image's detections in the WIDER submission txt format:
    event/img.txt containing `name / count / x y w h score` lines."""
    rel_noext = os.path.splitext(rel_path)[0]
    out_path = os.path.join(out_root, rel_noext + ".txt")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(os.path.basename(rel_noext) + "\n")
        f.write(f"{len(boxes)}\n")
        for (x1, y1, x2, y2), s in zip(boxes, scores):
            f.write(f"{x1:.1f} {y1:.1f} {x2 - x1:.1f} {y2 - y1:.1f} {s:.3f}\n")
