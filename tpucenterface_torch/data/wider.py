"""The WIDER annotation record.

Mirrors `tpucenterface/data/wider.py::WiderImage`, the record the eval
scorers take; the annotation parsers and writers of that module are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
