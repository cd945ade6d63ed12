"""Procedural multi-face scene generator.

Mirrors `tpucenterface/data/synth.py` (`render_scene`, `generate_dataset`)
line for line: every scene derives from RandomState(seed, index) alone and is
drawn with the same OpenCV calls in the same order, so a seed gives the JAX
package's scenes bit for bit, which lets the eval splits be regenerated from
seeds instead of committed. Scenes vary face scale (log-uniform, ~14 px to
half the frame), crowding, partial occlusion, rotation, skin tone and
lighting, with non-face distractors. Records come back as
`data.wider.WiderImage`.

`cv2` is imported inside the functions that draw or write.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from tpucenterface_torch.data.wider import WiderImage

# Skin-tone palette (BGR), spanning light to dark; sampled per face with
# per-channel jitter so tone alone is not a separating feature.
_SKIN_BGR = np.array(
    [
        (140, 170, 220),
        (120, 160, 210),
        (100, 140, 190),
        (80, 115, 165),
        (60, 90, 135),
        (45, 70, 105),
    ],
    np.float32,
)


def _rot(deg: float) -> np.ndarray:
    r = np.deg2rad(deg)
    return np.array(
        [[np.cos(r), -np.sin(r)], [np.sin(r), np.cos(r)]], np.float32
    )


# 5-point landmark positions in the renderer's face frame (fx across
# width, fy down height, both in [-1, 1]) — the EXACT coordinates
# _draw_face paints the features at: eye centers, nose tip (where the
# nose-shadow line ends), mouth-ellipse corners. Order matches
# DecodeConfig.lm_flip_perm: [left eye, right eye, nose, left mouth
# corner, right mouth corner], image-left first.
_LM_FACE_FRAME = np.array(
    [
        (-0.38, -0.18),  # left eye
        (0.38, -0.18),   # right eye
        (0.0, 0.12),     # nose tip
        (-0.26, 0.48),   # left mouth corner
        (0.26, 0.48),    # right mouth corner
    ],
    np.float32,
)


def _draw_face(
    img: np.ndarray,
    cx: float,
    cy: float,
    size: float,
    rng: np.random.RandomState,
) -> Tuple[np.ndarray, np.ndarray]:
    """Draw one procedural face centered at (cx, cy); `size` is the head
    height in pixels. Returns (tight xyxy bbox of the head ellipse,
    (10,) landmark GT — the sub-pixel image coordinates of the rendered
    eye/nose/mouth features, _LM_FACE_FRAME through the same rotation)."""
    import cv2

    angle = rng.uniform(-28.0, 28.0)
    R = _rot(angle)
    h2 = size / 2.0
    w2 = h2 * rng.uniform(0.68, 0.82)  # head aspect
    tone = _SKIN_BGR[rng.randint(len(_SKIN_BGR))]
    tone = np.clip(tone * rng.uniform(0.85, 1.15, 3), 0, 255)

    def fpt(fx: float, fy: float) -> Tuple[int, int]:
        # face-frame (fx in [-1,1] across width, fy in [-1,1] down height)
        v = R @ np.array([fx * w2, fy * h2], np.float32)
        return int(round(cx + v[0])), int(round(cy + v[1]))

    def flen(f: float) -> int:
        return max(1, int(round(f * h2)))

    # head
    cv2.ellipse(
        img, (int(cx), int(cy)), (int(w2), int(h2)), angle, 0, 360,
        tone.tolist(), -1, cv2.LINE_AA,
    )
    # soft cheek/forehead shading (keeps the blob from being flat-colored)
    shade = np.clip(tone * rng.uniform(0.88, 0.96), 0, 255)
    cv2.ellipse(
        img, fpt(0.0, 0.45), (flen(0.30), flen(0.18)), angle, 0, 360,
        shade.tolist(), -1, cv2.LINE_AA,
    )
    # hair cap (half the faces)
    if rng.rand() < 0.55:
        hair = rng.uniform(15, 80, 3)
        cv2.ellipse(
            img, fpt(0.0, -0.72), (flen(0.38), flen(0.22)), angle, 0, 360,
            hair.tolist(), -1, cv2.LINE_AA,
        )
    # eyes: sclera + pupil, brows above
    eye_dark = rng.uniform(10, 60, 3)
    sclera = np.clip(tone * 1.35 + 40, 0, 255)
    for sx in (-0.38, 0.38):
        ex, ey = fpt(sx, -0.18)
        er = max(1, flen(0.11))
        cv2.ellipse(
            img, (ex, ey), (er, max(1, int(er * 0.62))), angle, 0, 360,
            sclera.tolist(), -1, cv2.LINE_AA,
        )
        cv2.circle(
            img, (ex, ey), max(1, int(er * 0.5)), eye_dark.tolist(), -1,
            cv2.LINE_AA,
        )
        bx, by = fpt(sx, -0.38)
        cv2.ellipse(
            img, (bx, by), (er, max(1, int(er * 0.3))), angle, 0, 360,
            (eye_dark * 0.8).tolist(), -1, cv2.LINE_AA,
        )
    # nose shadow
    nx, ny = fpt(0.0, 0.12)
    cv2.line(
        img, fpt(0.0, -0.05), (nx, ny),
        np.clip(tone * 0.75, 0, 255).tolist(), max(1, flen(0.05)),
        cv2.LINE_AA,
    )
    # mouth
    mx, my = fpt(0.0, 0.48)
    mouth = (rng.uniform(30, 70), rng.uniform(20, 60), rng.uniform(90, 180))
    cv2.ellipse(
        img, (mx, my), (flen(0.26), max(1, flen(0.07))), angle, 0, 360,
        mouth, -1, cv2.LINE_AA,
    )
    # tight bbox of the rotated head ellipse
    ew = np.hypot(w2 * np.cos(np.deg2rad(angle)), h2 * np.sin(np.deg2rad(angle)))
    eh = np.hypot(w2 * np.sin(np.deg2rad(angle)), h2 * np.cos(np.deg2rad(angle)))
    box = np.array([cx - ew, cy - eh, cx + ew, cy + eh], np.float32)
    # landmark GT: face-frame points through the SAME rotation the features
    # were painted with, sub-pixel (fpt()'s int rounding is a paint detail)
    lm = (
        _LM_FACE_FRAME * np.array([w2, h2], np.float32) @ R.T
        + np.array([cx, cy], np.float32)
    ).astype(np.float32)
    return box, lm.reshape(-1)


def _draw_distractors(
    img: np.ndarray, rng: np.random.RandomState, n: int
) -> None:
    """Non-face clutter sharing face-like low-order stats: plain skin-tone
    ellipses (no features), rectangles, polygons, texture patches."""
    import cv2

    h, w = img.shape[:2]
    for _ in range(n):
        kind = rng.randint(4)
        color = rng.uniform(0, 255, 3).tolist()
        cx, cy = rng.randint(0, w), rng.randint(0, h)
        s = int(rng.uniform(8, 90))
        if kind == 0:
            # featureless skin-tone ellipse — the critical hard negative
            tone = _SKIN_BGR[rng.randint(len(_SKIN_BGR))]
            tone = np.clip(tone * rng.uniform(0.85, 1.15, 3), 0, 255)
            cv2.ellipse(
                img, (cx, cy), (int(s * 0.75), s), rng.uniform(-30, 30),
                0, 360, tone.tolist(), -1, cv2.LINE_AA,
            )
        elif kind == 1:
            cv2.rectangle(
                img, (cx - s, cy - s // 2), (cx + s, cy + s // 2), color, -1
            )
        elif kind == 2:
            pts = (
                np.array([cx, cy], np.int32)
                + rng.randint(-s, s + 1, (rng.randint(3, 7), 2))
            )
            cv2.fillPoly(img, [pts], color)
        else:
            y0, y1 = max(0, cy - s), min(h, cy + s)
            x0, x1 = max(0, cx - s), min(w, cx + s)
            if y1 > y0 and x1 > x0:
                img[y0:y1, x0:x1] = rng.randint(
                    0, 255, (y1 - y0, x1 - x0, 3), np.uint8
                )


def render_scene(
    rng: np.random.RandomState,
    hw: Tuple[int, int] = (480, 640),
    max_faces: int = 12,
    min_face: float = 14.0,
    occlusion_prob: float = 0.3,
    return_landmarks: bool = False,
) -> Tuple[np.ndarray, ...]:
    """Render one scene -> (uint8 BGR image, boxes (N,4) x,y,w,h WIDER
    layout, invalid (N,) bool[, landmarks (N,10) when return_landmarks]).
    Faces occluded beyond ~55% of their area are flagged invalid (WIDER's
    ignore convention for unmatchable GT). Landmarks are the renderer's
    exact feature coordinates (see _LM_FACE_FRAME); requesting them does
    not change the RNG stream, so scenes are bit-identical either way."""
    import cv2

    h, w = hw
    # background: vertical/diagonal gradient + noise + soft blobs
    g0, g1 = rng.uniform(20, 160, 3), rng.uniform(20, 160, 3)
    ramp = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    img = (g0 * (1 - ramp) + g1 * ramp).astype(np.float32)
    img = np.broadcast_to(img, (h, w, 3)).copy()
    img += rng.normal(0, rng.uniform(3, 12), (h, w, 3)).astype(np.float32)
    img = np.clip(img, 0, 255).astype(np.uint8)
    _draw_distractors(img, rng, rng.randint(3, 10))

    n_faces = rng.randint(1, max_faces + 1)
    # crowding: with prob 0.4 faces cluster around 1-2 anchors
    anchors = None
    if n_faces >= 3 and rng.rand() < 0.4:
        anchors = rng.uniform([0.2 * w, 0.2 * h], [0.8 * w, 0.8 * h], (2, 2))

    boxes: List[np.ndarray] = []
    lms: List[np.ndarray] = []
    occluded_frac: List[float] = []
    max_face = 0.55 * min(h, w)
    for _ in range(n_faces):
        size = float(
            np.exp(rng.uniform(np.log(min_face), np.log(max_face)))
        )
        if anchors is not None and rng.rand() < 0.7:
            a = anchors[rng.randint(len(anchors))]
            cx = float(np.clip(a[0] + rng.normal(0, size * 1.2), size, w - size))
            cy = float(np.clip(a[1] + rng.normal(0, size * 1.2), size, h - size))
        else:
            cx = rng.uniform(size * 0.5, w - size * 0.5)
            cy = rng.uniform(size * 0.5, h - size * 0.5)
        box, lm = _draw_face(img, cx, cy, size, rng)
        boxes.append(box)
        lms.append(lm)
        occluded_frac.append(0.0)

    # partial occlusion: bars/shapes drawn over some faces AFTER all faces
    # are placed (so the occluder is the topmost layer, like a real post)
    for i, b in enumerate(boxes):
        if rng.rand() >= occlusion_prob:
            continue
        bw, bh = b[2] - b[0], b[3] - b[1]
        frac = rng.uniform(0.15, 0.55)
        color = rng.uniform(0, 255, 3).tolist()
        if rng.rand() < 0.5:  # vertical bar over one side
            ow = bw * frac
            x0 = b[0] if rng.rand() < 0.5 else b[2] - ow
            cv2.rectangle(
                img,
                (int(x0), int(b[1] - 2)),
                (int(x0 + ow), int(b[3] + 2)),
                color, -1,
            )
        else:  # horizontal bar over top/bottom
            oh = bh * frac
            y0 = b[1] if rng.rand() < 0.5 else b[3] - oh
            cv2.rectangle(
                img,
                (int(b[0] - 2), int(y0)),
                (int(b[2] + 2), int(y0 + oh)),
                color, -1,
            )
        occluded_frac[i] = frac

    xyxy = np.stack(boxes).astype(np.float32)
    xyxy[:, [0, 2]] = np.clip(xyxy[:, [0, 2]], 0, w - 1)
    xyxy[:, [1, 3]] = np.clip(xyxy[:, [1, 3]], 0, h - 1)
    wider = xyxy.copy()
    wider[:, 2:4] = xyxy[:, 2:4] - xyxy[:, 0:2]  # x,y,w,h
    invalid = np.array([f > 0.5 for f in occluded_frac], bool)
    if return_landmarks:
        return img, wider, invalid, np.stack(lms).astype(np.float32)
    return img, wider, invalid


def generate_dataset(
    out_dir: str,
    n_images: int,
    seed: int = 0,
    hw_range: Tuple[int, int] = (384, 768),
    max_faces: int = 12,
    min_face: float = 14.0,
    jpg_quality: int = 92,
    event: str = "synth",
    force: bool = False,
) -> List[WiderImage]:
    """Render `n_images` scenes to out_dir/<event>/ as jpgs; returns
    WiderImage records. Idempotent: existing files are reused unless
    `force` (scenes are a pure function of (seed, index, scene params), so
    reuse is exact up to the one-time jpg encode).

    The scene-parameter key is EMBEDDED IN EVERY FILENAME (jpgs and the GT
    sidecar): a scene is a function of hw_range/max_faces/min_face as well
    as (seed, index), so reusing a same-named file rendered under different
    parameters would silently pair fresh boxes with stale pixels."""
    import cv2

    ev_dir = os.path.join(out_dir, event)
    os.makedirs(ev_dir, exist_ok=True)

    key = (
        f"s{seed}_{hw_range[0]}x{hw_range[1]}_f{max_faces}"
        f"_m{min_face:g}_q{jpg_quality}"
    )

    # GT sidecar: rendering is the only source of the boxes, so a resumed
    # run (train_flagship's stage split) would otherwise re-render every
    # scene just to recover them.
    # Existence of the key-named jpgs is a valid cache check precisely
    # because the key pins every parameter that shapes the pixels.
    meta_path = os.path.join(ev_dir, f".meta_{event}_{key}_{n_images}.npz")
    if not force and os.path.exists(meta_path):
        meta = np.load(meta_path, allow_pickle=True)
        # sidecars written before landmark support lack "lms": treat as a
        # cache miss (scenes are deterministic, so the re-render below
        # recovers identical boxes AND the landmarks; same-key jpgs reused)
        if "lms" in meta:
            rels = [str(r) for r in meta["rels"]]
            if all(os.path.exists(os.path.join(out_dir, r)) for r in rels):
                return [
                    WiderImage(
                        os.path.join(out_dir, rel), rel,
                        meta["boxes"][i], meta["invalid"][i],
                        landmarks=meta["lms"][i],
                    )
                    for i, rel in enumerate(rels)
                ]

    records: List[WiderImage] = []
    for i in range(n_images):
        rng = np.random.RandomState(
            (seed * 1_000_003 + i * 7919) % (2**31 - 1)
        )
        h = int(rng.uniform(*hw_range))
        w = int(rng.uniform(*hw_range))
        rel = f"{event}/{event}_{key}_{i:05d}.jpg"
        path = os.path.join(out_dir, rel)
        img, boxes, invalid, lms = render_scene(
            rng, (h, w), max_faces=max_faces, min_face=min_face,
            return_landmarks=True,
        )
        if force or not os.path.exists(path):
            cv2.imwrite(
                path, img, [int(cv2.IMWRITE_JPEG_QUALITY), jpg_quality]
            )
        records.append(WiderImage(path, rel, boxes, invalid, landmarks=lms))
    np.savez(
        meta_path,
        rels=np.array([r.rel_path for r in records], dtype=object),
        boxes=np.array([r.boxes for r in records], dtype=object),
        invalid=np.array([r.invalid for r in records], dtype=object),
        lms=np.array([r.landmarks for r in records], dtype=object),
    )
    return records
