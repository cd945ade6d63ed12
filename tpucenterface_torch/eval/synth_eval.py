"""WIDER-protocol AP and landmark error over in-memory records.

Mirrors `tpucenterface/eval/synth_eval.py` (`DEFAULT_SPLITS`, `_imread`,
`_image_shape`, `ap_on_records`, `score_detections`, `ap_on_records_tta`,
`landmark_nme`): the product path (device letterbox -> forward -> decode ->
inverse letterbox) over each record, scored by `eval.wider_eval`.
Difficulty splits go by face size; a face outside the split, or flagged
invalid, is an ignore region.

The runners read each record's image from its path (cv2, imported when an
image is read) or take the decoded BGR images as `images=`, one per record,
so that they also run where cv2 is not installed. Images are decoded chunk
by chunk, in the JAX package's order and chunking, so the results equal one
whole-set call.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpucenterface_torch.config import INPUT_PAD_MULTIPLE
from tpucenterface_torch.data.wider import WiderImage
from tpucenterface_torch.eval.wider_eval import evaluate_detections

# (name, min face side in original pixels): easy = big faces only, hard =
# every valid face
DEFAULT_SPLITS: Tuple[Tuple[str, float], ...] = (
    ("easy", 50.0),
    ("medium", 25.0),
    ("hard", 0.0),
)


def _imread(path: str) -> np.ndarray:
    """Decode in stored pixel orientation (EXIF orientation ignored), as the
    header-only shape pass and WIDER-style GT boxes have it."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_IGNORE_ORIENTATION | cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img


def _image_shape(path: str) -> Tuple[int, int]:
    """(h, w) of an image file, from its header where PIL can read it."""
    try:
        from PIL import Image

        with Image.open(path) as im:
            w, h = im.size
        return int(h), int(w)
    except (ImportError, OSError):  # no PIL, or a file it cannot read: decode once
        img = _imread(path)
        return int(img.shape[0]), int(img.shape[1])


def _loader(records: Sequence[WiderImage], images: Optional[Sequence[np.ndarray]]):
    """(image of record i, (h, w) of record i): from `images` when given,
    else from the record's path."""
    if images is None:
        return lambda i: _imread(records[i].path), lambda i: _image_shape(records[i].path)
    if len(images) != len(records):
        raise ValueError(f"{len(images)} images for {len(records)} records")
    return lambda i: images[i], lambda i: tuple(images[i].shape[:2])


def _as_array(d) -> np.ndarray:
    return np.concatenate([d.boxes.reshape(-1, 4), d.scores.reshape(-1, 1)], axis=1)


def ap_on_records(
    det,
    records: Sequence[WiderImage],
    size: Optional[int] = None,
    score_thresh: float = 0.02,
    splits: Tuple[Tuple[str, float], ...] = DEFAULT_SPLITS,
    batch: int = 16,
    images: Optional[Sequence[np.ndarray]] = None,
) -> Dict[str, float]:
    """AP per difficulty split for `det` (a Detector) over `records`,
    letterboxed on the device at `size` (det.config.default_size when
    None), through `detect_batch`."""
    dets = [_as_array(d) for d in _detect_records(det, records, size, score_thresh, batch, images)]
    return score_detections(dets, records, splits)


def _detect_records(det, records, size, score_thresh, batch, images=None):
    """Yield one Detections per record. Every image is zero-padded onto one
    canvas, the largest padded (H, W) of the set, so that `detect_batch`
    runs at one signature; the letterbox scales from each image's own
    (h, w), so the results equal those of one call per image. Images are
    decoded a batch at a time."""
    read, shape_of = _loader(records, images)
    hws = [shape_of(i) for i in range(len(records))]
    m = INPUT_PAD_MULTIPLE
    hp = max(-(-h // m) * m for h, _ in hws)
    wp = max(-(-w // m) * m for _, w in hws)
    for s in range(0, len(records), batch):
        chunk = range(s, min(s + batch, len(records)))
        stack = np.zeros((batch, hp, wp, 3), np.uint8)
        chw = np.full((batch, 2), (hp, wp), np.int32)
        for j, i in enumerate(chunk):
            img = read(i)
            h, w = img.shape[:2]
            if (h, w) != tuple(hws[i]):
                raise ValueError(f"{records[i].path}: decoded {(h, w)}, header {hws[i]}")
            stack[j, :h, :w] = img
            chw[j] = (h, w)
        outs = det.detect_batch(stack, hws=chw, score_thresh=score_thresh, size=size)
        yield from outs[: len(chunk)]  # the pad rows past the chunk are dropped


def score_detections(
    dets: Sequence[np.ndarray],
    records: Sequence[WiderImage],
    splits: Tuple[Tuple[str, float], ...] = DEFAULT_SPLITS,
) -> Dict[str, float]:
    """Score per-record (N, 5) xyxy+score arrays against the records' GT
    with the WIDER protocol and size-based difficulty splits."""
    gts = [rec.xyxy.astype(np.float64) for rec in records]
    sides = [rec.boxes[:, 2:4].min(axis=1) for rec in records]
    valid = [~rec.invalid for rec in records]
    out: Dict[str, float] = {}
    for name, min_side in splits:
        keeps = [v & (s >= min_side) for v, s in zip(valid, sides)]
        out[name] = evaluate_detections(list(dets), gts, keeps)
    return out


def ap_on_records_tta(
    det,
    records: Sequence[WiderImage],
    scales: Sequence[float] = (1.0,),
    flip: bool = True,
    score_thresh: float = 0.02,
    splits: Tuple[Tuple[str, float], ...] = DEFAULT_SPLITS,
    batch: int = 64,
    images: Optional[Sequence[np.ndarray]] = None,
) -> Dict[str, float]:
    """AP per difficulty split through the TTA path
    (`eval.batch_runner.batched_detect_tta`: bucketed batches, the flip on
    the device, the NMS merge on the host)."""
    dets = [_as_array(d) for d in _detect_records_tta(det, records, scales, flip, score_thresh, batch, images)]
    return score_detections(dets, records, splits)


def _detect_records_tta(det, records, scales, flip, score_thresh, batch, images=None):
    """Yield one TTA-merged Detections per record, decoding the images in
    chunks of max(4 * batch, 256)."""
    from tpucenterface_torch.eval.batch_runner import batched_detect_tta

    read, _ = _loader(records, images)
    chunk_imgs = max(4 * batch, 256)
    for s in range(0, len(records), chunk_imgs):
        imgs = [read(i) for i in range(s, min(s + chunk_imgs, len(records)))]
        yield from batched_detect_tta(
            det, imgs, scales=scales, flip=flip, score_thresh=score_thresh, batch_size=batch
        )


def landmark_nme(
    det,
    records: Sequence[WiderImage],
    size: Optional[int] = None,
    score_thresh: float = 0.3,
    iou_thresh: float = 0.5,
    min_side: float = 0.0,
    batch: int = 16,
    tta: bool = False,
    scales: Sequence[float] = (1.0,),
    flip: bool = True,
    images: Optional[Sequence[np.ndarray]] = None,
) -> Dict[str, float]:
    """Normalized mean landmark error over IoU-matched faces.

    For every valid GT face with known landmarks (and a box side >=
    `min_side`), the highest-scoring detection with IoU >= `iou_thresh`
    gives the mean of its five point distances over sqrt(gt_w * gt_h).
    Unmatched faces leave the mean and lower `match_rate`. With tta=True the
    detections come from the TTA path (`size` unused). Returns {"nme",
    "match_rate", "faces"}; nme is NaN when nothing matched."""
    errs: List[float] = []
    eligible = matched = 0
    provider = (
        _detect_records_tta(det, records, scales, flip, score_thresh, batch, images)
        if tta
        else _detect_records(det, records, size, score_thresh, batch, images)
    )
    for rec, d in zip(records, provider):
        if rec.landmarks is None or not len(rec.boxes):
            continue
        gt = rec.xyxy.astype(np.float64)
        keep = ~rec.invalid & ~np.isnan(rec.landmarks).any(axis=1)
        if min_side > 0:
            keep &= rec.boxes[:, 2:4].min(axis=1) >= min_side
        if not keep.any():
            continue
        boxes = d.boxes.reshape(-1, 4).astype(np.float64)
        lms = None if d.landmarks is None else d.landmarks.reshape(-1, 5, 2).astype(np.float64)
        for gi in np.flatnonzero(keep):
            eligible += 1
            if lms is None or not len(boxes):
                continue
            g = gt[gi]
            ix1 = np.maximum(boxes[:, 0], g[0])
            iy1 = np.maximum(boxes[:, 1], g[1])
            ix2 = np.minimum(boxes[:, 2], g[2])
            iy2 = np.minimum(boxes[:, 3], g[3])
            inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
            area_d = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            area_g = (g[2] - g[0]) * (g[3] - g[1])
            iou = inter / np.maximum(area_d + area_g - inter, 1e-9)
            cand = np.flatnonzero(iou >= iou_thresh)
            if not len(cand):
                continue
            di = int(cand[0])  # detections come score-descending
            matched += 1
            gpts = rec.landmarks[gi].reshape(5, 2).astype(np.float64)
            dist = np.linalg.norm(lms[di] - gpts, axis=1).mean()
            errs.append(float(dist / np.sqrt(max(area_g, 1e-9))))
    return {
        "nme": float(np.mean(errs)) if errs else float("nan"),
        "match_rate": matched / eligible if eligible else 0.0,
        "faces": eligible,
    }
