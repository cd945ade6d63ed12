"""WIDER FACE AP protocol in numpy.

Mirrors `tpucenterface/eval/wider_eval.py` (`NUM_THRESH`, `bbox_overlaps`,
`image_eval`, `img_pr_info`, `voc_ap`, `evaluate_detections`,
`load_wider_gt`, `evaluate_wider`), the standard WIDER eval-tools protocol:

  per image: greedy score-descending IoU (>= 0.5) match of detections to GT,
  honouring the per-difficulty keep list (a detection whose best GT is not
  kept is voided: neither a true nor a false positive);
  dataset: global min-max score normalization, 1000 score thresholds -> PR
  curve -> all-point AP.

`bbox_overlaps` takes the C++ kernel of `native` (`native/nms_ext.cpp`), as
the JAX package does whenever it can build it; `bbox_overlaps_plain` is the
JAX package's numpy version in float64, the plain version the tests hold the
kernel to. Ground truth comes from the official `.mat` files
(scipy, imported when they are loaded) or from in-memory box lists.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpucenterface_torch import native

NUM_THRESH = 1000


def bbox_overlaps(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """IoU matrix (N, M) in float64 for xyxy boxes, +1 pixel convention,
    through the C++ kernel."""
    if len(boxes) == 0 or len(query) == 0:
        return np.zeros((len(boxes), len(query)), np.float64)
    return native.bbox_overlaps(boxes, query)


def bbox_overlaps_plain(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """`bbox_overlaps` in numpy."""
    if len(boxes) == 0 or len(query) == 0:
        return np.zeros((len(boxes), len(query)), np.float64)
    b = boxes[:, None, :]  # (N,1,4)
    q = query[None, :, :]  # (1,M,4)
    ix = np.maximum(0.0, np.minimum(b[..., 2], q[..., 2]) - np.maximum(b[..., 0], q[..., 0]) + 1)
    iy = np.maximum(0.0, np.minimum(b[..., 3], q[..., 3]) - np.maximum(b[..., 1], q[..., 1]) + 1)
    inter = ix * iy
    area_b = (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)
    area_q = (q[..., 2] - q[..., 0] + 1) * (q[..., 3] - q[..., 1] + 1)
    return inter / np.maximum(area_b + area_q - inter, 1e-10)


def image_eval(
    pred: np.ndarray,
    gt: np.ndarray,
    keep_mask: np.ndarray,
    iou_thresh: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy per-image matching, `pred` score-descending.

    pred: (N, 5) xyxy+score. gt: (M, 4) xyxy. keep_mask: (M,) bool, the GT
    of the current difficulty; the others are ignore regions. Returns
    (pred_recall (N,), proposal (N,)): pred_recall[i] = kept GT matched
    within the first i+1 detections; proposal[i] = 0 where detection i
    covers an ignored GT, else 1."""
    n = len(pred)
    pred_recall = np.zeros(n, np.int32)
    proposal = np.ones(n, np.int32)
    if n == 0 or len(gt) == 0:
        return pred_recall, proposal
    overlaps = bbox_overlaps(pred[:, :4].astype(np.float64), gt.astype(np.float64))
    matched = np.zeros(len(gt), np.int32)
    recall_count = 0
    for h in range(n):
        mi = int(np.argmax(overlaps[h]))
        if overlaps[h, mi] >= iou_thresh:
            if not keep_mask[mi]:
                proposal[h] = 0
            elif matched[mi] == 0:
                matched[mi] = 1
                recall_count += 1
        pred_recall[h] = recall_count
    return pred_recall, proposal


def img_pr_info(
    thresholds: np.ndarray,
    pred_scores: np.ndarray,
    proposal: np.ndarray,
    pred_recall: np.ndarray,
) -> np.ndarray:
    """Per-image PR contributions at each score threshold: (T, 2) =
    (proposals, recall)."""
    info = np.zeros((len(thresholds), 2), np.int64)
    if len(pred_scores) == 0:
        return info
    # detections score-descending: how many score >= each threshold
    counts = np.searchsorted(-pred_scores, -thresholds, side="right")
    cum_prop = np.cumsum(proposal)
    for t, k in enumerate(counts):
        if k:
            info[t, 0] = cum_prop[k - 1]
            info[t, 1] = pred_recall[k - 1]
    return info


def voc_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """All-point interpolated AP (the WIDER eval-tools integration)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def evaluate_detections(
    detections: Sequence[np.ndarray],
    gts: Sequence[np.ndarray],
    keep_masks: Sequence[np.ndarray],
    iou_thresh: float = 0.5,
) -> float:
    """One difficulty's AP from per-image arrays: detections[i] (N_i, 5)
    xyxy+score, gts[i] (M_i, 4) xyxy, keep_masks[i] (M_i,) bool."""
    # global min-max score normalization (the official norm_score step)
    if any(len(d) for d in detections):
        all_scores = np.concatenate([d[:, 4] for d in detections if len(d)])
    else:
        all_scores = np.zeros(1)
    smin, smax = float(all_scores.min()), float(all_scores.max())
    srange = max(smax - smin, 1e-12)

    thresholds = 1.0 - (np.arange(NUM_THRESH, dtype=np.float64) + 1) / NUM_THRESH
    pr_curve = np.zeros((NUM_THRESH, 2), np.int64)
    count_face = 0
    for det, gt, keep in zip(detections, gts, keep_masks):
        count_face += int(np.sum(keep))
        det = np.asarray(det, np.float64).reshape(-1, 5)
        if len(det):
            det = det[np.argsort(-det[:, 4], kind="stable")]
            det[:, 4] = (det[:, 4] - smin) / srange
        pred_recall, proposal = image_eval(det, gt, keep, iou_thresh)
        pr_curve += img_pr_info(thresholds, det[:, 4], proposal, pred_recall)

    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pr_curve[:, 0] > 0, pr_curve[:, 1] / np.maximum(pr_curve[:, 0], 1), 0.0)
        recall = pr_curve[:, 1] / max(count_face, 1)
    return voc_ap(recall, precision)


# --------------------------------------------------------------------------- #
# official .mat ground truth
# --------------------------------------------------------------------------- #


def load_wider_gt(gt_dir: str) -> Dict[str, dict]:
    """Load the official eval-tools ground truth .mat files.

    Returns {'easy'|'medium'|'hard': {'events', 'files', 'boxes', 'keep'}}
    with per-event per-image GT boxes (xywh converted to xyxy) and keep
    masks (from MATLAB's 1-based index lists)."""
    from scipy.io import loadmat

    base = loadmat(os.path.join(gt_dir, "wider_face_val.mat"))
    sets = {name: loadmat(os.path.join(gt_dir, f"wider_{name}_val.mat")) for name in ("easy", "medium", "hard")}
    events = [str(e[0][0]) for e in base["event_list"]]
    out: Dict[str, dict] = {}
    for name, m in sets.items():
        per = {"events": events, "files": [], "boxes": [], "keep": []}
        for ei in range(len(events)):
            files = [str(f[0][0]) for f in base["file_list"][ei][0]]
            gt_boxes = base["face_bbx_list"][ei][0]
            keep_lists = m["gt_list"][ei][0]
            per["files"].append(files)
            bx, kp = [], []
            for fi in range(len(files)):
                b = np.asarray(gt_boxes[fi][0], np.float64).reshape(-1, 4)
                b = np.concatenate([b[:, :2], b[:, :2] + b[:, 2:4]], axis=1)
                k = np.zeros(len(b), bool)
                kl = np.asarray(keep_lists[fi][0]).reshape(-1)
                if kl.size:
                    k[kl.astype(int) - 1] = True  # MATLAB 1-based
                bx.append(b)
                kp.append(k)
            per["boxes"].append(bx)
            per["keep"].append(kp)
        out[name] = per
    return out


def evaluate_wider(
    det_fn,
    gt_dir: str,
    images_root: str,
    subsets: Sequence[str] = ("easy", "medium", "hard"),
    max_images: Optional[int] = None,
    on_detection=None,
    batch_det_fn=None,
    batch_chunk: int = 64,
) -> Dict[str, float]:
    """WIDER val AP against the official .mat GT.

    Either `det_fn(img_bgr) -> (boxes, scores, ...)` runs per image, or
    `batch_det_fn(images) -> [(boxes, scores, ...), ...]` runs over chunks
    of `batch_chunk` decoded images (for example
    `eval.batch_runner.batched_detect_tta`). `on_detection(rel_path, boxes,
    scores)` is called per image if given. Images are read with cv2."""
    import cv2

    gt = load_wider_gt(gt_dir)
    any_set = gt[subsets[0]]
    dets_cache: Dict[str, np.ndarray] = {}

    rels: List[str] = []
    for ei, event in enumerate(any_set["events"]):
        for fname in any_set["files"][ei]:
            if max_images is not None and len(rels) >= max_images:
                break
            rels.append(os.path.join(event, fname + ".jpg"))

    def record(rel, boxes, scores):
        if on_detection is not None:
            on_detection(rel, boxes, scores)
        dets_cache[rel] = np.concatenate([boxes.reshape(-1, 4), scores.reshape(-1, 1)], axis=1)

    def read(rel):
        img = cv2.imread(os.path.join(images_root, rel))
        if img is None:
            dets_cache[rel] = np.zeros((0, 5), np.float64)
        return img

    if batch_det_fn is not None:
        for c0 in range(0, len(rels), batch_chunk):
            loaded = [(rel, read(rel)) for rel in rels[c0 : c0 + batch_chunk]]
            loaded = [(rel, img) for rel, img in loaded if img is not None]
            if loaded:
                for (rel, _), d in zip(loaded, batch_det_fn([img for _, img in loaded])):
                    record(rel, d[0], d[1])
    else:
        for rel in rels:
            img = read(rel)
            if img is not None:
                boxes, scores = det_fn(img)[:2]
                record(rel, boxes, scores)

    results = {}
    for name in subsets:
        per = gt[name]
        d_list, g_list, k_list = [], [], []
        for ei, event in enumerate(per["events"]):
            for fi, fname in enumerate(per["files"][ei]):
                rel = os.path.join(event, fname + ".jpg")
                if rel in dets_cache:
                    d_list.append(dets_cache[rel])
                    g_list.append(per["boxes"][ei][fi])
                    k_list.append(per["keep"][ei][fi])
        results[name] = evaluate_detections(d_list, g_list, k_list)
    return results
