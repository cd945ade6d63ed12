"""The comparison that decides `correct`.

What the timed path returned for a sample of its frames is held to the plain
reference (`perfbench/reference/`), frame by frame. Each detection the
program returned is matched to the cell of the reference (of any variant:
scale and mirror) that explains it best: the largest coordinate difference
of box and landmarks, in frame pixels, plus PX_PER_LOGIT times the gap of
the scores in logits. Per detection that gives

- `box_px`: the coordinate difference;
- `center_px`: the same of the box's centre alone;
- `score_gap`: the score's gap to the reference cell's, in logits;
- `peak_gap`: by how much the reference cell's score lies below the maximum
  of its 3x3 neighbourhood, in logits: 0 where the detection is a peak of
  the reference;

per confident answer of the reference (below) whose own cell explains a
returned detection (the nearest to the answer's box, where several),

- `sure_score_gap`: the gap of the two scores, in logits;
- `sure_box_px`: the largest gap of the four box coordinates, in frame
  pixels;
- `sure_lm_px`: the largest gap of the ten landmark coordinates (landmark
  models only);

where rounding can move neither the peak nor the cut, so the whole path
(sigmoid, gathers, offsets, sizes, landmarks, the flip's pairs) shows in
them unmixed with the choice of cell. (An answer that the merge of the
variants replaced by another variant's box, as near-equal scores of a face
and its mirror may, has no returned detection of its own cell and adds
nothing here; `missed` holds it.) And per frame

- `count_gap`: the difference between the number of detections returned
  and the number of the reference's own answer, as a share of the latter
  (of 20 at least);
- `missed`: the reference's confident answers (`reference.detect.answer`:
  well above the threshold and the cut, and well above each neighbour)
  that no returned detection explains: none is matched to a cell within
  NEIGHBOURS cells of the answer's (in the same variant), and none overlaps
  it by an IoU of MISSED_IOU or more (another variant's box that suppressed
  it in the merge). Rounding cannot lose such an answer, so a sound run
  reads 0.

A number compared is a statistic of one of these over the sample:
`<name>.max`, `.mean`, `.p99`, `.p90` or `.sum` (`statistic`), named in
`limits/<cell>.json` beside its limit; PERF.md gives the readings of sound
runs and of the control that each limit was set from. Matching by geometry,
rather than pairing ranks, keeps the check blind to what rounding may
legitimately change: the order of near-equal peaks, which of two near-equal
neighbours is the peak, an exact tie kept twice, a box at the IoU threshold
kept by one NMS and dropped by the other.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

NUMBERS = ("score_gap", "box_px", "center_px", "peak_gap", "count_gap", "missed", "sure_score_gap", "sure_box_px",
           "sure_lm_px")
MISSED_IOU = 0.3
NEIGHBOURS = 2
_EPS = 1e-7


def logit(p):
    p = np.clip(np.asarray(p, np.float64), _EPS, 1.0 - _EPS)
    return np.log(p) - np.log1p(-p)


# frame pixels that one logit of score difference counts for in the match
PX_PER_LOGIT = 4.0


@torch.no_grad()
def nearest_cells(boxes: torch.Tensor, lms: Optional[torch.Tensor], logits: torch.Tensor, variants,
                  chunk: int = 16):
    """For each of M detections, (distance, variant, cell) of the reference
    cell over all `variants` that explains it best: the largest coordinate
    gap of box and landmarks plus PX_PER_LOGIT times the score's logit gap,
    so that cells whose boxes the frame's edge clipped alike are told apart
    by their scores. `distance` is the coordinate gap alone."""
    m = boxes.shape[0]
    best = torch.full((m,), float("inf"), device=boxes.device, dtype=torch.float64)
    dist = torch.zeros((m,), device=boxes.device)
    where = torch.zeros((m, 2), dtype=torch.long, device=boxes.device)
    ours = boxes if lms is None else torch.cat([boxes, lms.reshape(-1, 10)], 1)
    for vi, v in enumerate(variants):
        cand = v.boxes if lms is None else torch.cat([v.boxes, v.lms.reshape(-1, 10)], 1)
        cl = torch.logit(v.scores.double().clamp(_EPS, 1 - _EPS))
        for c0 in range(0, m, chunk):
            sl = slice(c0, c0 + chunk)
            geo = (ours[sl, None, :] - cand[None]).abs().amax(-1)  # (chunk, N)
            cost = geo.double() + PX_PER_LOGIT * (logits[sl, None] - cl[None]).abs()
            c, cell = cost.min(1)
            better = c < best[sl]
            best[sl] = torch.where(better, c, best[sl])
            dist[sl] = torch.where(better, geo.gather(1, cell[:, None])[:, 0], dist[sl])
            where[sl, 0] = torch.where(better, torch.full_like(cell, vi), where[sl, 0])
            where[sl, 1] = torch.where(better, cell, where[sl, 1])
    return dist, where


def iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(A, B) IoU of xyxy boxes with the +1 pixel convention of the NMS, so
    that boxes which the frame's edge clipped to a line still meet."""
    iw = np.clip(np.minimum(a[:, None, 2], b[None, :, 2]) - np.maximum(a[:, None, 0], b[None, :, 0]) + 1, 0, None)
    ih = np.clip(np.minimum(a[:, None, 3], b[None, :, 3]) - np.maximum(a[:, None, 1], b[None, :, 1]) + 1, 0, None)
    inter = iw * ih
    area = lambda x: (x[:, 2] - x[:, 0] + 1) * (x[:, 3] - x[:, 1] + 1)  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None, :] - inter)


def compare_frame(boxes: np.ndarray, scores: np.ndarray, lms: Optional[np.ndarray], variants,
                  reference_answer) -> Dict[str, np.ndarray]:
    """One frame: the program's detections (boxes (M, 4), scores (M,),
    landmarks (M, 5, 2) or None) against the reference's variants of the
    frame and its own answer (`reference.detect.answer`). Per detection its
    box, centre, score and peak gaps (arrays of M), per confident answer
    explained its score, box and landmark gaps, and the frame's count gap
    and missed answers (arrays of 1)."""
    m = len(scores)
    ref = reference_answer
    out = {"score_gap": np.zeros(m), "box_px": np.zeros(m), "center_px": np.zeros(m), "peak_gap": np.zeros(m),
           "count_gap": np.array([abs(m - len(ref.dets)) / max(len(ref.dets), 20)]),
           "sure_score_gap": np.zeros(0), "sure_box_px": np.zeros(0), "sure_lm_px": np.zeros(0)}
    sure, sure_ids = ref.dets[ref.confident], ref.ids[ref.confident]
    if m == 0:
        out["missed"] = np.array([float(len(sure))])
        return out
    dev = variants[0].boxes.device
    b = torch.as_tensor(np.asarray(boxes, np.float32), device=dev)
    lm = None if lms is None else torch.as_tensor(np.asarray(lms, np.float32), device=dev)
    mine = logit(scores)
    dist, where = nearest_cells(b, lm, torch.as_tensor(mine, device=dev), variants)
    out["box_px"] = dist.double().cpu().numpy()
    for vi, v in enumerate(variants):
        sel = (where[:, 0] == vi).cpu().numpy()
        if sel.any():
            cells = where[torch.from_numpy(sel).to(dev), 1]
            s = v.scores[cells].double().cpu().numpy()
            out["score_gap"][sel] = np.abs(mine[sel] - logit(s))
            rb = v.boxes[cells].double()
            pb = b[torch.from_numpy(sel).to(dev)].double()
            centre_gap = (pb[:, :2] + pb[:, 2:]) / 2 - (rb[:, :2] + rb[:, 2:]) / 2
            out["center_px"][sel] = centre_gap.abs().amax(1).cpu().numpy()
            out["peak_gap"][sel] = logit(s + v.below_max[cells].double().cpu().numpy()) - logit(s)
    hit = np.zeros(len(sure), bool)
    if len(sure):
        w = np.array([v.width for v in variants])
        got = where.cpu().numpy()
        near = ((sure_ids[:, None, 0] == got[None, :, 0])
                & (np.abs(sure_ids[:, None, 1] // w[sure_ids[:, None, 0]] - got[None, :, 1] // w[got[None, :, 0]])
                   <= NEIGHBOURS)
                & (np.abs(sure_ids[:, None, 1] % w[sure_ids[:, None, 0]] - got[None, :, 1] % w[got[None, :, 0]])
                   <= NEIGHBOURS))
        pb = np.asarray(boxes, np.float64)
        hit = near.any(1) | (iou(sure[:, :4], pb).max(1) >= MISSED_IOU)
        exact = (sure_ids[:, None, 0] == got[None, :, 0]) & (sure_ids[:, None, 1] == got[None, :, 1])
        gap = np.where(exact, np.abs(sure[:, None, :4] - pb[None]).max(-1), np.inf)  # (S, M)
        s = np.flatnonzero(exact.any(1))
        j = gap[s].argmin(1)
        out["sure_box_px"] = gap[s, j]
        out["sure_score_gap"] = np.abs(logit(sure[s, 4]) - mine[j])
        if lms is not None and ref.lms is not None:
            sure_lm = ref.lms[ref.confident][s].reshape(len(s), 10)
            out["sure_lm_px"] = np.abs(sure_lm - np.asarray(lms, np.float64).reshape(m, 10)[j]).max(1, initial=0.0)
    out["missed"] = np.array([float(len(sure) - hit.sum())])
    return out


STATS = {"max": np.max, "mean": np.mean, "sum": np.sum,
         "p99": lambda v: np.percentile(v, 99), "p90": lambda v: np.percentile(v, 90)}


def statistic(per_frame: Sequence[Dict[str, np.ndarray]], name: str) -> float:
    """`<number>.<stat>` over the sample; 0 where there is nothing to read."""
    number, stat = name.split(".")
    v = np.concatenate([f[number] for f in per_frame]) if per_frame else np.zeros(0)
    return float(STATS[stat](v)) if v.size else 0.0


def summary(per_frame: Sequence[Dict[str, np.ndarray]]) -> Dict[str, list]:
    """Per number: its values' count, mean, median, 90th, 99th percentile
    and maximum over the sample (each detection, or each frame)."""
    out = {}
    for k in NUMBERS:
        v = np.concatenate([f[k] for f in per_frame]) if per_frame else np.zeros(0)
        out[k] = [int(v.size)] + ([float(v.mean())] + [float(q) for q in np.percentile(v, [50, 90, 99, 100])]
                                  if v.size else [])
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True where every number compared is finite and within its limit."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
