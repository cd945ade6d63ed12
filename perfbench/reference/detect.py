"""Frames in, detections out, in plain float32: normalisation, letterbox,
network, CenterNet decode, inverse letterbox, flip and the NMS merge.

- Normalisation: BGR frames flipped to RGB, (pixel / 255 - mean) / std.
- Letterbox: each frame's content (h, w) scaled by s = min(S / h, S / w)
  into an S x S square, centred (pad (S - w s) / 2, (S - h s) / 2); output
  pixel o samples input coordinate (o + 0.5 - pad) / s - 0.5 with
  triangular weights, and samples outside the content read 0 (black).
- Decode: sigmoid of the heatmap; a cell is a peak where it equals the
  maximum of its 3x3 neighbourhood; the K highest peaks; box centre (x +
  off_x, y + off_y), size exp(wh) where the configuration states `wh_log`
  (CenterFace's log scale) and max(wh, 0) else, landmarks (x + lm_x, y +
  lm_y), all times the stride; then (v - pad) / s, clipped to the frame.
- Flip: the letterboxed square mirrored; x of its boxes and landmarks
  taken back as (S - 1) - x, the landmark pairs re-ordered by the
  configuration's `lm_flip_perm`.
- Merge: every variant's detections at or above the score threshold, a
  greedy NMS (IoU with the +1 pixel convention, a box dropped when its IoU
  with a kept one exceeds the threshold), the highest `max_dets` kept.

Besides its own answer (`answer`), `Detector.variants` gives every cell of
every variant (box, landmarks, score, and by how much the cell's score lies
below the maximum of its neighbourhood), so that a detection can be checked
against the cell that explains it.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import registry
from perfbench.reference.model import float32_exact


def normalise(frames_rgb01: torch.Tensor, mean, std) -> torch.Tensor:
    m = torch.tensor(mean, dtype=torch.float32, device=frames_rgb01.device).view(1, 3, 1, 1)
    s = torch.tensor(std, dtype=torch.float32, device=frames_rgb01.device).view(1, 3, 1, 1)
    return (frames_rgb01 - m) / s


def letterbox_params(h: int, w: int, size: int):
    """(scale, pad_x, pad_y) of a centred letterbox, in float32 as the
    frames' coordinates are."""
    f = np.float32
    s = f(min(f(size) / f(h), f(size) / f(w)))
    return s, f((size - f(w) * s) * f(0.5)), f((size - f(h) * s) * f(0.5))


def _bilinear(n_in: int, size: int, pad: float, scale: float, device) -> torch.Tensor:
    o = torch.arange(size, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(n_in, dtype=torch.float32, device=device)[None, :]
    u = (o + 0.5 - pad) / scale - 0.5
    return (1.0 - (u - i).abs()).clamp_min(0.0)


def letterbox(frame_bgr: torch.Tensor, size: int):
    """One (h, w, 3) uint8 frame -> ((3, S, S) float32 RGB in [0, 1], scale, pad_x, pad_y)."""
    h, w, _ = frame_bgr.shape
    s, px, py = letterbox_params(h, w, size)
    x = frame_bgr.flip(-1).permute(2, 0, 1).float()  # RGB, (3, h, w)
    if (h, w) == (size, size):
        return x / 255.0, s, px, py
    wy = _bilinear(h, size, float(py), float(s), x.device)
    wx = _bilinear(w, size, float(px), float(s), x.device)
    return (wy @ x @ wx.t()) / 255.0, s, px, py


class Variant(NamedTuple):
    """One forward of one frame, decoded: per cell (H*W rows) its box and
    landmarks in frame pixels, score, and gap below its neighbourhood's
    maximum; and the indices of the K highest peaks."""

    boxes: torch.Tensor                # (N, 4)
    lms: Optional[torch.Tensor]        # (N, 5, 2)
    scores: torch.Tensor               # (N,)
    below_max: torch.Tensor            # (N,)  3x3 maximum - score, >= 0
    around: torch.Tensor               # (N,)  maximum of the 8 neighbours
    top: torch.Tensor                  # (K,) cell indices, highest first
    width: int                         # cells a row of the map


def decode_maps(maps: Dict[str, torch.Tensor], k: int, stride: int, wh_log: bool) -> List[dict]:
    """Head maps (B, H, W, C) -> per image every cell's box, landmarks,
    score and gap below the 3x3 maximum (model-input pixels), and the top-K
    peak cells."""
    hm = torch.sigmoid(maps["hm"][..., 0])
    b, h, w = hm.shape
    hmax = F.max_pool2d(hm[:, None], 3, 1, 1)[:, 0]
    padded = F.pad(hm, (1, 1, 1, 1), value=float("-inf"))
    around = torch.stack([padded[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                          for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx]).amax(0)
    peaks = torch.where(hmax == hm, hm, torch.zeros_like(hm)).reshape(b, -1)
    top = torch.topk(peaks, min(k, h * w), dim=1).indices
    ys, xs = torch.meshgrid(torch.arange(h, device=hm.device, dtype=torch.float32),
                            torch.arange(w, device=hm.device, dtype=torch.float32), indexing="ij")
    cx = (xs + maps["off"][..., 0]) * stride
    cy = (ys + maps["off"][..., 1]) * stride
    size = maps["wh"].exp() if wh_log else maps["wh"].clamp_min(0.0)
    bw = size[..., 0] * (stride / 2.0)
    bh = size[..., 1] * (stride / 2.0)
    boxes = torch.stack([cx - bw, cy - bh, cx + bw, cy + bh], dim=-1).reshape(b, -1, 4)
    lms = None
    if "lm" in maps:
        pts = maps["lm"].reshape(b, h, w, 5, 2)
        lms = torch.stack([(xs[..., None] + pts[..., 0]) * stride, (ys[..., None] + pts[..., 1]) * stride], -1)
        lms = lms.reshape(b, -1, 5, 2)
    out = []
    for i in range(b):
        out.append(dict(boxes=boxes[i], lms=None if lms is None else lms[i], scores=hm[i].reshape(-1),
                        below_max=(hmax[i] - hm[i]).reshape(-1), around=around[i].reshape(-1), top=top[i],
                        width=w))
    return out


def to_frame(v: dict, s, px, py, h: int, w: int, mirror_edge: Optional[float], perm) -> Variant:
    """A decoded variant in model-input pixels -> frame pixels (un-mirrored
    first where `mirror_edge` is given)."""
    boxes, lms = v["boxes"], v["lms"]
    if mirror_edge is not None:
        boxes = torch.stack([mirror_edge - boxes[:, 2], boxes[:, 1], mirror_edge - boxes[:, 0], boxes[:, 3]], -1)
        if lms is not None:
            lms = torch.stack([mirror_edge - lms[..., 0], lms[..., 1]], -1)[:, list(perm), :]
    pad = torch.tensor([px, py, px, py], dtype=torch.float32, device=boxes.device)
    lim = torch.tensor([w, h, w, h], dtype=torch.float32, device=boxes.device)
    boxes = torch.minimum(((boxes - pad) / float(s)).clamp_min(0.0), lim)
    if lms is not None:
        lms = torch.minimum(((lms - pad[:2]) / float(s)).clamp_min(0.0), lim[:2])
    return Variant(boxes, lms, v["scores"], v["below_max"], v["around"], v["top"], v["width"])


class Detector:
    """The reference detector of one configuration (a dict read from its
    file) on raw `variables` already on the device (`model.to_device`):
    the network of the configuration's architecture (`reference/<arch>.py`)
    and the decode below; with `low`, its network computes in float8 (the
    control)."""

    def __init__(self, cfg: dict, variables: dict, low: bool = False):
        self.cfg = cfg
        self.net = registry.reference(cfg).Network(cfg, variables, low)
        pp = cfg["preprocess"]
        self.mean, self.std = pp["mean"], pp["std"]

    @torch.no_grad()
    def variants(self, frames: Sequence[torch.Tensor], size: int, flip: bool, max_dets: int) -> List[List[Variant]]:
        """Each (h, w, 3) uint8 frame at model input `size`, and its mirror
        where `flip`: per frame the list of its variants."""
        with float32_exact():
            xs, geo = [], []
            for f in frames:
                x, s, px, py = letterbox(f, size)
                xs.append(x)
                geo.append((s, px, py, f.shape[0], f.shape[1]))
            x = normalise(torch.stack(xs), self.mean, self.std)
            if flip:
                x = torch.cat([x, x.flip(3)])
            dec = decode_maps(self.net(x), max_dets, int(self.cfg["stride"]), self.cfg["wh_log"])
        n = len(frames)
        perm = self.cfg["lm_flip_perm"]
        out = []
        for i, (s, px, py, h, w) in enumerate(geo):
            vs = [to_frame(dec[i], s, px, py, h, w, None, perm)]
            if flip:
                vs.append(to_frame(dec[n + i], s, px, py, h, w, size - 1.0, perm))
            out.append(vs)
        return out


# a reference answer counts as confident where its score lies this many
# logits above the threshold and above the cut of its variant's top K (or
# the merged list's cut), and PROMINENCE_LOGITS above each of its 8
# neighbours: rounding can then neither drop it from the answer nor move the
# peak to another cell. (Along a ridge, such as the first row of a map on
# random weights, neighbours lie within a hundredth of a logit of each
# other, and the peaks of bfloat16 and float32 fall on cells several apart.)
# The cut is the K-th highest score among the cells within PROMINENCE_LOGITS
# of their neighbourhood's maximum, each of which rounding can make a peak:
# on a plateau, such as a letterbox's padding far from the content, the
# program's rounding ties whole rows of cells, every one of them a peak,
# and they fill the top K ahead of a lower face.
CONFIDENT_LOGITS = 1.0
PROMINENCE_LOGITS = 0.5


def _logit(p):
    p = np.clip(np.asarray(p, np.float64), 1e-7, 1.0 - 1e-7)
    return np.log(p) - np.log1p(-p)


class Answer(NamedTuple):
    """The reference's answer for one frame, highest score first."""

    dets: np.ndarray                  # (N, 5) boxes and scores
    lms: Optional[np.ndarray]         # (N, 5, 2)
    confident: np.ndarray             # (N,) bool
    ids: np.ndarray                   # (N, 2) variant and cell


def _cut(v: Variant) -> float:
    """The K-th highest score (K the variant's top K) among the cells that
    lie within PROMINENCE_LOGITS of their neighbourhood's maximum; 0 where
    fewer are."""
    s = v.scores.double().clamp(1e-7, 1.0 - 1e-7)
    near = torch.logit((s + v.below_max.double()).clamp(1e-7, 1.0 - 1e-7)) - torch.logit(s) <= PROMINENCE_LOGITS
    cand = s[near]
    k = len(v.top)
    return float(torch.topk(cand, k).values[-1]) if cand.numel() >= k else 0.0


def answer(variants: Sequence[Variant], score_thresh: float, nms_thresh: Optional[float],
           max_dets: Optional[int]) -> Answer:
    """The reference's own answer for one frame: its detections at or above
    `score_thresh` (several variants merged by NMS in float64 and cut to
    `max_dets`), their landmarks, which of them are confident
    (CONFIDENT_LOGITS, PROMINENCE_LOGITS), and the variant and cell each
    came from."""
    dets, lms, floors, ids = [], [], [], []
    for vi, v in enumerate(variants):
        sc = v.scores[v.top]
        keep = sc >= score_thresh
        dets.append(torch.cat([v.boxes[v.top][keep], sc[keep, None]], 1).double().cpu().numpy())
        if v.lms is not None:
            lms.append(v.lms[v.top][keep].double().cpu().numpy())
        floor = max(_logit(score_thresh), _logit(_cut(v))) + CONFIDENT_LOGITS
        # a peak too close to a neighbour is never confident
        near = _logit(v.around[v.top][keep].double().cpu().numpy()) + PROMINENCE_LOGITS
        flat = _logit(sc[keep].double().cpu().numpy()) < near
        floors.append(np.where(flat, np.inf, floor))
        cells = v.top[keep].cpu().numpy()
        ids.append(np.stack([np.full(len(cells), vi), cells], 1))
    d, f, i = (np.concatenate(x) for x in (dets, floors, ids))
    lm = np.concatenate(lms) if lms else np.zeros((len(d), 0, 2))
    if nms_thresh is not None:
        k = nms(d, nms_thresh)
        d, lm, f, i = d[k], lm[k], f[k], i[k]
    order = np.argsort(-d[:, 4], kind="stable")
    d, lm, f, i = d[order], lm[order], f[order], i[order]
    if max_dets and len(d) > max_dets:
        f = np.maximum(f, _logit(d[max_dets - 1, 4]) + CONFIDENT_LOGITS)
        d, lm, f, i = d[:max_dets], lm[:max_dets], f[:max_dets], i[:max_dets]
    return Answer(d, lm if lms else None, _logit(d[:, 4]) >= f, i)


def nms(dets: np.ndarray, thresh: float) -> np.ndarray:
    """Greedy NMS over (N, 5) xyxy+score, scores in stable descending order;
    the kept indices."""
    x1, y1, x2, y2, s = dets.T
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = np.argsort(-s, kind="stable")
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        rest = order[1:]
        iw = np.maximum(0.0, np.minimum(x2[i], x2[rest]) - np.maximum(x1[i], x1[rest]) + 1)
        ih = np.maximum(0.0, np.minimum(y2[i], y2[rest]) - np.maximum(y1[i], y1[rest]) + 1)
        inter = iw * ih
        order = rest[inter / (areas[i] + areas[rest] - inter) <= thresh]
    return np.asarray(keep, np.int64)
