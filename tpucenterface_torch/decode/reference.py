"""Reference CenterNet decode in plain torch.

Mirrors `tpucenterface/decode/reference.py::pseudo_nms`, `decode_feats`,
`topk_2stage`, `decode_feats_with_idx`, `decode_landmarks`,
`boxes_to_original` and `landmarks_to_original`:

    scores = sigmoid(hm)
    keep   = (maxpool3x3(scores) == scores)   # -inf borders, plateaus all kept
    top-k over the flattened masked map
    gather wh/off at the peaks -> corner boxes * stride

`torch.topk` does not define the order of tied values. `lax.top_k` puts the
lowest flat index first; `topk_lowest_index` reproduces that with a stable
descending sort, and `topk_2stage` takes stable sorts at both of its stages
so its chunk-rank tie order matches the JAX package's too.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from tpucenterface_torch.config import DecodeConfig


def pseudo_nms(scores: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> scores where the cell is its own 3x3 maximum, else 0."""
    p = F.pad(scores, (0, 0, 1, 1), value=float("-inf"))
    v = torch.maximum(torch.maximum(p[:, :-2], p[:, 1:-1]), p[:, 2:])
    p = F.pad(v, (1, 1), value=float("-inf"))
    hmax = torch.maximum(torch.maximum(p[..., :-2], p[..., 1:-1]), p[..., 2:])
    return torch.where(hmax == scores, scores, torch.zeros_like(scores))


def topk_lowest_index(flat: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis with `lax.top_k`'s tie order (lowest index first)."""
    vals, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_2stage(
    flat: torch.Tensor, k: int, chunk: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-by-value two-stage top-k over (B, N): per-chunk maxima, top-k of
    the chunks, then top-k of the K winning chunks' cells. Exactly tied
    values are ordered by chunk rank, as in the JAX package."""
    b, n = flat.shape
    chunk = 8 if chunk is None else chunk
    if n % chunk or n // chunk <= k:
        return topk_lowest_index(flat, k)
    m = n // chunk
    chunks = flat.reshape(b, m, chunk)
    cmax = chunks.amax(dim=-1)                          # (B, M)
    _, cidx = topk_lowest_index(cmax, k)                # (B, K) winning chunks
    cand = torch.gather(chunks, 1, cidx[..., None].expand(b, k, chunk))
    cand_idx = cidx[..., None] * chunk + torch.arange(chunk, device=flat.device)
    vals, pos = topk_lowest_index(cand.reshape(b, k * chunk), k)
    idx = torch.gather(cand_idx.reshape(b, k * chunk), 1, pos)
    return vals, idx


def gather_cells(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C), idx (B, K) flat cell indices -> (B, K, C)."""
    b, h, w, c = x.shape
    return torch.gather(x.reshape(b, h * w, c), 1, idx[..., None].expand(-1, -1, c))


def boxes_from_cells(
    idx: torch.Tensor, wh: torch.Tensor, off: torch.Tensor, w: int, cfg: DecodeConfig
) -> torch.Tensor:
    """Corner boxes (B, K, 4) in input pixels from flat peak indices and the
    gathered wh (B, K, 2) and off (B, K, 2)."""
    ys = torch.div(idx, w, rounding_mode="floor").float()
    xs = (idx % w).float()
    cx = xs + off[..., 0]
    cy = ys + off[..., 1]
    if cfg.wh_log:
        bw, bh = torch.exp(wh[..., 0]), torch.exp(wh[..., 1])
    else:
        # an untrained wh head can emit negative sizes; clamp like the golden
        bw, bh = wh[..., 0].clamp_min(0.0), wh[..., 1].clamp_min(0.0)
    s = float(cfg.stride)
    return torch.stack(
        [(cx - bw / 2.0) * s, (cy - bh / 2.0) * s, (cx + bw / 2.0) * s, (cy + bh / 2.0) * s],
        dim=-1,
    )


def decode_feats_with_idx(
    feats: Dict[str, torch.Tensor], cfg: DecodeConfig, peaks: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Head maps -> (boxes (B,K,4) in model-input pixels, scores (B,K),
    flat peak indices (B,K)); K = min(max_dets, H*W). `peaks` (B,H,W) is the
    peak-masked score map where the caller has computed it already (the
    fused dense stage, `decode.fused_nms`)."""
    hm = feats["hm"]
    b, h, w, _ = hm.shape
    k = min(cfg.max_dets, h * w)
    if peaks is None:
        peaks = pseudo_nms(torch.sigmoid(hm[..., 0]))
    elif peaks.shape != (b, h, w):
        raise ValueError(f"peaks must be {(b, h, w)}, got {tuple(peaks.shape)}")
    flat = peaks.reshape(b, h * w)
    if cfg.fast_topk:
        top_scores, top_idx = topk_2stage(flat, k)
    else:
        top_scores, top_idx = topk_lowest_index(flat, k)
    if "whoff" in feats:
        g = gather_cells(feats["whoff"], top_idx)   # one gather for wh + off
        wh_g, off_g = g[..., 0:2], g[..., 2:4]
    else:
        wh_g = gather_cells(feats["wh"], top_idx)
        off_g = gather_cells(feats["off"], top_idx)
    return boxes_from_cells(top_idx, wh_g, off_g, w, cfg), top_scores, top_idx


def decode_feats(
    feats: Dict[str, torch.Tensor], cfg: DecodeConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Head maps -> (boxes (B,K,4) [x1,y1,x2,y2] in model-input pixels,
    scores (B,K)); landmarks, where the model has them, come from
    `decode_landmarks`."""
    boxes, scores, _ = decode_feats_with_idx(feats, cfg)
    return boxes, scores


def decode_landmarks(
    feats: Dict[str, torch.Tensor], top_idx: torch.Tensor, cfg: DecodeConfig
) -> torch.Tensor:
    """Gather the 5-point landmark head at the peaks -> (B, K, 5, 2) pixels."""
    w = feats["lm"].shape[2]
    pts = gather_cells(feats["lm"], top_idx).reshape(top_idx.shape[0], -1, 5, 2)
    ys = torch.div(top_idx, w, rounding_mode="floor").float()
    xs = (top_idx % w).float()
    s = float(cfg.stride)
    return torch.stack(
        [(xs[..., None] + pts[..., 0]) * s, (ys[..., None] + pts[..., 1]) * s], dim=-1
    )


def boxes_to_original(
    boxes: torch.Tensor, scale: torch.Tensor, pad_xy: torch.Tensor, orig_hw: torch.Tensor
) -> torch.Tensor:
    """Inverse letterbox, batched: boxes (B, K, 4), scale (B,), pad_xy (B, 2),
    orig_hw (B, 2) [h, w] -> boxes clipped to each original image."""
    pad = torch.cat([pad_xy, pad_xy], dim=-1)[:, None, :]
    out = (boxes - pad) / scale[:, None, None]
    h = orig_hw[:, 0].to(boxes.dtype)
    w = orig_hw[:, 1].to(boxes.dtype)
    lim = torch.stack([w, h, w, h], dim=-1)[:, None, :]
    return torch.minimum(out.clamp_min(0.0), lim)


def landmarks_to_original(
    lm: torch.Tensor, scale: torch.Tensor, pad_xy: torch.Tensor, orig_hw: torch.Tensor
) -> torch.Tensor:
    """Inverse letterbox for landmark points, batched: lm (B, K, 5, 2)."""
    out = (lm - pad_xy[:, None, None, :]) / scale[:, None, None, None]
    lim = torch.stack([orig_hw[:, 1], orig_hw[:, 0]], dim=-1).to(lm.dtype)
    return torch.minimum(out.clamp_min(0.0), lim[:, None, None, :])
