"""CenterNet losses on NHWC float32 maps.

Mirrors `tpucenterface/train/losses.py` (`focal_loss`, `gather_at_ind`,
`masked_l1`, `detection_loss`):
- the penalty-reduced pixelwise focal loss on the heatmap (alpha 2, beta 4),
  the sigmoid clipped to [1e-4, 1 - 1e-4], normalized by max(positives, 1);
- masked L1 on wh, offset (and landmarks), gathered at the GT center indices,
  divided by the mask summed over the channels (CenterNet's RegL1Loss).
Every value stays a device tensor: nothing here waits for the device.

Target layout (`data.targets`): hm (B, H, W, C) in [0, 1], ind (B, M) flat
y*W+x indices, mask (B, M), wh and off (B, M, 2) [, lm (B, M, 10), lm_mask].
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tpucenterface_torch.config import TrainConfig


def focal_loss(
    hm_logits: torch.Tensor, hm_target: torch.Tensor, alpha: float = 2.0, beta: float = 4.0
) -> torch.Tensor:
    """Penalty-reduced focal loss (CenterNet `_neg_loss` variant), scalar."""
    pred = torch.sigmoid(hm_logits).clamp(1e-4, 1.0 - 1e-4)
    pos = (hm_target >= 1.0).to(pred.dtype)
    neg_weight = torch.pow(1.0 - hm_target, beta)
    pos_loss = -torch.log(pred) * torch.pow(1.0 - pred, alpha) * pos
    neg_loss = -torch.log(1.0 - pred) * torch.pow(pred, alpha) * neg_weight * (1.0 - pos)
    num_pos = pos.sum().clamp_min(1.0)
    return (pos_loss.sum() + neg_loss.sum()) / num_pos


def gather_at_ind(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C), (B, M) -> (B, M, C) gather at flat spatial indices."""
    b, h, w, c = feat.shape
    flat = feat.reshape(b, h * w, c)
    return torch.gather(flat, 1, ind.long()[..., None].expand(-1, -1, c))


def masked_l1(
    pred_map: torch.Tensor, target: torch.Tensor, ind: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Mean L1 at active GT indices; the divisor counts mask * channels."""
    pred = gather_at_ind(pred_map, ind)
    m = mask[..., None].to(pred.dtype).expand_as(pred)
    loss = (pred - target).abs() * m
    return loss.sum() / m.sum().clamp_min(1.0)


def detection_loss(
    outputs: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor], cfg: TrainConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted CenterNet loss; returns (total, per-term metrics)."""
    hm_l = focal_loss(outputs["hm"], targets["hm"], alpha=cfg.focal_alpha, beta=cfg.focal_beta)
    wh_l = masked_l1(outputs["wh"], targets["wh"], targets["ind"], targets["mask"])
    off_l = masked_l1(outputs["off"], targets["off"], targets["ind"], targets["mask"])
    total = cfg.hm_weight * hm_l + cfg.wh_weight * wh_l + cfg.off_weight * off_l
    metrics = {"loss": total, "hm_loss": hm_l, "wh_loss": wh_l, "off_loss": off_l}
    if "lm" in outputs and "lm" in targets:
        lm_l = masked_l1(outputs["lm"], targets["lm"], targets["ind"], targets["lm_mask"])
        total = total + cfg.lm_weight * lm_l
        metrics["lm_loss"] = lm_l
        metrics["loss"] = total
    return total, metrics
