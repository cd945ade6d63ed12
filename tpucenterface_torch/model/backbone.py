"""MobileNetV2-class backbone emitting stride-4/8/16/32 features.

Mirrors `tpucenterface/model/backbone.py::backbone_plan` and
`::MobileNetV2Backbone`. Blocks are named `block_<i>` like the flax scopes, so
`weights.convert` maps parameters one for one.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from tpucenterface_torch.config import ModelConfig, dtype_of
from tpucenterface_torch.model.blocks import ConvBN, InvertedResidual


def backbone_plan(cfg: ModelConfig) -> List[Tuple[int, int, int, int]]:
    """Flatten inverted_residual_setting into per-block (expand, ch, stride, out_stride)."""
    plan = []
    out_stride = 2  # after stem
    for t, c, n, s in cfg.inverted_residual_setting:
        for i in range(n):
            stride = s if i == 0 else 1
            out_stride *= stride
            plan.append((t, cfg.width(c), stride, out_stride))
    return plan


def _is_skip(plan, i: int) -> bool:
    """The finest feature at each stride >= 4 is recorded before the plan
    downsamples past it (backbone.py:72-79 of the JAX package)."""
    out_stride = plan[i][3]
    nxt = plan[i + 1] if i + 1 < len(plan) else None
    return out_stride >= 4 and (nxt is None or nxt[3] > out_stride)


def feature_channels(cfg: ModelConfig) -> Dict[int, int]:
    """{stride: channels} of the features the backbone returns."""
    plan = backbone_plan(cfg)
    return {plan[i][3]: plan[i][1] for i in range(len(plan)) if _is_skip(plan, i)}


def block_kwargs(cfg: ModelConfig) -> dict:
    return dict(
        relu6=cfg.relu6,
        bn_eps=cfg.bn_eps,
        bn_momentum=cfg.bn_momentum,
        dtype=dtype_of(cfg.compute_dtype),
        folded=cfg.folded,
        bn_dtype=dtype_of(cfg.bn_compute_dtype),
    )


class MobileNetV2Backbone(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.s2d_stem:
            raise NotImplementedError("the port has no space-to-depth stem yet")
        kw = block_kwargs(cfg)
        self.dtype = kw["dtype"]
        self.plan = backbone_plan(cfg)
        self.stem = ConvBN(3, cfg.width(cfg.stem_channels), kernel=3, stride=2, **kw)
        cin = cfg.width(cfg.stem_channels)
        for i, (t, c, s, _) in enumerate(self.plan):
            self.add_module(f"block_{i}", InvertedResidual(cin, c, s, t, **kw))
            cin = c

    def forward(self, x: torch.Tensor, train: bool = False) -> Dict[int, torch.Tensor]:
        x = self.stem(x.to(self.dtype), train)
        feats: Dict[int, torch.Tensor] = {}
        for i, (_, _, _, out_stride) in enumerate(self.plan):
            x = getattr(self, f"block_{i}")(x, train)
            if _is_skip(self.plan, i):
                feats[out_stride] = x
        return feats
