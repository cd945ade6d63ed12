"""MobileNetV2-class backbone emitting stride-4/8/16/32 features.

Mirrors `tpucenterface/model/backbone.py::backbone_plan` and
`::MobileNetV2Backbone`. Blocks are named `block_<i>` like the flax scopes, so
`weights.convert` maps parameters one for one. With `ModelConfig.s2d_stem`
the input goes through a 2x space-to-depth, channels in the JAX order
(dy, dx, c), and a 2x2 / stride-1 stem padded ((1, 0), (1, 0)): the 3x3 /
stride-2 stem exactly, given `weights.fold.s2d_remap_stem`'s kernel.
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


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2), channels_last, channel (dy*2 + dx)*C
    + c holding x[..., c, 2r + dy, 2s + dx] (the JAX reshape of NHWC
    (b, h/2, 2, w/2, 2, c) to (b, h/2, w/2, 4c))."""
    b, c, h, w = x.shape
    y = x.permute(0, 2, 3, 1).reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, h // 2, w // 2, 4 * c).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


class MobileNetV2Backbone(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        kw = block_kwargs(cfg)
        self.dtype = kw["dtype"]
        self.plan = backbone_plan(cfg)
        self.s2d = cfg.s2d_stem
        if self.s2d:
            self.stem = ConvBN(12, cfg.width(cfg.stem_channels), kernel=2, stride=1, padding=((1, 0), (1, 0)), **kw)
        else:
            self.stem = ConvBN(3, cfg.width(cfg.stem_channels), kernel=3, stride=2, **kw)
        cin = cfg.width(cfg.stem_channels)
        for i, (t, c, s, _) in enumerate(self.plan):
            self.add_module(f"block_{i}", InvertedResidual(cin, c, s, t, **kw))
            cin = c

    def forward(self, x: torch.Tensor, train: bool = False) -> Dict[int, torch.Tensor]:
        x = x.to(self.dtype)
        if self.s2d:
            x = space_to_depth(x)
        x = self.stem(x, train)
        feats: Dict[int, torch.Tensor] = {}
        for i, (_, _, _, out_stride) in enumerate(self.plan):
            x = getattr(self, f"block_{i}")(x, train)
            if _is_skip(self.plan, i):
                feats[out_stride] = x
        return feats
