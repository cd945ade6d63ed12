"""FPN-lite neck: top-down fusion of stride-32..4 features to one stride-4 map.

Mirrors `tpucenterface/model/neck.py::FPNLiteNeck`: nearest x2 upsample, add
the 1x1 lateral, then the 3x3 smooth conv.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpucenterface_torch.config import ModelConfig
from tpucenterface_torch.model.backbone import block_kwargs, feature_channels
from tpucenterface_torch.model.blocks import ConvBN


class FPNLiteNeck(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        kw = block_kwargs(cfg)
        chans = feature_channels(cfg)
        self.strides = sorted(chans, reverse=True)  # [32, 16, 8, 4]
        c = cfg.fpn_channels
        for s in self.strides:
            self.add_module(f"lateral_{s}", ConvBN(chans[s], c, kernel=1, **kw))
        for s in self.strides[1:]:
            self.add_module(f"smooth_{s}", ConvBN(c, c, kernel=3, **kw))

    def forward(
        self, feats: Dict[int, torch.Tensor], top_lateral: Optional[torch.Tensor] = None, train: bool = False
    ) -> torch.Tensor:
        """`top_lateral`, where given, stands for the top lateral's output (a
        caller that has folded that 1x1 conv into the backbone passes it)."""
        top = self.strides[0]
        y = getattr(self, f"lateral_{top}")(feats[top], train) if top_lateral is None else top_lateral
        for s in self.strides[1:]:
            lat = getattr(self, f"lateral_{s}")(feats[s], train)
            y = F.interpolate(y, scale_factor=2, mode="nearest") + lat
            y = getattr(self, f"smooth_{s}")(y, train)
        return y  # stride 4, fpn_channels wide
