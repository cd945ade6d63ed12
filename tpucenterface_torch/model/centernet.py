"""Full detector network: backbone -> neck -> heads.

Mirrors `tpucenterface/model/centernet.py::CenterFaceNet` and `::init_model`.
The public API is the JAX package's: an NHWC image batch in, a dict of NHWC
float32 stride-4 maps out ({'hm', 'wh', 'off'[, 'lm'][, 'whoff']}), so arrays
compare directly. Inside, the NHWC input is viewed as NCHW in the
channels_last memory format, which is the same bytes.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from tpucenterface_torch.config import ModelConfig
from tpucenterface_torch.model.backbone import MobileNetV2Backbone
from tpucenterface_torch.model.blocks import ConvBN
from tpucenterface_torch.model.heads import CenterNetHeads, Head
from tpucenterface_torch.model.neck import FPNLiteNeck
from tpucenterface_torch.weights.convert import variables_from_state_dict


class CenterFaceNet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = MobileNetV2Backbone(cfg)
        self.neck = FPNLiteNeck(cfg)
        self.heads = CenterNetHeads(cfg)

    def forward(self, x_nhwc: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x_nhwc.permute(0, 3, 1, 2)
        return self.heads(self.neck(self.backbone(x)))

    def cast_convs_(self) -> "CenterFaceNet":
        """Store the weights and biases of every compute-dtype convolution in
        the compute dtype, so the forward's casts at use cost nothing. The
        values the forward computes do not change; BatchNorm and the heads'
        float32 out convs stay float32."""
        for m in self.modules():
            if isinstance(m, (ConvBN, Head)) and hasattr(m, "conv"):
                m.conv.to(m.dtype)
        return self


def init_model(cfg: ModelConfig, seed: int = 0) -> Tuple[CenterFaceNet, Dict[str, Any]]:
    """Random unfolded network from `seed`; returns (module, JAX-layout
    variables {'params', 'batch_stats'} as numpy). torch's own initializers
    draw the weights, so the values differ from the JAX package's init."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = CenterFaceNet(cfg)
    return model, variables_from_state_dict(model.state_dict())
