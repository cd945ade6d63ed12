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
from tpucenterface_torch.weights.convert import (
    state_dict_from_variables,
    variables_from_state_dict,
)


class CenterFaceNet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = MobileNetV2Backbone(cfg)
        self.neck = FPNLiteNeck(cfg)
        self.heads = CenterNetHeads(cfg)

    def forward(self, x_nhwc: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
        x = x_nhwc.permute(0, 3, 1, 2)
        return self.heads(self.neck(self.backbone(x, train), train=train))

    def cast_convs_(self) -> "CenterFaceNet":
        """Store the weights and biases of every compute-dtype convolution in
        the compute dtype, so the forward's casts at use cost nothing. The
        values the forward computes do not change; BatchNorm and the heads'
        float32 out convs stay float32."""
        for m in self.modules():
            if isinstance(m, (ConvBN, Head)) and hasattr(m, "conv"):
                m.conv.to(m.dtype)
        return self


def load_network(variables: Dict[str, Any], cfg: ModelConfig, device: torch.device) -> CenterFaceNet:
    """The inference network of JAX-layout `variables` on `device`: eval mode,
    no gradients, compute-dtype convolutions stored in the compute dtype,
    channels_last."""
    net = CenterFaceNet(cfg)
    net.load_state_dict(state_dict_from_variables(variables), strict=True)
    net.requires_grad_(False).eval().cast_convs_()
    return net.to(device=device, memory_format=torch.channels_last)


def init_model(cfg: ModelConfig, seed: int = 0) -> Tuple[CenterFaceNet, Dict[str, Any]]:
    """Random unfolded network from `seed`; returns (module, JAX-layout
    variables {'params', 'batch_stats'} as numpy).

    The draws follow flax's initializers (`tpucenterface/model/centernet.py::
    init_model` through `nn.Conv`, `nn.BatchNorm` and `model/heads.py`), so
    the distributions are the JAX package's; the values differ, as the
    generators do:
    - every conv kernel `lecun_normal`: variance_scaling(1, fan_in,
      truncated_normal), a normal of std sqrt(1/fan_in)/0.87962566 cut at
      two of its stds, fan_in = kh*kw*Cin/groups (9 for a depthwise kernel);
    - conv biases 0, but the heads' out biases: the heatmap prior
      `cfg.hm_bias_init` on the hm channels, 0 on the others;
    - BatchNorm scale 1, bias 0, running mean 0, running variance 1.
    Kernels are drawn in module order from a `torch.Generator` seeded with
    `seed`; the global RNG is left as it was."""
    gen = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        model = CenterFaceNet(cfg)
    with torch.no_grad():
        for name, m in model.named_modules():
            if not isinstance(m, nn.Conv2d):
                continue
            std = (1.0 / m.weight[0].numel()) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
            if m.bias is not None and not name.endswith(".out"):
                m.bias.zero_()  # a Head sets its out bias to the prior itself
    return model, variables_from_state_dict(model.state_dict())
