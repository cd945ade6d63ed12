"""CenterNet heads on the stride-4 map: hm / wh / off [+ lm].

Mirrors `tpucenterface/model/heads.py::_Head` and `::CenterNetHeads`, in the
separate and the fused (one wide 3x3 conv + block-diagonal 1x1) forms. The
hidden 3x3 conv runs in the compute dtype with a plain ReLU; its output is
cast to float32 before the float32 1x1 out conv. Outputs are NHWC float32
maps. The out conv is a float32 matrix product over channels (exact float32
on the GPU: matrix products do not use TF32 unless asked to).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from tpucenterface_torch.config import ModelConfig, dtype_of
from tpucenterface_torch.model.blocks import at_least_f32


class Head(nn.Module):
    def __init__(self, cin: int, out_ch: int, hidden: int, dtype: torch.dtype, bias_init=0.0):
        super().__init__()
        self.dtype = dtype
        if hidden > 0:
            self.conv = nn.Conv2d(cin, hidden, 3, padding=1)
            cin = hidden
        self.out = nn.Conv2d(cin, out_ch, 1)
        with torch.no_grad():
            self.out.bias.copy_(torch.as_tensor(bias_init, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW (channels_last) features -> NHWC float32 map."""
        if hasattr(self, "conv"):
            w, b = self.conv.weight.to(self.dtype), self.conv.bias.to(self.dtype)
            x = F.conv2d(x, w, b, 1, 1).relu()
        x = at_least_f32(x).permute(0, 2, 3, 1)
        w = self.out.weight[:, :, 0, 0]
        return torch.matmul(x, w.t()) + self.out.bias


class CenterNetHeads(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dtype = dtype_of(cfg.compute_dtype)
        c = cfg.fpn_channels
        self.fused_heads = cfg.fused_heads
        self.num_classes = cfg.num_classes
        self.names = [("hm", cfg.num_classes), ("wh", 2), ("off", 2)]
        if cfg.with_landmarks:
            self.names.append(("lm", 10))
        if cfg.fused_heads:
            total = sum(n for _, n in self.names)
            bias = [cfg.hm_bias_init] * cfg.num_classes + [0.0] * (total - cfg.num_classes)
            self.fused = Head(c, total, cfg.head_conv * len(self.names), dtype, bias)
        else:
            for name, n in self.names:
                init = cfg.hm_bias_init if name == "hm" else 0.0
                self.add_module(name, Head(c, n, cfg.head_conv, dtype, init))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if not self.fused_heads:
            return {name: getattr(self, name)(x) for name, _ in self.names}
        y = self.fused(x)
        out, c0 = {}, 0
        for name, n in self.names:
            out[name] = y[..., c0 : c0 + n]
            c0 += n
        # contiguous wh+off view: one gather for all box parameters
        out["whoff"] = y[..., self.num_classes : self.num_classes + 4]
        return out
