"""Conv+BN+ReLU6 and the MobileNetV2 inverted residual.

Mirrors `tpucenterface/model/blocks.py::ConvBN` and `::InvertedResidual`.
Tensors are NCHW in the channels_last memory format (the NHWC bytes of the JAX
package). Parameters are float32 and are cast to the compute dtype at use,
like flax's `param_dtype=float32, dtype=compute_dtype`; the Detector stores
them in the compute dtype once (`CenterFaceNet.cast_convs_`), which makes
those casts no-ops.

Cast points, as in the JAX package:
- folded ConvBN: conv + bias in the compute dtype, activation, cast;
- unfolded ConvBN: conv in the compute dtype, BatchNorm with running
  statistics in float32 (written out as flax computes it), activation, cast;
- the skip add runs in the compute dtype.
Padding is the symmetric (k-1)//2 of torch.nn.Conv2d, for stride 2 as well.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def act(x: torch.Tensor, relu6: bool) -> torch.Tensor:
    return x.clamp(0.0, 6.0) if relu6 else x.relu()


class BatchNorm(nn.Module):
    """Inference BatchNorm with running statistics (the flax `bn` scope)."""

    def __init__(self, c: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean.view(shape)) * mul.view(shape)
        return y + self.bias.view(shape)


class ConvBN(nn.Module):
    """Conv -> BatchNorm (or folded bias) -> optional ReLU6."""

    def __init__(
        self,
        cin: int,
        cout: int,
        kernel: int = 3,
        stride: int = 1,
        groups: int = 1,
        act: bool = True,
        relu6: bool = True,
        bn_eps: float = 1e-5,
        dtype: torch.dtype = torch.bfloat16,
        folded: bool = False,
        bn_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.stride = stride
        self.padding = (kernel - 1) // 2
        self.groups = groups
        self.act = act
        self.relu6 = relu6
        self.dtype = dtype
        self.folded = folded
        self.bn_dtype = bn_dtype
        self.conv = nn.Conv2d(
            cin, cout, kernel, stride, self.padding, groups=groups, bias=folded
        )
        if not folded:
            self.bn = BatchNorm(cout, bn_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.weight.to(self.dtype)
        b = self.conv.bias.to(self.dtype) if self.folded else None
        x = F.conv2d(x, w, b, self.stride, self.padding, 1, self.groups)
        if not self.folded:
            x = self.bn(x.to(self.bn_dtype))
        if self.act:
            x = act(x, self.relu6)
        return x.to(self.dtype)


class InvertedResidual(nn.Module):
    """MobileNetV2 block: 1x1 expand -> 3x3 depthwise -> 1x1 project (+skip)."""

    def __init__(self, cin: int, cout: int, stride: int, expand: int, **kw):
        super().__init__()
        hidden = cin * expand
        self.use_skip = stride == 1 and cin == cout
        if expand != 1:
            self.expand = ConvBN(cin, hidden, kernel=1, **kw)
        self.depthwise = ConvBN(hidden, hidden, kernel=3, stride=stride, groups=hidden, **kw)
        self.project = ConvBN(hidden, cout, kernel=1, act=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.expand(x) if hasattr(self, "expand") else x
        y = self.project(self.depthwise(y))
        return y + x if self.use_skip else y
