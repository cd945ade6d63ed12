"""Conv+BN+ReLU6 and the MobileNetV2 inverted residual.

Mirrors `tpucenterface/model/blocks.py::ConvBN` (with its `padding`
override and `as_matmul`, the JAX `MatmulConv1x1`) and `::InvertedResidual`.
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
Padding is the symmetric (k-1)//2 of torch.nn.Conv2d, for stride 2 as well,
unless `padding=((top, bottom), (left, right))` overrides it (the s2d stem's
((1, 0), (1, 0))): that one is an explicit zero pad ahead of the conv.
`as_matmul=True` computes a 1x1 / stride-1 / ungrouped conv as a reshape, a
matrix product in the compute dtype and a reshape, the folded bias added
after the product (in the compute dtype, as the JAX module adds it); its
parameters are the conv's, so it loads from the same tree.

The forwards take `train` as the flax modules do. BatchNorm in train mode is
flax's `nn.BatchNorm(use_running_average=False)` written out in torch ops
(`torch.nn.BatchNorm2d` keeps the unbiased variance and weighs the new
value by its momentum, so it matches neither): batch statistics over
(N, H, W) in float32 as mean(x^2) - mean(x)^2 clipped at 0
(`flax.linen.normalization._compute_stats`, use_fast_variance=True), the
normalized output cast to `bn_dtype` by the caller, and the new running
statistics m*ra + (1-m)*batch with the biased variance. Those are not
written into the module's buffers: each train-mode forward leaves them in
`BatchNorm.updated_stats`, and the train step collects them once, after the
forward that computed them (a recompute under `torch.utils.checkpoint`
writes the attribute again but is never collected), as flax returns them
through `mutable=['batch_stats']`. A data-parallel train step sets
`BatchNorm.sync` for its forward and backward: the batch moments are then
those of the global batch, each rank's per-channel mean of x and x^2
weighted by its share of the global rows and summed over the ranks by the
step's reduction, with autograd (SyncBatchNorm's semantics, not DDP's
per-replica ones).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """`x` promoted to float32 at least (flax's `promote_types(dtype,
    float32)`): bf16 becomes float32, a float64 network stays float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def act(x: torch.Tensor, relu6: bool) -> torch.Tensor:
    if not relu6:
        return x.relu()
    if x.requires_grad:
        # ReLU6 as the JAX package writes it, min(max(x, 0), 6): the
        # gradient is split evenly at the ties x = 0 and x = 6 (clamp's
        # passes it whole), where a frozen BatchNorm leaves exact zeros
        return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_full((), 6.0))
    return x.clamp(0.0, 6.0)


class BatchNorm(nn.Module):
    """BatchNorm of the flax `bn` scope: running statistics in eval mode,
    batch statistics (and `updated_stats`) in train mode."""

    def __init__(self, c: int, eps: float, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        # (mean, var) of the running statistics after the last train-mode
        # forward, detached; None before one
        self.updated_stats = None
        # (reduce, share) while a data-parallel train step runs: `reduce`
        # sums a tensor over the ranks with autograd, `share` is this rank's
        # rows over the global batch's; None otherwise
        self.sync = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        x = at_least_f32(x)
        if train:
            mean, meansq = x.mean((0, 2, 3)), (x * x).mean((0, 2, 3))
            if self.sync is not None:
                # the moments of the global batch: each rank's moments
                # weighted by its share of the rows (H and W are the same on
                # every rank), summed over the ranks, as GSPMD reduces the
                # JAX step's mean over the sharded batch; one rank's share is
                # exactly 1, so one rank computes the single-device moments
                # bit for bit
                reduce, share = self.sync
                c = mean.shape[0]
                both = reduce(torch.cat([mean, meansq]) * share)
                mean, meansq = both[:c], both[c:]
            var = (meansq - mean * mean).clamp_min(0.0)
            m = self.momentum
            self.updated_stats = (
                m * self.running_mean + (1 - m) * mean.detach(),
                m * self.running_var + (1 - m) * var.detach(),
            )
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.view(shape)) * mul.view(shape)
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
        bn_momentum: float = 0.9,
        dtype: torch.dtype = torch.bfloat16,
        folded: bool = False,
        bn_dtype: torch.dtype = torch.float32,
        padding=None,
        as_matmul: bool = False,
    ):
        super().__init__()
        self.stride = stride
        self.padding = (kernel - 1) // 2
        # F.pad's (left, right, top, bottom) of a ((top, bottom), (left,
        # right)) override, or None
        self.pad = None
        if padding is not None:
            (top, bottom), (left, right) = padding
            self.padding, self.pad = 0, (left, right, top, bottom)
        self.as_matmul = as_matmul and kernel == 1 and stride == 1 and groups == 1
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
            self.bn = BatchNorm(cout, bn_eps, bn_momentum)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        w = self.conv.weight.to(self.dtype)
        b = self.conv.bias.to(self.dtype) if self.folded else None
        if self.as_matmul:
            n, c, h, wd = x.shape
            y = torch.matmul(x.permute(0, 2, 3, 1).reshape(n * h * wd, c).to(self.dtype), w[:, :, 0, 0].t())
            if b is not None:
                y = y + b
            x = y.reshape(n, h, wd, -1).permute(0, 3, 1, 2)
        else:
            if self.pad is not None:
                x = F.pad(x, self.pad)
            x = F.conv2d(x, w, b, self.stride, self.padding, 1, self.groups)
        if not self.folded:
            x = self.bn(x.to(self.bn_dtype), train)
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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.expand(x, train) if hasattr(self, "expand") else x
        y = self.project(self.depthwise(y, train), train)
        return y + x if self.use_skip else y
