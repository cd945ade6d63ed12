"""Architecture `mobilenetv2`: the detector network in plain float32
PyTorch, from raw variables, and the work it computes.

A MobileNetV2 backbone (Sandler et al., arXiv:1801.04381: a 3x3 / stride-2
stem, then inverted residual blocks of a 1x1 expand, a 3x3 depthwise and a
linear 1x1 project, with a skip where stride and width allow; ReLU6 after
every conv but the project), an FPN-lite neck (a 1x1 lateral on the finest
map of each stride from 4 to 32; top-down, a nearest 2x upsample plus the
lateral, then a 3x3 smooth conv; each conv with BatchNorm and ReLU6) and
heads on the stride-4 map: per head a 1x1 conv with bias on the neck, as in
CenterFace (Xu et al., arXiv:1911.03599), or, where `head_conv` is above 0,
first a 3x3 conv of that width with bias and ReLU, as in CenterNet (Zhou et
al., arXiv:1904.07850).

`check_config` refuses a configuration that states anything this reference
does not implement, so that no configuration is held to a wrong reference.

Variables are in the JAX layout: {"params": ..., "batch_stats": ...}, conv
kernels HWIO, BatchNorm `scale`, `bias`, `mean`, `var`. BatchNorm is applied
unfolded, with its running statistics. Convolutions pad (k - 1) // 2 on
every side, for stride 2 as well.

Work (`forward_flops`, `stride1_blocks`) is counted as `work.py` says.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.model import fp8, get, make_divisible
from perfbench.work import BF16_BYTES, BlockWork, map_side

# every key a configuration file may hold, and the values this reference
# implements where it implements one only (the rest are read where used)
KNOWN_KEYS = {"architecture", "name", "source", "description", "inverted_residual_setting", "stem_channels",
              "width_mult", "fpn_channels", "head_conv", "num_classes", "with_landmarks", "relu6", "bn_eps",
              "hm_bias_init", "stride", "max_dets", "wh_log", "lm_flip_perm", "preprocess", "buckets",
              "compute_dtype", "program", "reduced", "assumed"}
FIXED = {"num_classes": 1, "relu6": True, "stride": 4}
FIXED_PREPROCESS = {"bgr_input": True, "center": True}


def check_config(cfg: dict) -> None:
    """Raise where `cfg` holds a key this reference does not know, or a
    value of one that it does not implement."""
    unknown = set(cfg) - KNOWN_KEYS
    if unknown:
        raise ValueError(f"the reference does not implement the configuration keys {sorted(unknown)}")
    unknown = set(cfg["preprocess"]) - {"mean", "std"} - set(FIXED_PREPROCESS)
    if unknown:
        raise ValueError(f"the reference does not implement the preprocess keys {sorted(unknown)}")
    for where, fixed in ((cfg, FIXED), (cfg["preprocess"], FIXED_PREPROCESS)):
        for k, v in fixed.items():
            if where[k] != v:
                raise ValueError(f"the reference implements {k} = {v!r} only, not {where[k]!r}")
    if cfg["head_conv"] < 0 or not isinstance(cfg["wh_log"], bool):
        raise ValueError("head_conv must be 0 or more and wh_log true or false")


class Block(NamedTuple):
    expand: int
    cin: int
    cout: int
    stride: int
    in_stride: int   # of the block's input map against the network input
    out_stride: int


def stem_channels(cfg: dict) -> int:
    return make_divisible(cfg["stem_channels"], cfg["width_mult"])


def blocks(cfg: dict) -> List[Block]:
    """The inverted residual blocks in order."""
    out, cin, stride = [], stem_channels(cfg), 2
    for t, c, n, s in cfg["inverted_residual_setting"]:
        cout = make_divisible(c, cfg["width_mult"])
        for i in range(n):
            st = s if i == 0 else 1
            out.append(Block(t, cin, cout, st, stride, stride * st))
            cin, stride = cout, stride * st
    return out


def feature_blocks(cfg: dict) -> Dict[int, int]:
    """{stride: index of the block whose output is the neck's input at that
    stride}: the last block at each output stride of 4 or more."""
    bl = blocks(cfg)
    return {b.out_stride: i for i, b in enumerate(bl)
            if b.out_stride >= 4 and (i + 1 == len(bl) or bl[i + 1].out_stride > b.out_stride)}


def head_outputs(cfg: dict) -> List[Tuple[str, int]]:
    out = [("hm", cfg["num_classes"]), ("wh", 2), ("off", 2)]
    if cfg["with_landmarks"]:
        out.append(("lm", 10))
    return out


def leaf_shapes(cfg: dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], str]]:
    """Every variable as (path, shape, kind), in a fixed order. Kinds
    (`weights.py` draws by them): kernel, bn_scale, bn_bias, bn_mean,
    bn_var, head_bias, and out_kernel_<head>, out_bias_<head> of each head's
    1x1 out conv."""
    leaves = []

    def conv_bn(path, kh, cin, cout):
        leaves.append((("params",) + path + ("conv", "kernel"), (kh, kh, cin, cout), "kernel"))
        for leaf, kind in (("scale", "bn_scale"), ("bias", "bn_bias")):
            leaves.append((("params",) + path + ("bn", leaf), (cout,), kind))
        for leaf, kind in (("mean", "bn_mean"), ("var", "bn_var")):
            leaves.append((("batch_stats",) + path + ("bn", leaf), (cout,), kind))

    conv_bn(("backbone", "stem"), 3, 3, stem_channels(cfg))
    for i, b in enumerate(blocks(cfg)):
        hidden = b.cin * b.expand
        if b.expand != 1:
            conv_bn(("backbone", f"block_{i}", "expand"), 1, b.cin, hidden)
        conv_bn(("backbone", f"block_{i}", "depthwise"), 3, 1, hidden)
        conv_bn(("backbone", f"block_{i}", "project"), 1, hidden, b.cout)
    c = cfg["fpn_channels"]
    feats = feature_blocks(cfg)
    bl = blocks(cfg)
    strides = sorted(feats, reverse=True)
    for s in strides:
        conv_bn(("neck", f"lateral_{s}"), 1, bl[feats[s]].cout, c)
    for s in strides[1:]:
        conv_bn(("neck", f"smooth_{s}"), 3, c, c)
    hc = cfg["head_conv"]
    for name, n in head_outputs(cfg):
        if hc > 0:
            leaves.append((("params", "heads", name, "conv", "kernel"), (3, 3, c, hc), "kernel"))
            leaves.append((("params", "heads", name, "conv", "bias"), (hc,), "head_bias"))
        leaves.append((("params", "heads", name, "out", "kernel"), (1, 1, hc or c, n), f"out_kernel_{name}"))
        leaves.append((("params", "heads", name, "out", "bias"), (n,), f"out_bias_{name}"))
    return leaves


class Network:
    """The float32 forward of one configuration (which `registry.reference`
    has checked) on torch `variables` (see `model.to_device`). Takes
    normalised NCHW float32 batches. With `low` (the control), every
    convolution's input and kernel are first rounded to float8 (`fp8`): the
    step below the bfloat16 the configurations state."""

    def __init__(self, cfg: dict, variables: dict, low: bool = False):
        self.cfg = cfg
        self.p = variables["params"]
        self.s = variables["batch_stats"]
        self.eps = float(cfg["bn_eps"])
        self.q = fp8 if low else (lambda t: t)

    def act(self, x):
        """The activation after every conv with BatchNorm but the project."""
        return x.clamp(0.0, 6.0)

    def conv(self, x, kernel, bias=None, stride=1, groups=1):
        """A conv of an HWIO `kernel`, padding (k - 1) // 2."""
        return F.conv2d(self.q(x), self.q(kernel.permute(3, 2, 0, 1)), bias, stride, (kernel.shape[0] - 1) // 2,
                        1, groups)

    def conv_bn(self, x, path, stride=1, groups=1, act=True):
        x = self.conv(x, get(self.p, path + ("conv", "kernel")), None, stride, groups)
        bn, st = get(self.p, path + ("bn",)), get(self.s, path + ("bn",))
        mul = bn["scale"] / torch.sqrt(st["var"] + self.eps)
        x = (x - st["mean"].view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + bn["bias"].view(1, -1, 1, 1)
        return self.act(x) if act else x

    def backbone(self, x) -> Dict[int, torch.Tensor]:
        x = self.conv_bn(x, ("backbone", "stem"), stride=2)
        feats = {}
        keep = {i: s for s, i in feature_blocks(self.cfg).items()}
        for i, b in enumerate(blocks(self.cfg)):
            path = ("backbone", f"block_{i}")
            y = self.conv_bn(x, path + ("expand",)) if b.expand != 1 else x
            y = self.conv_bn(y, path + ("depthwise",), stride=b.stride, groups=y.shape[1])
            y = self.conv_bn(y, path + ("project",), act=False)
            x = y + x if b.stride == 1 and b.cin == b.cout else y
            if i in keep:
                feats[keep[i]] = x
        return feats

    def neck(self, feats: Dict[int, torch.Tensor]) -> torch.Tensor:
        strides = sorted(feats, reverse=True)
        y = self.conv_bn(feats[strides[0]], ("neck", f"lateral_{strides[0]}"))
        for s in strides[1:]:
            lat = self.conv_bn(feats[s], ("neck", f"lateral_{s}"))
            y = F.interpolate(y, scale_factor=2, mode="nearest") + lat
            y = self.conv_bn(y, ("neck", f"smooth_{s}"))
        return y

    def heads(self, y: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {}
        for name, _ in head_outputs(self.cfg):
            h = self.p["heads"][name]
            z = self.conv(y, h["conv"]["kernel"], h["conv"]["bias"]).relu() if "conv" in h else y
            z = self.conv(z, h["out"]["kernel"], h["out"]["bias"])
            out[name] = z.permute(0, 2, 3, 1)
        return out

    def __call__(self, x_nchw: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, 3, S, S) normalised RGB float32 -> {name: (B, S/4, S/4, C)}."""
        return self.heads(self.neck(self.backbone(x_nchw)))


def forward_flops(cfg: dict, size: int) -> int:
    """Operations of one forward of one size x size input."""
    hw = lambda s: map_side(size, s) ** 2  # noqa: E731  cells of the map at stride s
    f = 2 * hw(2) * 3 * 9 * stem_channels(cfg)
    for b in blocks(cfg):
        hidden = b.cin * b.expand
        if b.expand != 1:
            f += 2 * hw(b.in_stride) * b.cin * hidden
        f += 2 * hw(b.out_stride) * hidden * 9
        f += 2 * hw(b.out_stride) * hidden * b.cout
    c = cfg["fpn_channels"]
    bl = blocks(cfg)
    feats = feature_blocks(cfg)
    for s, i in feats.items():
        f += 2 * hw(s) * bl[i].cout * c
    for s in sorted(feats)[:-1]:
        f += 2 * hw(s) * c * c * 9
    hc = cfg["head_conv"]
    for _, n in head_outputs(cfg):
        f += 2 * hw(4) * (c * hc * 9 + hc * n if hc else c * n)
    return f


def stride1_blocks(cfg: dict, height: int, width: int, rows: int) -> List[BlockWork]:
    """The stride-1 inverted residual blocks of a forward of `rows` inputs
    of height x width, in the network's order, and the work of each:
    operations, the expand's and the project's products and the depthwise's
    nine multiply-adds a value; bytes, the input and output maps once and
    the weights and biases once, all in bf16. Which of them a kernel took is
    for the trace to say (`metrics/mbconv_roofline.py`), not for this
    count."""
    out = []
    for i, b in enumerate(blocks(cfg)):
        if b.stride != 1:
            continue
        pos = rows * map_side(height, b.in_stride) * map_side(width, b.in_stride)
        ce = b.cin * b.expand
        ex = b.cin * ce if b.expand != 1 else 0
        flops = 2 * pos * (ex + 9 * ce + ce * b.cout)
        weights = ex + 9 * ce + ce * b.cout + (2 * ce if b.expand != 1 else ce) + b.cout
        out.append(BlockWork(i, flops, BF16_BYTES * (pos * (b.cin + b.cout) + weights)))
    return out
