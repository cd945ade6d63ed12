"""Plain torch twin of the network, named one for one after the JAX tree.

Mirrors `tpucenterface/weights/torch_twin.py` (`TorchConvBN`,
`TorchInvertedResidual`, `TorchBackbone`, `TorchNeck`, `TorchHead`,
`TorchHeads`, `TorchCenterFace`), built on the port's `config` and
`model.backbone.backbone_plan`. It is the loading surface of a reference
`.pth` checkpoint (twin -> `load_state_dict` ->
`weights.port.variables_from_torch_module`), and the independent reference
the parity report and the tests hold the port's folded, fused forward to: a
float32 NCHW network of `nn.Conv2d` + `nn.BatchNorm2d`, unfolded and
unfused, whose module registration order follows the data flow.

Naming contract (JAX path <-> torch attribute path):
    backbone/stem/{conv,bn}            backbone.stem.{conv,bn}
    backbone/block_i/{expand,depthwise,project}/{conv,bn}
    neck/lateral_S/{conv,bn}, neck/smooth_S/{conv,bn}
    heads/{hm,wh,off,lm}/{conv,out}
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from tpucenterface_torch.config import ModelConfig
from tpucenterface_torch.model.backbone import backbone_plan


class TorchConvBN(nn.Module):
    def __init__(self, cin, cout, k=3, s=1, groups=1, act=True, relu6=True, eps=1e-5):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, s, (k - 1) // 2, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=eps)
        self.act = act
        self.relu6 = relu6

    def forward(self, x):
        x = self.bn(self.conv(x))
        if self.act:
            x = F.relu6(x) if self.relu6 else F.relu(x)
        return x


class TorchInvertedResidual(nn.Module):
    def __init__(self, cin, cout, stride, expand, relu6=True, eps=1e-5):
        super().__init__()
        hidden = cin * expand
        self.use_skip = stride == 1 and cin == cout
        if expand != 1:
            self.expand = TorchConvBN(cin, hidden, 1, relu6=relu6, eps=eps)
        self.depthwise = TorchConvBN(hidden, hidden, 3, stride, groups=hidden, relu6=relu6, eps=eps)
        self.project = TorchConvBN(hidden, cout, 1, act=False, relu6=relu6, eps=eps)

    def forward(self, x):
        y = self.expand(x) if hasattr(self, "expand") else x
        y = self.project(self.depthwise(y))
        return y + x if self.use_skip else y


class TorchBackbone(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.stem = TorchConvBN(3, cfg.width(cfg.stem_channels), 3, 2, relu6=cfg.relu6, eps=cfg.bn_eps)
        self.plan = backbone_plan(cfg)
        cin = cfg.width(cfg.stem_channels)
        for i, (t, c, s, _) in enumerate(self.plan):
            setattr(self, f"block_{i}", TorchInvertedResidual(cin, c, s, t, relu6=cfg.relu6, eps=cfg.bn_eps))
            cin = c

    def forward(self, x):
        x = self.stem(x)
        feats = {}
        for i, (t, c, s, out_stride) in enumerate(self.plan):
            nxt = self.plan[i + 1] if i + 1 < len(self.plan) else None
            x = getattr(self, f"block_{i}")(x)
            if out_stride >= 4 and (nxt is None or nxt[3] > out_stride):
                feats[out_stride] = x
        return feats


class TorchNeck(nn.Module):
    def __init__(self, cfg: ModelConfig, strides=(32, 16, 8, 4)):
        super().__init__()
        self.strides = strides
        c = cfg.fpn_channels
        chans = {4: cfg.width(24), 8: cfg.width(32), 16: cfg.width(96), 32: cfg.width(320)}
        for s in strides:
            setattr(self, f"lateral_{s}", TorchConvBN(chans[s], c, 1, relu6=cfg.relu6, eps=cfg.bn_eps))
        for s in strides[1:]:
            setattr(self, f"smooth_{s}", TorchConvBN(c, c, 3, relu6=cfg.relu6, eps=cfg.bn_eps))

    def forward(self, feats):
        y = getattr(self, f"lateral_{self.strides[0]}")(feats[self.strides[0]])
        for s in self.strides[1:]:
            lat = getattr(self, f"lateral_{s}")(feats[s])
            y = F.interpolate(y, scale_factor=2, mode="nearest") + lat
            y = getattr(self, f"smooth_{s}")(y)
        return y


class TorchHead(nn.Module):
    def __init__(self, cin, cout, hidden, bias_init=0.0):
        super().__init__()
        if hidden > 0:
            self.conv = nn.Conv2d(cin, hidden, 3, padding=1)
            cin = hidden
        self.out = nn.Conv2d(cin, cout, 1)
        nn.init.constant_(self.out.bias, bias_init)

    def forward(self, x):
        if hasattr(self, "conv"):
            x = F.relu(self.conv(x))
        return self.out(x)


class TorchHeads(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        c, h = cfg.fpn_channels, cfg.head_conv
        self.hm = TorchHead(c, cfg.num_classes, h, bias_init=cfg.hm_bias_init)
        self.wh = TorchHead(c, 2, h)
        self.off = TorchHead(c, 2, h)
        if cfg.with_landmarks:
            self.lm = TorchHead(c, 10, h)

    def forward(self, x):
        out = {"hm": self.hm(x), "wh": self.wh(x), "off": self.off(x)}
        if hasattr(self, "lm"):
            out["lm"] = self.lm(x)
        return out


class TorchCenterFace(nn.Module):
    """NCHW torch twin. forward(x) -> dict of NCHW head maps."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.backbone = TorchBackbone(cfg)
        self.neck = TorchNeck(cfg)
        self.heads = TorchHeads(cfg)

    def forward(self, x):
        return self.heads(self.neck(self.backbone(x)))
