"""FastEngine: the folded network with its stride-1 inverted-residual blocks
run as one fused kernel each.

Mirrors `tpucenterface/model/fast_forward.py::FastEngine`. Every stride-1
block whose map is at least `min_kernel_hw` high and of even height runs
through `ops.fused_mbconv` (the expanded tensor stays on chip); the stem, the
stride-2 blocks, the small-map blocks, the neck and the heads are the port's
modules (`model/blocks.py`, `neck.py`, `heads.py`), as the JAX engine leaves
them to plain convolutions. The JAX engine pads every channel count to 128
lanes for its TPU layout; the port works on the logical channels, which gives
the same values because that padding is zero weights and biases. Unlike the
JAX engine it reads fused heads as well as separate ones.

Callable like `CenterFaceNet`: an NHWC batch in, a dict of NHWC float32 maps
out.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from tpucenterface_torch.config import ModelConfig, resolve_device
from tpucenterface_torch.model.backbone import _is_skip, backbone_plan
from tpucenterface_torch.model.centernet import load_network
from tpucenterface_torch.ops.fused_mbconv import MAX_CIN, PackedMBConv, fused_mbconv, pack_fused_mbconv
from tpucenterface_torch.weights.convert import mbconv_args_from_block


def fusable_blocks(cfg: ModelConfig) -> List[Tuple[int, int]]:
    """(index, stride of its input map) of every block the fused kernel can
    take at some input size: stride 1, and no more input channels than the
    kernel's shared memory holds (MAX_CIN)."""
    stride, cin, out = 2, cfg.width(cfg.stem_channels), []  # the stem halves the input
    for i, (_, c, s, _) in enumerate(backbone_plan(cfg)):
        if s == 1 and cin <= MAX_CIN:
            out.append((i, stride))
        stride, cin = stride * s, c
    return out


def kernel_blocks(cfg: ModelConfig, input_h: int, min_kernel_hw: int = 24) -> List[int]:
    """Indices of the `fusable_blocks` that take the fused kernel at an input
    `input_h` high: map height >= `min_kernel_hw` and even
    (`tpucenterface/model/fast_forward.py:122-127`). Each stride-2 conv
    (3x3, padding 1) gives ceil(h / 2) rows, so a map is ceil(input_h /
    stride) high."""
    out = []
    for i, stride in fusable_blocks(cfg):
        hw = -(-input_h // stride)
        if hw >= min_kernel_hw and hw % 2 == 0:
            out.append(i)
    return out


class FastEngine:
    """Callable inference engine built from folded variables."""

    def __init__(
        self,
        folded_variables: Dict[str, Any],
        cfg: ModelConfig,
        use_mbconv_kernel: bool = False,
        min_kernel_hw: int = 24,
        device=None,
    ):
        if not cfg.folded:
            raise ValueError("FastEngine takes a folded model (ModelConfig.folded)")
        if use_mbconv_kernel and cfg.compute_dtype != "bfloat16":
            raise ValueError(f"the fused kernel computes in bfloat16, not {cfg.compute_dtype}")
        self.cfg = cfg
        self.use_kernel = use_mbconv_kernel
        self.min_kernel_hw = min_kernel_hw
        self.device = resolve_device(device)
        self.net = load_network(folded_variables, cfg, self.device)
        self.plan = backbone_plan(cfg)
        # the weights of every block of `fusable_blocks`, packed once on the
        # device in the kernel's layout (bfloat16, as the kernel computes with them)
        blocks = folded_variables["params"]["backbone"]
        self.packed: Dict[int, PackedMBConv] = {}
        if use_mbconv_kernel:
            for i, _ in fusable_blocks(cfg):
                args = (None if a is None else torch.from_numpy(a) for a in mbconv_args_from_block(blocks[f"block_{i}"]))
                self.packed[i] = pack_fused_mbconv(*args, device=self.device)

    def kernel_blocks(self, input_h: int) -> List[int]:
        """The blocks that take the fused kernel at an input `input_h` high."""
        if not self.use_kernel:
            return []
        return kernel_blocks(self.cfg, input_h, self.min_kernel_hw)

    def __call__(self, x_nhwc: torch.Tensor) -> Dict[str, torch.Tensor]:
        bb = self.net.backbone
        fused = set(self.kernel_blocks(x_nhwc.shape[1]))
        y = bb.stem(x_nhwc.permute(0, 3, 1, 2).to(bb.dtype))
        feats: Dict[int, torch.Tensor] = {}
        for i, (_, _, _, out_stride) in enumerate(self.plan):
            block = getattr(bb, f"block_{i}")
            if i in fused:
                # NCHW in channels_last is the kernel's NHWC, viewed
                out = fused_mbconv(
                    y.permute(0, 2, 3, 1).contiguous(),
                    self.packed[i],
                    skip=block.use_skip,
                    relu6=self.cfg.relu6,
                )
                y = out.permute(0, 3, 1, 2)
            else:
                y = block(y)
            if _is_skip(self.plan, i):
                feats[out_stride] = y
        return self.net.heads(self.net.neck(feats))
