"""PlanarEngine: the folded network with every maximal run of stride-1
inverted-residual blocks on a small enough map run as ONE kernel launch.

Mirrors `tpucenterface/model/planar_engine.py::PlanarEngine`:
- the stem, the stride-2 blocks and the stride-1 blocks on maps higher than
  `max_chain_res` are the port's modules (`model/blocks.py`), as the JAX engine
  leaves them to plain convolutions;
- a maximal run of stride-1 blocks entered on a map at most `max_chain_res`
  rows high goes through `ops.planar_mbconv.planar_mbconv_chain`: on the
  default model blocks 4-5, 7-12 and 14-16 (and block 2, and block 0, where
  their maps are small enough), one launch per run, the expanded tensors never
  in device memory;
- the neck and the heads are the port's modules;
- `algebraic_fusion` applies the JAX engine's two exact weight compositions,
  computed in numpy float32 as there (so the composed weights are bit-equal):
  block_0's linear projection folded into block_1's expand (block_0 then runs
  its depthwise only), and the top lateral's 1x1 conv folded into the last
  block's projection (the lateral then only activates).

Defaults as in the JAX class: `max_chain_res=0` (no chain), no fusion. With
chains on, the compute dtype must be bfloat16. Callable like `CenterFaceNet`:
an NHWC batch in, a dict of NHWC float32 maps out.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from tpucenterface_torch.config import ModelConfig, resolve_device
from tpucenterface_torch.model.backbone import _is_skip, backbone_plan
from tpucenterface_torch.model.blocks import act
from tpucenterface_torch.model.centernet import CenterFaceNet
from tpucenterface_torch.ops.planar_mbconv import (
    nhwc_from_planar,
    pack_planar_chain,
    planar_from_nhwc,
    planar_mbconv_chain,
)
from tpucenterface_torch.weights.convert import chain_blocks_from_run, state_dict_from_variables


def chain_runs(cfg: ModelConfig, input_h: int, max_chain_res: int, fuse_b0_b1: bool = False) -> List[Tuple[int, int]]:
    """(first block, number of blocks) of every chain at an input `input_h`
    high: each maximal run of stride-1 blocks that is entered on a map at most
    `max_chain_res` rows high (`tpucenterface/model/planar_engine.py:216-237`)."""
    plan = backbone_plan(cfg)
    h = (input_h - 1) // 2 + 1  # the stem: 3x3, stride 2, padding 1
    runs, i = [], 0
    while i < len(plan):
        s = plan[i][2]
        if i == 0 and fuse_b0_b1:
            i += 1
        elif s == 1 and h <= max_chain_res:
            j = i
            while j < len(plan) and plan[j][2] == 1:
                j += 1
            runs.append((i, j - i))
            i = j
        else:
            h = (h - 1) // s + 1
            i += 1
    return runs


class PlanarEngine:
    """Callable inference engine built from folded (optionally fused-head)
    variables; its output matches `CenterFaceNet` on the same variables."""

    def __init__(
        self,
        folded_variables: Dict[str, Any],
        cfg: ModelConfig,
        max_chain_res: int = 0,
        algebraic_fusion: bool = False,
        device=None,
    ):
        if not cfg.folded:
            raise ValueError("PlanarEngine takes a folded model (ModelConfig.folded)")
        if cfg.s2d_stem:
            # the engine calls the stem on its NHWC input as it comes; the
            # Detector runs an s2d model on the module forward
            raise ValueError("PlanarEngine runs the 3x3 stem, not the space-to-depth stem (ModelConfig.s2d_stem)")
        if max_chain_res > 0 and cfg.compute_dtype != "bfloat16":
            raise ValueError(f"the planar chain kernel computes in bfloat16, not {cfg.compute_dtype}")
        self.cfg = cfg
        self.max_chain_res = max_chain_res
        self.device = resolve_device(device)
        self.plan = backbone_plan(cfg)
        self.fuse_b0_b1 = False
        self.fuse_top_lateral = False
        params = folded_variables["params"]
        if algebraic_fusion:
            params = self._apply_algebraic_fusion(params)
        self.params = params

        # the network of the (composed) weights; a composed 1x1 conv has other
        # channel counts than the module was built with
        net = CenterFaceNet(cfg)
        bb = net.backbone
        composed = []
        if self.fuse_b0_b1:
            composed.append((bb.block_1.expand, params["backbone"]["block_1"]["expand"]))
        if self.fuse_top_lateral:
            last = f"block_{len(self.plan) - 1}"
            composed.append((getattr(bb, last).project, params["backbone"][last]["project"]))
        for convbn, scope in composed:
            _, _, i, o = np.shape(scope["conv"]["kernel"])
            convbn.conv = nn.Conv2d(i, o, 1, bias=True)
        net.load_state_dict(state_dict_from_variables({**folded_variables, "params": params}), strict=True)
        net.requires_grad_(False).eval().cast_convs_()
        self.net = net.to(device=self.device, memory_format=torch.channels_last)
        # {first block: the run's blocks as the chain wrapper takes them}: a
        # PackedChain for the kernel on a card, dicts of tensors on the CPU;
        # built at first use
        self._chains: Dict[int, Any] = {}

    def _apply_algebraic_fusion(self, params):
        """The two compositions of `planar_engine.py:120-162`, on a copy."""
        bb = dict(params["backbone"])
        plan = self.plan
        # block_0.project into block_1.expand: both 1x1, block_0 adds no skip
        # (its channels change) and feeds only block_1
        if (
            len(plan) > 1
            and plan[0][0] == 1 and plan[0][2] == 1
            and plan[1][0] != 1
            and plan[0][1] != self.cfg.width(self.cfg.stem_channels)
        ):
            wp_ = np.asarray(bb["block_0"]["project"]["conv"]["kernel"])[0, 0]
            bp_ = np.asarray(bb["block_0"]["project"]["conv"]["bias"])
            we = np.asarray(bb["block_1"]["expand"]["conv"]["kernel"])[0, 0]
            be = np.asarray(bb["block_1"]["expand"]["conv"]["bias"])
            bb["block_1"] = dict(bb["block_1"])
            bb["block_1"]["expand"] = {
                "conv": {"kernel": (wp_ @ we)[None, None].astype(np.float32), "bias": (bp_ @ we + be).astype(np.float32)}
            }
            self.fuse_b0_b1 = True
        # the last block's projection into lateral_32: the projection is
        # linear and the top map feeds only the neck's top lateral
        last = len(plan) - 1
        if plan[last][3] == 32 and "lateral_32" in params["neck"]:
            blk = bb[f"block_{last}"]
            wp_ = np.asarray(blk["project"]["conv"]["kernel"])[0, 0]
            bp_ = np.asarray(blk["project"]["conv"]["bias"])
            wl = np.asarray(params["neck"]["lateral_32"]["conv"]["kernel"])[0, 0]
            bl = np.asarray(params["neck"]["lateral_32"]["conv"]["bias"])
            bb[f"block_{last}"] = dict(blk)
            bb[f"block_{last}"]["project"] = {
                "conv": {"kernel": (wp_ @ wl)[None, None].astype(np.float32), "bias": (bp_ @ wl + bl).astype(np.float32)}
            }
            self.fuse_top_lateral = True
        return {**params, "backbone": bb}

    def chain_runs(self, input_h: int) -> List[Tuple[int, int]]:
        """(first block, number of blocks) of the chains at this input height."""
        return chain_runs(self.cfg, input_h, self.max_chain_res, self.fuse_b0_b1)

    def _run_blocks(self, first: int, count: int, cin: int):
        """The chain that starts at block `first` (a maximal run, so `first`
        alone names it), laid out once for this engine's device."""
        if first not in self._chains:
            run = chain_blocks_from_run(
                [self.params["backbone"][f"block_{i}"] for i in range(first, first + count)], cin
            )
            if self.device.type == "cuda":
                self._chains[first] = pack_planar_chain(run, cin, self.device)
            else:
                self._chains[first] = [
                    {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in blk.items()} for blk in run
                ]
        return self._chains[first]

    def __call__(self, x_nhwc: torch.Tensor) -> Dict[str, torch.Tensor]:
        bb = self.net.backbone
        plan, n = self.plan, len(self.plan)
        y = bb.stem(x_nhwc.permute(0, 3, 1, 2).to(bb.dtype))
        feats: Dict[int, torch.Tensor] = {}
        cin = self.cfg.width(self.cfg.stem_channels)
        i = 0
        while i < n:
            t, c, s, _ = plan[i]
            h, w = y.shape[2:]
            if i == 0 and self.fuse_b0_b1:
                # block_0 runs its depthwise only; its linear projection lives
                # in block_1's expand, and cin stays at the stem's width
                y = bb.block_0.depthwise(y)
                i += 1
                continue
            if s == 1 and h <= self.max_chain_res:
                # maximal run of stride-1 blocks: one launch
                j = i
                while j < n and plan[j][2] == 1:
                    j += 1
                yp = planar_from_nhwc(y.permute(0, 2, 3, 1)).contiguous()
                yp = planar_mbconv_chain(yp, self._run_blocks(i, j - i, cin), H=h, W=w, relu6=self.cfg.relu6)
                y = nhwc_from_planar(yp, h, w).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
                cin = plan[j - 1][1]
                i = j
            else:
                y = getattr(bb, f"block_{i}")(y)
                cin = c
                i += 1
            if _is_skip(plan, i - 1):
                feats[plan[i - 1][3]] = y

        top = None
        if self.fuse_top_lateral and self.net.neck.strides[0] == 32:
            # lateral_32's conv is composed into the last block's projection;
            # only its activation is left
            top = act(feats[32].float(), self.cfg.relu6).to(bb.dtype)
        return self.net.heads(self.net.neck(feats, top_lateral=top))
