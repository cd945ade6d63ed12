"""W8A8 post-training quantized inference engine.

Mirrors `tpucenterface/quant/engine.py` (`stem_fixed_scale`, `stem_input_lut`,
`apply_stem_lut`, `_quantize_weight` as `quantize_weight_t`, `fake_quant`,
`fake_quant_weight`, `QuantEngine`). One traversal drives four modes:
- 'float'     : the bf16 folded forward (bf16 operands, float32 sums);
- 'calibrate' : the same forward, recording each conv input's absolute
                maximum (or a percentile of it);
- 'quant'     : int8 weights (per-output-channel scales) x int8 activations
                (per-tensor calibrated scales, per-channel for the depthwise
                convs under `int8_dw`), int32 sums (`quant.int8_ops`), a
                float32 epilogue `acc * (sx * sw) + b`, the activation, and
                either a bf16 output or, where the consumer is quantized too,
                the consumer's int8 input (`out_int8_tag` chaining);
- 'fakequant' : the differentiable float32 simulation of 'quant' that QAT
                descends (`quant.qat`): each quantized conv's input and
                weight go through `fake_quant` / `fake_quant_weight`
                (straight-through gradients), every conv runs in float32,
                a chained output is returned fake-quantized in float32, and
                every other output is written at `out_dtype` (bf16), as the
                JAX engine writes it.
Scale conventions: symmetric, x_q = clip(round(x / s), -127, 127), round half
to even. Tensors are NHWC.

`fused_blocks=True` (needs `int8_dw`) runs each stride-1 residual block with
an expand as one launch of the int8 block kernel (`ops.int8_block.
int8_block_s1`, ten a forward on the default model), at the engine's own
scales. It is not bit-equal to the block it replaces: the kernel multiplies by
reciprocal scales where the engine divides, and adds the residual in float32
before one bf16 rounding where the engine rounds the project output to bf16
and adds in bf16. Off (the default), the engine mirrors the JAX engine.

Where the arithmetic has to be copied exactly (the CPU tests hold the port to
the JAX engine bit for bit):
- a per-tensor scale is `float32(s / 127)`, divided in float64 and rounded
  once; a per-channel scale is `float32(s) / 127` divided in float32; the
  epilogue scale `sx * sw` is a float32 product. Activation scales are
  formed in numpy on the host and moved to the device as tensors; the int8
  weights and their scales are formed on the device by `quantize_weight_t`,
  one rule for the installed weights and for a tree's (`_quant_operands`);
- the quantizing divisions divide by a tensor on the tensor's own device:
  PyTorch's CUDA division by a CPU scalar multiplies by its reciprocal, which
  can round differently;
- `torch.quantile` refuses more than 2^24 elements, so `percentile_linear`
  writes `jnp.percentile`'s linear interpolation, in float32, with
  `torch.kthvalue`;
- calibration runs the bf16 float forward, whose sums the card and the CPU
  take in different orders; compare the two devices under one `set_scales`
  dict, not under two calibrations.

The parameters (`p`, the JAX layout with the fused heads, float32 tensors on
the engine's device) are the engine's state: setting `p` rebuilds the conv
table and, on a calibrated engine, re-installs the int8 weights and the block
kernel's packed operands, so `fused_blocks=True` serves what was set.
`_forward(x, mode)` runs on the installed weights; `_forward(x, mode,
params=tree)` forms every weight from `tree` on each call (quantized on the
device where the mode is 'quant'), which is what the fine-tuning loops
(`quant.qat`, `quant.adaround`) differentiate and select on; those always
run the per-conv route, as the JAX engine does. Two hooks serve them:
- `_bc_collector` (a dict, or None): in the float and quant modes each conv
  writes its per-channel pre-activation mean into it;
- `_cap_tag` / `_cap_out`: the conv `_cap_tag` names writes, in quant
  mode, its int8 input `xq`, its input scale `sx`, stride, groups and
  activation into `_cap_out`, and in float mode its float32 post-activation
  output `y` (the JAX engine's "*", every conv in one forward, serves its
  jitted captures; the port captures one conv a forward).
`_forward(..., weight_scales=w)` installs `w` as the fixed weight scales for
the length of one forward.

The activations of the 'fakequant' mode give JAX's gradient at ties:
min(max(y, 0), 6) and max(y, 0) split it evenly where y is exactly 0 or 6,
which fake-quantized inputs make common; clamp and relu would not. Float32
convolutions on the card run in TF32 unless the caller turns it off
(`torch.backends.cudnn.allow_tf32`); the engine changes no global flag.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpucenterface_torch.config import ModelConfig, resolve_device
from tpucenterface_torch.model.backbone import _is_skip, backbone_plan
from tpucenterface_torch.quant.int8_ops import conv1x1_int8, conv3x3_int8, dwconv3x3_int8
from tpucenterface_torch.weights.fold import fuse_head_params


def stem_fixed_scale(pp_cfg) -> float:
    """Fixed int8 scale of the stem's `pixel - 255*mean` input:
    max(255*mean, 255*(1-mean))/127."""
    mean = np.asarray(pp_cfg.mean, np.float64) * 255.0
    return float(np.max(np.maximum(mean, 255.0 - mean))) / 127.0


def stem_input_lut(pp_cfg, device=None) -> np.ndarray:
    """(256, 3) int8 table: raw uint8 pixel -> the stem conv's int8 input.

    Built by running the port's own input chain (`normalize_images(raw=True)`,
    then round(x / sx) in float32) over the 256-value ramp on `device` (the
    GPU unless told otherwise), so the table equals the in-forward
    quantization by construction, not by a host-side recomputation."""
    from tpucenterface_torch.preprocess import normalize_images

    dev = resolve_device(device)
    sx = torch.tensor(np.float32(stem_fixed_scale(pp_cfg)), device=dev)
    ramp = torch.arange(256, dtype=torch.uint8, device=dev)[None, :, None, None].expand(1, 256, 1, 3)
    with torch.inference_mode():
        x = normalize_images(ramp.contiguous(), pp_cfg, raw=True)
        q = torch.round(x.float() / sx).clamp_(-127, 127).to(torch.int8)
    return q.reshape(256, 3).cpu().numpy()


def apply_stem_lut(imgs_u8: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Apply `stem_input_lut` to (..., 3) uint8 images -> int8."""
    out = np.empty(imgs_u8.shape, np.int8)
    for c in range(3):
        out[..., c] = lut[:, c][imgs_u8[..., c]]
    return out


def _f32(v, device) -> torch.Tensor:
    """`v` (a number, numpy array or tensor) as a float32 tensor on
    `device`; a number or array is rounded to float32 first."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.asarray(v, np.float32))
    return v.to(device=device, dtype=torch.float32)


def quantize_weight_t(k: torch.Tensor, fixed_scale=None, qmax: int = 127):
    """Per-output-channel symmetric weight quantization of an HWIO kernel
    tensor (the JAX package's `_quantize_weight`) -> (int8 kernel, float32
    scales), on the kernel's device. qmax 127 for int8 weights, 7 for int4
    (still held in int8). `fixed_scale` overrides the per-channel scale.
    Each division is by a tensor: PyTorch's CUDA division by a host scalar
    multiplies by its reciprocal, which can round differently."""
    k = k.detach().float()
    if fixed_scale is not None:
        sw = _f32(fixed_scale, k.device)
    else:
        amax = k.abs().amax(dim=(0, 1, 2))
        sw = torch.maximum(amax, _f32(1e-8, k.device)) / _f32(qmax, k.device)
    kq = torch.round(k / sw).clamp_(-qmax, qmax).to(torch.int8)
    return kq, sw


def fake_quant(x: torch.Tensor, s, qmax: int = 127) -> torch.Tensor:
    """Differentiable quantize-dequantize with a straight-through estimator:
    the value clip(round(x / s), -qmax, qmax) * s, written as
    x + (y - x) with the difference outside autograd, so the gradient is 1
    where x / s lies in [-qmax, qmax] (bounds included) and 0 where the clip
    saturates. The scale gets no gradient. `s`: a tensor on x's device, or a
    number or array (copied there). float32 arithmetic, as in the JAX
    function."""
    s = _f32(s, x.device).detach()
    qmax = float(qmax)
    x32 = x.float()
    q = x32 / s
    y = torch.round(q).clamp(-qmax, qmax) * s
    in_range = (q >= -qmax) & (q <= qmax)
    return torch.where(in_range, x32 + (y - x32).detach(), y.detach())


def fake_quant_weight(k: torch.Tensor, fixed_scale=None, qmax: int = 127) -> torch.Tensor:
    """STE fake-quant of an HWIO kernel with `quantize_weight_t`'s
    per-output-channel scale rule (or `fixed_scale`); the scale, derived from
    the live weights, gets no gradient."""
    k32 = k.float()
    if fixed_scale is not None:
        sw = _f32(fixed_scale, k.device)
    else:
        amax = k32.detach().abs().amax(dim=(0, 1, 2))
        sw = torch.maximum(amax, _f32(1e-8, k.device)) / _f32(qmax, k.device)
    return fake_quant(k32, sw, qmax)


def conv_nhwc(x: torch.Tensor, k: torch.Tensor, stride: int, groups: int) -> torch.Tensor:
    """NHWC conv of `x` with the HWIO kernel `k`, padding (kh - 1) // 2, in
    the operands' dtype."""
    pad = (k.shape[0] - 1) // 2
    y = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), None, stride, pad, 1, groups)
    return y.permute(0, 2, 3, 1)


def clip_ties(y: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """min(max(y, lo), hi): `jnp.clip`, whose gradient is split evenly at
    y = lo and y = hi as JAX's is (clamp passes it whole)."""
    return torch.minimum(torch.maximum(y, y.new_full((), lo)), y.new_full((), hi))


def relu_ties(y: torch.Tensor) -> torch.Tensor:
    """max(y, 0), its gradient split evenly at y = 0 as JAX's is."""
    return torch.maximum(y, y.new_zeros(()))


def conv_node_paths(plan) -> Dict[str, Tuple[str, ...]]:
    """{tag: path of the {'kernel', 'bias'} node} of every conv of the engine
    graph, in the order of `tpucenterface/quant/qat.py::_bias_paths`: stem,
    each block's expand, depthwise and project, every lateral, the smooth
    convs, head.conv, head.out (AdaRound reconstructs in this order)."""
    paths: Dict[str, Tuple[str, ...]] = {"stem": ("backbone", "stem", "conv")}
    strides = []
    for i, (t, _, _, out_stride) in enumerate(plan):
        blk = ("backbone", f"block_{i}")
        if t != 1:
            paths[f"b{i}.expand"] = blk + ("expand", "conv")
        paths[f"b{i}.dw"] = blk + ("depthwise", "conv")
        paths[f"b{i}.project"] = blk + ("project", "conv")
        if _is_skip(plan, i):
            strides.append(out_stride)
    strides = sorted(strides, reverse=True)
    for s in strides:
        paths[f"lat{s}"] = ("neck", f"lateral_{s}", "conv")
    for s in strides[1:]:
        paths[f"smooth{s}"] = ("neck", f"smooth_{s}", "conv")
    paths["head.conv"] = ("heads", "fused", "conv")
    paths["head.out"] = ("heads", "fused", "out")
    return paths


def _tree_get(tree, path: Tuple[str, ...]):
    """Read a nested-dict leaf (or node) by path."""
    for k in path:
        tree = tree[k]
    return tree


def percentile_linear(a: torch.Tensor, q: float, dim: Optional[int] = None) -> torch.Tensor:
    """`jnp.percentile(a, q, axis=dim)` with the default linear method, as
    JAX computes it in float32: position q/100 * (n - 1), its floor and
    ceiling order statistics, weights 1 - frac and frac. float32 `a`."""
    if dim is None:
        a, dim = a.reshape(-1), 0
    n = a.shape[dim]
    pos = np.float32(q) / np.float32(100.0) * (np.float32(n) - np.float32(1.0))
    low, high = np.floor(pos), np.ceil(pos)
    hi_w = np.float32(pos - low)
    lo_w = np.float32(1.0) - hi_w
    lo_i = int(np.clip(low, 0, n - 1))
    hi_i = int(np.clip(high, 0, n - 1))
    lo_v = torch.kthvalue(a, lo_i + 1, dim=dim).values
    hi_v = lo_v if hi_i == lo_i else torch.kthvalue(a, hi_i + 1, dim=dim).values
    return lo_v * float(lo_w) + hi_v * float(hi_w)


class _Conv:
    """One conv of the engine graph: its parameter tensors (`kernel_t`, HWIO
    float32, and `bias`), stride, groups, and its float-mode weight
    (bf16-rounded, OIHW, float32), all on the engine's device."""

    def __init__(self, kernel: torch.Tensor, bias: torch.Tensor, stride, groups):
        self.kernel_t, self.bias = kernel, bias
        self.stride, self.groups = stride, groups
        self.kh = kernel.shape[0]
        self.w_float = kernel.permute(3, 2, 0, 1).to(torch.bfloat16).float().contiguous()


class QuantEngine:
    def __init__(
        self,
        folded_variables: Dict[str, Any],
        cfg: ModelConfig,
        int8_dw: bool = False,
        pp_cfg=None,
        skip_tags=(),
        weight_bits: int = 8,
        fused_blocks: bool = False,
        device=None,
    ):
        """int8_dw: quantize the depthwise convs too, with per-channel
        activation scales, and chain expand -> dw -> project in int8.
        skip_tags: convs kept in bf16 inside the int8 forward. weight_bits:
        the weight grid (2..8); activations are always int8. fused_blocks:
        run the stride-1 residual blocks through the int8 block kernel
        (needs int8_dw). Device: the GPU unless told otherwise."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.int8_dw = int8_dw
        if not 2 <= int(weight_bits) <= 8:
            raise ValueError(f"weight_bits must be in [2, 8]: {weight_bits}")
        if fused_blocks and not int8_dw:
            raise ValueError("fused_blocks needs int8_dw=True (the block kernel chains expand, dw and project in int8)")
        self.weight_bits = int(weight_bits)
        self.wqmax = 2 ** (self.weight_bits - 1) - 1
        self.skip_tags = frozenset(skip_tags)
        self.fused_blocks = fused_blocks
        self.plan = backbone_plan(cfg)
        self.act_scales: Optional[Dict[str, Any]] = None
        self.weight_scales: Dict[str, Any] = {}
        self._amax: Dict[str, Any] = {}
        self._calib_percentile: Optional[float] = None
        self.pp_cfg = pp_cfg
        self._collector: Dict[str, torch.Tensor] = {}  # conv input statistics of a calibrate forward
        self._bc_collector: Optional[Dict[str, torch.Tensor]] = None  # pre-activation means (quant.qat)
        self._cap_tag: Optional[str] = None  # conv whose input or output a forward captures (quant.adaround)
        self._cap_out: Dict[str, Any] = {}
        self._q: Dict[str, Dict[str, torch.Tensor]] = {}
        self._sx: Dict[str, torch.Tensor] = {}
        self._qsx: Dict[str, torch.Tensor] = {}  # each quantized conv's input scale
        self._ws: Dict[str, Tuple[Any, torch.Tensor]] = {}  # tag: (weight_scales entry, its device tensor)
        self._block_args: Dict[int, Tuple[float, Any]] = {}  # block: (inv_se, PackedInt8BlockS1)
        self.p = folded_variables["params"]

    @property
    def p(self) -> Dict[str, Any]:
        """The engine's parameters: the folded tree in the JAX layout with the
        fused heads, float32 tensors on the engine's device."""
        return self._p

    @p.setter
    def p(self, params: Dict[str, Any]) -> None:
        """Install `params` (numpy arrays or tensors; heads fused here if they
        are not): rebuild the conv table and, on a calibrated engine, the
        int8 weights and the block kernel's packed operands."""
        if "fused" not in params.get("heads", {}):
            names = [n for n in ("hm", "wh", "off", "lm") if n in params["heads"]]
            if any("conv" not in params["heads"][n] for n in names):
                raise ValueError(
                    "QuantEngine requires head_conv > 0 (fused-head form needs the hidden head conv); "
                    "this model has single-1x1 heads"
                )
            params = dict(params, heads={"fused": fuse_head_params(_np_tree(params["heads"]), names)})
        self._p = _tensor_tree(params, self.device)
        self.convs = self._conv_table(self._p)
        if self.act_scales is not None:
            self._install()

    def conv_paths(self) -> Dict[str, Tuple[str, ...]]:
        """{tag: path of its {'kernel', 'bias'} node in `p`} (`conv_node_paths`)."""
        return conv_node_paths(self.plan)

    def _conv_table(self, params) -> Dict[str, _Conv]:
        """{tag: _Conv} of every conv of the folded, head-fused `params`."""
        convs = {}
        for tag, path in self.conv_paths().items():
            n = _tree_get(params, path)
            stride, groups = 1, 1
            if tag == "stem":
                stride = 2
            elif tag.endswith(".dw"):
                stride, groups = self.plan[int(tag[1:-3])][2], n["kernel"].shape[-1]
            convs[tag] = _Conv(n["kernel"], n["bias"], stride, groups)
        return convs

    def _stem_fixed_scale(self) -> float:
        if self.pp_cfg is None:
            raise ValueError(
                "stem_preprocess models need pp_cfg (the PreprocessConfig whose mean defines the stem input "
                "range); pass it to QuantEngine(pp_cfg=...)"
            )
        return stem_fixed_scale(self.pp_cfg)

    # ------------------------------------------------------------------ #
    # scales and quantized weights
    # ------------------------------------------------------------------ #

    def act_scale(self, tag: str):
        """The activation scale of `tag` as the JAX engine's `_act_scale`
        forms it: float32 scalar, or a float32 per-channel vector."""
        s = self.act_scales[tag]
        if isinstance(s, np.ndarray):
            return np.asarray(s, np.float32) / np.float32(127.0)
        return np.float32(s / 127.0)

    def input_scale(self, tag: str):
        """The scale `tag` quantizes its input with (the stem's fixed one for
        stem-baked models)."""
        if tag == "stem" and self.cfg.stem_preprocess:
            return np.float32(self._stem_fixed_scale())
        return self.act_scale(tag)

    def quantizes(self, tag: str) -> bool:
        """Whether `tag` runs as an int8 conv in quant mode."""
        return (self.convs[tag].groups == 1 or self.int8_dw) and tag not in self.skip_tags

    def quant_weight(self, tag: str) -> Tuple[np.ndarray, np.ndarray]:
        """(int8 HWIO kernel, float32 per-output-channel scales) of `tag` as
        the installed weights are formed, copied to the host."""
        kq, sw = quantize_weight_t(self.convs[tag].kernel_t, self._weight_scale_t(tag), self.wqmax)
        return kq.cpu().numpy(), sw.cpu().numpy()

    def _install(self) -> None:
        """Device tensors of the installed scales: each quantized conv's int8
        weight in its op's layout, its input scale and epilogue scale; each
        scale a consumer's chained epilogue divides by; the block kernel's
        operands under `fused_blocks`, packed once in the kernel's layout."""
        from tpucenterface_torch.ops.int8_block import pack_int8_block_s1
        from tpucenterface_torch.weights.convert import int8_block_args

        dev = self.device
        self._ws = {tag: (sw, _f32(sw, dev)) for tag, sw in self.weight_scales.items()}
        self._sx = {tag: torch.tensor(self.act_scale(tag), device=dev) for tag in self.convs if tag in self.act_scales}
        self._qsx = {tag: torch.tensor(self.input_scale(tag), device=dev) for tag in self.convs if self.quantizes(tag)}
        self._q = {tag: self._quant_operands(tag, self.convs[tag].kernel_t) for tag in self._qsx}
        # inv_se stays a host float: the kernel takes it by value
        self._block_args = {}
        for i in self.fused_block_indices():
            args = int8_block_args(self, i)
            inv_se = float(args.pop("inv_se"))
            ops = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in args.items()}
            self._block_args[i] = (inv_se, pack_int8_block_s1(**ops))

    def fused_block_indices(self) -> List[int]:
        """The blocks the int8 block kernel runs under `fused_blocks`: stride
        1 with an expand and a residual, none of their convs in skip_tags."""
        if not self.fused_blocks:
            return []
        out, cin = [], self.cfg.width(self.cfg.stem_channels)
        for i, (t, c, s, _) in enumerate(self.plan):
            tags = (f"b{i}.expand", f"b{i}.dw", f"b{i}.project")
            if s == 1 and t != 1 and cin == c and not self.skip_tags.intersection(tags):
                out.append(i)
            cin = c
        return out

    # ------------------------------------------------------------------ #

    def _weight_scale_t(self, tag: str) -> Optional[torch.Tensor]:
        """The fixed weight scale of `tag` as a device tensor, or None: the
        tensor cached at install when the entry is the installed one, so a
        forward on a tree copies nothing from the host."""
        v = self.weight_scales.get(tag)
        if v is None or isinstance(v, torch.Tensor):
            return v
        hit = self._ws.get(tag)
        return hit[1] if hit is not None and hit[0] is v else _f32(v, self.device)

    def _quant_operands(self, tag: str, k: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The int8 operands of `tag` formed from the kernel tensor `k` on
        the device, for the installed weights and for a tree's alike: the
        int8 weight in its op's layout, the input scale and the epilogue
        scale `sx * sw`."""
        cv = self.convs[tag]
        kq, sw = quantize_weight_t(k, self._weight_scale_t(tag), self.wqmax)
        if cv.groups > 1:
            w = kq[:, :, 0, :]
        elif cv.kh == 1:  # (Cin, Cout), held column-major as the int8 product takes it
            w = kq[0, 0].t().contiguous().t()
        else:
            w = kq
        sx = self._qsx[tag]
        return {"w": w, "sx": sx, "scale": sx * sw}

    def _conv(
        self,
        tag: str,
        mode: str,
        x: torch.Tensor,
        act: str,
        out_dtype=torch.bfloat16,
        out_int8_tag: Optional[str] = None,
        params: Optional[Dict[str, Any]] = None,
    ) -> torch.Tensor:
        """One conv of the engine graph (`engine.py:233-424` of the JAX
        package). out_int8_tag: in the quant and fakequant modes, emit the
        consumer's (fake-)quantized input from this conv's epilogue.
        params: the tree to form the weights from; None takes the installed
        ones."""
        cv = self.convs[tag]
        quantize = mode in ("quant", "fakequant") and self.quantizes(tag)
        if out_int8_tag is not None and (out_int8_tag in self.skip_tags or mode not in ("quant", "fakequant")):
            out_int8_tag = None
        if params is not None:
            node = _tree_get(params, self.conv_paths()[tag])
            k, bias = node["kernel"], node["bias"].float()
        else:
            k, bias = cv.kernel_t, cv.bias
        if mode == "calibrate":
            self._collector[tag] = self._calib_stat(x, per_channel=cv.groups > 1 and self.int8_dw)
        if quantize and mode == "fakequant":
            xq = fake_quant(x, self._qsx[tag])
            kq = fake_quant_weight(k, self._weight_scale_t(tag), self.wqmax)
            y = conv_nhwc(xq, kq, cv.stride, cv.groups) + bias
        elif quantize:
            q = self._q[tag] if params is None else self._quant_operands(tag, k)
            if x.dtype == torch.int8:
                xq = x  # the producer emitted this conv's quantization
            else:
                xq = torch.round(x.float() / q["sx"]).clamp_(-127, 127).to(torch.int8)
            if self._cap_tag == tag:
                self._cap_out.update(xq=xq, sx=q["sx"], stride=cv.stride, groups=cv.groups, act=act)
            if cv.groups > 1:
                acc = dwconv3x3_int8(xq, q["w"], cv.stride)
            elif cv.kh == 1:
                acc = conv1x1_int8(xq, q["w"])
            else:
                acc = conv3x3_int8(xq, q["w"], cv.stride)
            y = acc.float().mul_(q["scale"]).add_(bias)
            del acc
        elif mode == "fakequant":
            # float32 convolutions on the differentiable path, quantized or not
            y = conv_nhwc(x.float(), k.float(), cv.stride, cv.groups) + bias
        else:
            xin = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
            w = cv.w_float if params is None else k.permute(3, 2, 0, 1).to(torch.bfloat16).float()
            pad = (cv.kh - 1) // 2
            y = F.conv2d(xin, w, None, cv.stride, pad, 1, cv.groups).permute(0, 2, 3, 1) + bias
        if self._bc_collector is not None and mode in ("float", "quant"):
            self._bc_collector[tag] = y.float().mean(dim=(0, 1, 2))
        if mode == "fakequant":
            if act == "relu6":
                y = clip_ties(y, 0.0, 6.0)
            elif act == "relu":
                y = relu_ties(y)
            if out_int8_tag is not None:
                # the chained epilogue, from the float32 value; the consumer's
                # own fake_quant at this scale is the identity on it
                return fake_quant(y, self._sx[out_int8_tag])
            return y.to(out_dtype)
        if act == "relu6":
            y = y.clamp_(0.0, 6.0)
        elif act == "relu":
            y = y.relu_()
        if mode == "float" and self._cap_tag == tag:
            self._cap_out["y"] = y.float()
        if out_int8_tag is not None:
            return torch.round(y.div_(self._sx[out_int8_tag])).clamp_(-127, 127).to(torch.int8)
        return y.to(out_dtype)

    def _calib_stat(self, x: torch.Tensor, per_channel: bool) -> torch.Tensor:
        a = x.abs()
        q = self._calib_percentile
        if per_channel:
            if q is None:
                return a.amax(dim=(0, 1, 2))
            return percentile_linear(a.reshape(-1, a.shape[-1]).float(), q, dim=0)
        return a.max() if q is None else percentile_linear(a.float(), q)

    # ------------------------------------------------------------------ #

    def run_block(self, i: int, y: torch.Tensor, mode: str = "quant", params=None) -> torch.Tensor:
        """Backbone block `i` on its NHWC input `y`: in quant mode on the
        installed weights, one launch of the int8 block kernel where
        `fused_blocks` takes the block and no collector or capture is on;
        else its expand, depthwise and project convs and the skip add."""
        from tpucenterface_torch.ops.int8_block import int8_block_s1

        hooked = self._bc_collector is not None or self._cap_tag is not None
        if mode == "quant" and params is None and not hooked and i in self._block_args:
            inv_se, packed = self._block_args[i]
            return int8_block_s1(y, inv_se, packed)
        t, _, s, _ = self.plan[i]
        act = "relu6" if self.cfg.relu6 else "relu"
        z = y
        if t != 1:
            z = self._conv(f"b{i}.expand", mode, z, act, out_int8_tag=f"b{i}.dw" if self.int8_dw else None,
                           params=params)
        z = self._conv(f"b{i}.dw", mode, z, act, out_int8_tag=f"b{i}.project", params=params)
        z = self._conv(f"b{i}.project", mode, z, "none", params=params)
        return y + z if s == 1 and y.shape[-1] == z.shape[-1] else z

    def _forward(
        self, x: torch.Tensor, mode: str, params: Optional[Dict[str, Any]] = None, weight_scales=None
    ) -> Dict[str, torch.Tensor]:
        """The engine graph on the NHWC batch `x` in `mode`. params: a tree
        in `p`'s layout to form every weight from on this call (None: the
        installed weights; 'fakequant' then differentiates `p`).
        weight_scales: fixed weight scales installed for this forward only."""
        if weight_scales is not None:
            saved, self.weight_scales = self.weight_scales, weight_scales
            try:
                return self._forward(x, mode, params)
            finally:
                self.weight_scales = saved
        if mode in ("quant", "fakequant") and self.act_scales is None:
            raise ValueError(f"the {mode} mode needs a calibrated engine: calibrate() or set_scales() first")
        if mode == "fakequant" and params is None:
            params = self.p
        cfg = self.cfg
        act = "relu6" if cfg.relu6 else "relu"
        y = self._conv("stem", mode, x, act, params=params)
        feats: Dict[int, torch.Tensor] = {}
        for i, (_, _, _, out_stride) in enumerate(self.plan):
            y = self.run_block(i, y, mode, params)
            if _is_skip(self.plan, i):
                feats[out_stride] = y

        strides = sorted(feats, reverse=True)
        y = self._conv(f"lat{strides[0]}", mode, feats[strides[0]], act, params=params)
        for s in strides[1:]:
            lat = self._conv(f"lat{s}", mode, feats[s], act, params=params)
            b, h, w, c = y.shape
            y = y[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c) + lat
            y = self._conv(f"smooth{s}", mode, y, act, params=params)

        z = self._conv("head.conv", mode, y, "relu", out_int8_tag="head.out", params=params)
        out_full = self._conv("head.out", mode, z, "none", out_dtype=torch.float32, params=params)
        names = [("hm", cfg.num_classes), ("wh", 2), ("off", 2)]
        if cfg.with_landmarks:
            names.append(("lm", 10))
        out, c0 = {}, 0
        for name, n in names:
            out[name] = out_full[..., c0 : c0 + n]
            c0 += n
        out["whoff"] = out_full[..., cfg.num_classes : cfg.num_classes + 4]
        return out

    # ------------------------------------------------------------------ #

    def calibrate(self, batches: List[Any], percentile: Optional[float] = None) -> Dict[str, Any]:
        """Run bf16 forwards recording each conv input's absolute maximum
        (per channel for the depthwise convs under int8_dw) and install the
        result as the activation scales. `batches`: normalized NHWC arrays or
        tensors. percentile: calibrate each scale at that percentile of |x|
        instead of the maximum; batches still aggregate by maximum."""
        if percentile is not None and not 50.0 < percentile <= 100.0:
            raise ValueError(f"percentile must be in (50, 100], got {percentile}")
        self._calib_percentile = percentile
        self._amax = {}
        self.weight_scales.clear()
        for xb in batches:
            x = torch.as_tensor(xb).to(self.device)
            self._collector = {}
            with torch.inference_mode():
                self._forward(x, "calibrate")
            amax = {tag: v.float().cpu().numpy() for tag, v in self._collector.items()}
            self._collector = {}
            for tag, v in amax.items():
                v = np.asarray(v, np.float64)
                if v.ndim:
                    prev = self._amax.get(tag, 0.0)
                    self._amax[tag] = np.maximum(np.maximum(v, prev), 1e-6)
                else:
                    self._amax[tag] = max(self._amax.get(tag, 0.0), float(v), 1e-6)
        self.act_scales = dict(self._amax)
        self._install()
        return self.act_scales

    def set_scales(self, scales: Dict[str, Any]) -> None:
        """Install persisted scales (skip calibration): floats for per-tensor
        entries, arrays or lists for the per-channel depthwise entries,
        "w:<tag>" fixed weight scales, and the "cfg:weight_bits" and
        "cfg:int8_dw" entries, which must match this engine. Replaces all
        quantization state."""
        self.weight_scales.clear()
        out: Dict[str, Any] = {}
        for k, v in scales.items():
            if k == "cfg:weight_bits":
                if int(v) != self.weight_bits:
                    raise ValueError(
                        f"persisted scales were calibrated at weight_bits={int(v)} but this engine is "
                        f"weight_bits={self.weight_bits}; pass the matching weight_bits"
                    )
                continue
            if k == "cfg:int8_dw":
                if bool(int(v)) != self.int8_dw:
                    raise ValueError(
                        f"persisted scales were calibrated with int8_dw={bool(int(v))} but this engine is "
                        f"int8_dw={self.int8_dw}; pass the matching int8_dw"
                    )
                continue
            if k.startswith("w:"):
                self.weight_scales[k[2:]] = np.asarray(v, np.float32)
                continue
            arr = np.asarray(v, np.float64)
            out[k] = arr if arr.ndim else max(float(arr), 1e-6)
        self.act_scales = out
        self._install()

    def __call__(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            return self._forward(x, "float" if self.act_scales is None else "quant")

    def float_forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            return self._forward(x, "float")


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else _to_np(v) for k, v in tree.items()}


def _to_np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().float().cpu().numpy()
    return np.asarray(v, np.float32)


def _tensor_tree(tree, device):
    """The tree's leaves as float32 tensors on `device`, detached copies."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _tensor_tree(v, device)
        elif isinstance(v, torch.Tensor):
            out[k] = v.detach().to(device=device, dtype=torch.float32).clone()
        else:
            out[k] = torch.from_numpy(np.array(v, np.float32)).to(device)
    return out
