"""W8A8 post-training quantized inference engine.

Mirrors `tpucenterface/quant/engine.py` (`stem_fixed_scale`, `stem_input_lut`,
`apply_stem_lut`, `_quantize_weight`, `QuantEngine`). One traversal drives
three modes:
- 'float'     : the bf16 folded forward (bf16 operands, float32 sums);
- 'calibrate' : the same forward, recording each conv input's absolute
                maximum (or a percentile of it);
- 'quant'     : int8 weights (per-output-channel scales) x int8 activations
                (per-tensor calibrated scales, per-channel for the depthwise
                convs under `int8_dw`), int32 sums (`quant.int8_ops`), a
                float32 epilogue `acc * (sx * sw) + b`, the activation, and
                either a bf16 output or, where the consumer is quantized too,
                the consumer's int8 input (`out_int8_tag` chaining).
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
  epilogue scale `sx * sw` is a float32 product. Scales are formed in numpy on
  the host and moved to the device as tensors;
- the quantizing divisions divide by a tensor on the tensor's own device:
  PyTorch's CUDA division by a CPU scalar multiplies by its reciprocal, which
  can round differently;
- `torch.quantile` refuses more than 2^24 elements, so `percentile_linear`
  writes `jnp.percentile`'s linear interpolation, in float32, with
  `torch.kthvalue`;
- calibration runs the bf16 float forward, whose sums the card and the CPU
  take in different orders; compare the two devices under one `set_scales`
  dict, not under two calibrations.

Left for later: the `fakequant` mode (QAT), the AdaRound capture and the
bias-correction collectors.
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


def _quantize_weight(k: np.ndarray, fixed_scale=None, qmax: int = 127):
    """Per-output-channel symmetric weight quantization of an HWIO kernel ->
    (int8 kernel, float32 scales). qmax 127 for int8 weights, 7 for int4
    (still held in int8). `fixed_scale` overrides the per-channel scale."""
    k = np.asarray(k, np.float32)
    if fixed_scale is not None:
        sw = np.asarray(fixed_scale, np.float32)
    else:
        amax = np.max(np.abs(k), axis=(0, 1, 2))
        sw = np.maximum(amax, np.float32(1e-8)) / np.float32(qmax)
    kq = np.clip(np.round(k / sw), -qmax, qmax).astype(np.int8)
    return kq, sw.astype(np.float32)


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
    """One conv of the engine graph: HWIO float32 kernel, bias, stride,
    groups, and its float-mode weight (bf16-rounded, OIHW, float32)."""

    def __init__(self, kernel, bias, stride, groups, device):
        self.kernel = np.asarray(kernel, np.float32)
        self.bias_np = np.asarray(bias, np.float32)
        self.stride, self.groups = stride, groups
        self.kh = self.kernel.shape[0]
        w = torch.from_numpy(np.ascontiguousarray(self.kernel.transpose(3, 2, 0, 1)))
        self.w_float = w.to(torch.bfloat16).float().to(device)
        self.bias = torch.from_numpy(self.bias_np).to(device)


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
        params = _np_tree(folded_variables["params"])
        if "fused" not in params.get("heads", {}):
            names = [n for n in ("hm", "wh", "off", "lm") if n in params["heads"]]
            if any("conv" not in params["heads"][n] for n in names):
                raise ValueError(
                    "QuantEngine requires head_conv > 0 (fused-head form needs the hidden head conv); "
                    "this model has single-1x1 heads"
                )
            params["heads"] = {"fused": fuse_head_params(params["heads"], names)}
        self.plan = backbone_plan(cfg)
        self.act_scales: Optional[Dict[str, Any]] = None
        self.weight_scales: Dict[str, Any] = {}
        self._amax: Dict[str, Any] = {}
        self._calib_percentile: Optional[float] = None
        self.pp_cfg = pp_cfg
        self.convs = self._conv_table(params)
        self._collector: Dict[str, torch.Tensor] = {}  # conv input statistics of a calibrate forward
        self._q: Dict[str, Dict[str, torch.Tensor]] = {}
        self._sx: Dict[str, torch.Tensor] = {}
        self._block_args: Dict[int, Tuple[float, Any]] = {}  # block: (inv_se, PackedInt8BlockS1)

    def _conv_table(self, params) -> Dict[str, _Conv]:
        """{tag: _Conv} of every conv of the folded, head-fused `params`."""
        bb, nk, hf = params["backbone"], params["neck"], params["heads"]["fused"]
        dev = self.device

        def node(n, stride=1, groups=1):
            return _Conv(n["conv"]["kernel"], n["conv"]["bias"], stride, groups, dev)

        convs = {"stem": node(bb["stem"], stride=2)}
        for i, (t, _, s, _) in enumerate(self.plan):
            blk = bb[f"block_{i}"]
            if t != 1:
                convs[f"b{i}.expand"] = node(blk["expand"])
            ce = np.shape(blk["depthwise"]["conv"]["kernel"])[-1]
            convs[f"b{i}.dw"] = node(blk["depthwise"], stride=s, groups=ce)
            convs[f"b{i}.project"] = node(blk["project"])
        for key in nk:
            kind, s = key.split("_")
            convs[f"{'lat' if kind == 'lateral' else 'smooth'}{s}"] = node(nk[key])
        convs["head.conv"] = _Conv(hf["conv"]["kernel"], hf["conv"]["bias"], 1, 1, dev)
        convs["head.out"] = _Conv(hf["out"]["kernel"], hf["out"]["bias"], 1, 1, dev)
        return convs

    def _stem_fixed_scale(self) -> float:
        if self.pp_cfg is None:
            raise ValueError(
                "stem_preprocess models need pp_cfg (the PreprocessConfig whose mean defines the stem input "
                "range); pass it to QuantEngine(pp_cfg=...)"
            )
        return stem_fixed_scale(self.pp_cfg)

    # ------------------------------------------------------------------ #
    # scales and quantized weights, formed on the host as the JAX engine
    # forms them
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

    def quant_weight(self, tag: str):
        """(int8 HWIO kernel, float32 per-output-channel scales) of `tag`."""
        return _quantize_weight(self.convs[tag].kernel, self.weight_scales.get(tag), self.wqmax)

    def _install(self) -> None:
        """Device tensors of the installed scales: each quantized conv's int8
        weight in its op's layout, its input scale and epilogue scale; each
        scale a consumer's chained epilogue divides by; the block kernel's
        operands under `fused_blocks`, packed once in the kernel's layout."""
        from tpucenterface_torch.ops.int8_block import pack_int8_block_s1
        from tpucenterface_torch.weights.convert import int8_block_args

        dev = self.device
        self._q, self._sx = {}, {}
        for tag, cv in self.convs.items():
            if tag in self.act_scales:
                self._sx[tag] = torch.tensor(self.act_scale(tag), device=dev)
            if not self.quantizes(tag):
                continue
            kq, sw = self.quant_weight(tag)
            if cv.groups > 1:
                w = torch.from_numpy(np.ascontiguousarray(kq[:, :, 0, :])).to(dev)
            elif cv.kh == 1:  # (Cin, Cout), held column-major as the int8 product takes it
                w = torch.from_numpy(np.ascontiguousarray(kq[0, 0].T)).to(dev).t()
            else:
                w = torch.from_numpy(kq).to(dev)
            sx = self.input_scale(tag)
            self._q[tag] = {
                "w": w,
                "sx": torch.tensor(sx, device=dev),
                "scale": torch.from_numpy(np.asarray(sx * sw, np.float32)).to(dev),
            }
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

    def _conv(
        self,
        tag: str,
        mode: str,
        x: torch.Tensor,
        act: str,
        out_dtype=torch.bfloat16,
        out_int8_tag: Optional[str] = None,
    ) -> torch.Tensor:
        """One conv of the engine graph (`engine.py:233-424` of the JAX
        package, modes float, calibrate and quant). out_int8_tag: in quant
        mode, emit the consumer's int8 input from this conv's epilogue."""
        cv = self.convs[tag]
        quantize = mode == "quant" and self.quantizes(tag)
        if out_int8_tag is not None and (out_int8_tag in self.skip_tags or mode != "quant"):
            out_int8_tag = None
        if mode == "calibrate":
            self._collector[tag] = self._calib_stat(x, per_channel=cv.groups > 1 and self.int8_dw)
        if quantize:
            q = self._q[tag]
            if x.dtype == torch.int8:
                xq = x  # the producer emitted this conv's quantization
            else:
                xq = torch.round(x.float() / q["sx"]).clamp_(-127, 127).to(torch.int8)
            if cv.groups > 1:
                acc = dwconv3x3_int8(xq, q["w"], cv.stride)
            elif cv.kh == 1:
                acc = conv1x1_int8(xq, q["w"])
            else:
                acc = conv3x3_int8(xq, q["w"], cv.stride)
            y = acc.float().mul_(q["scale"]).add_(cv.bias)
            del acc
        else:
            xin = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
            pad = (cv.kh - 1) // 2
            y = F.conv2d(xin, cv.w_float, None, cv.stride, pad, 1, cv.groups).permute(0, 2, 3, 1) + cv.bias
        if act == "relu6":
            y = y.clamp_(0.0, 6.0)
        elif act == "relu":
            y = y.relu_()
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

    def run_block(self, i: int, y: torch.Tensor, mode: str = "quant") -> torch.Tensor:
        """Backbone block `i` on its NHWC input `y`: in quant mode one launch
        of the int8 block kernel where `fused_blocks` takes the block, else
        its expand, depthwise and project convs and the skip add."""
        from tpucenterface_torch.ops.int8_block import int8_block_s1

        if mode == "quant" and i in self._block_args:
            inv_se, packed = self._block_args[i]
            return int8_block_s1(y, inv_se, packed)
        t, _, s, _ = self.plan[i]
        act = "relu6" if self.cfg.relu6 else "relu"
        z = y
        if t != 1:
            z = self._conv(f"b{i}.expand", mode, z, act, out_int8_tag=f"b{i}.dw" if self.int8_dw else None)
        z = self._conv(f"b{i}.dw", mode, z, act, out_int8_tag=f"b{i}.project")
        z = self._conv(f"b{i}.project", mode, z, "none")
        return y + z if s == 1 and y.shape[-1] == z.shape[-1] else z

    def _forward(self, x: torch.Tensor, mode: str) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        act = "relu6" if cfg.relu6 else "relu"
        y = self._conv("stem", mode, x, act)
        feats: Dict[int, torch.Tensor] = {}
        for i, (_, _, _, out_stride) in enumerate(self.plan):
            y = self.run_block(i, y, mode)
            if _is_skip(self.plan, i):
                feats[out_stride] = y

        strides = sorted(feats, reverse=True)
        y = self._conv(f"lat{strides[0]}", mode, feats[strides[0]], act)
        for s in strides[1:]:
            lat = self._conv(f"lat{s}", mode, feats[s], act)
            b, h, w, c = y.shape
            y = y[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c) + lat
            y = self._conv(f"smooth{s}", mode, y, act)

        z = self._conv("head.conv", mode, y, "relu", out_int8_tag="head.out")
        out_full = self._conv("head.out", mode, z, "none", out_dtype=torch.float32)
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
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v, np.float32) for k, v in tree.items()}
