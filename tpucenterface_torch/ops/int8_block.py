"""The int8 MobileNetV2 block in one kernel: the CUDA kernel
`csrc/int8_block.cu` (stride 2, B6, and stride 1, B7), its plain versions and
the JAX layout's helpers.

Replaces the TPU kernels of `tpucenterface/bench/probe_fused_block.py`:
- `make_fused_block_kernel` (B6): int8 in, stride-2 block, int8 out;
- `make_fused_block_s1_kernel` (B7): bf16 in, quantized inside the kernel at
  a scalar expand scale, stride-1 block, bf16 out with the residual added in
  float32.
Both compute, per position, with per-channel float32 vectors:

    e  = clip(round(clip(acc_e * e_scale + e_bias, 0, 6) * e_inv_sdw), +-127)
         acc_e = x_q @ we^T                           1x1 expand, int32 sums
    d  = clip(round(clip(acc_d * d_scale + d_bias, 0, 6) * d_inv_sproj), +-127)
         acc_d = sum of the nine taps e * wd          3x3 depthwise, exact
    yp = acc_p * p_scale + p_bias, acc_p = d @ wp^T   1x1 project, int32 sums
    B6: out = clip(round(yp), +-127) int8
    B7: x_q = clip(round(x * inv_se), +-127); out = bf16(yp [+ x])

with one float32 rounding after each product and each sum (no fused
multiply-add), rounding half to even, and zeros at the map's padding
positions of e. The depthwise taps hold integers (wd (9, Cmid), tap-major,
as float32 in the JAX layout); |9 * 127 * 127| < 2^24, so the JAX package's
float32 multiply-adds and the port's int32 ones give the same sums.

Layouts. The TPU kernels take planar (B, C, P) tensors, B6's input as
space-to-depth parity planes (`nhwc_to_parity_planar`) and both with halo'd
band copies (`pad_bands`): devices of Mosaic's weak strided lane access and
Pallas's disjoint blocks. The CUDA kernel reads the engine's NHWC tensors
and its halo'd tile directly. The plain versions take NHWC
(`fused_block_int8_plain`, `fused_block_s1_plain`) and the JAX layout
(`*_planar`), so the CPU tests hold them to the JAX functions; weights and
vectors take the JAX layout in both ((C,) or (C, 1) vectors).

B7 runs on the quantized engine's path (`QuantEngine(fused_blocks=True)`);
B6 is on no path: its int8 output cannot feed the residual block after each
stride-2 block, which needs the bf16 value as its skip input.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Union

import torch
import torch.nn.functional as F

from tpucenterface_torch.quant.int8_ops import conv1x1_int8, dwconv3x3_int8

# ------------------------------------------------------------------------- #
# layout helpers of the JAX package (`probe_fused_block.py:55-74`)
# ------------------------------------------------------------------------- #


def nhwc_to_parity_planar(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 4*C, (H/2)*(W/2)): plane p = 2*pr + pc holds
    x[2r+pr, 2c+pc], rows ordered parity-major, channel-minor."""
    b, h, w, c = x.shape
    hh, ww = h // 2, w // 2
    return x.reshape(b, hh, 2, ww, 2, c).permute(0, 2, 4, 5, 1, 3).reshape(b, 4 * c, hh * ww)


def parity_planar_to_nhwc(x: torch.Tensor, hh: int, ww: int) -> torch.Tensor:
    """Inverse of `nhwc_to_parity_planar`."""
    b, c4, _ = x.shape
    c = c4 // 4
    return x.reshape(b, 2, 2, c, hh, ww).permute(0, 4, 1, 5, 2, 3).reshape(b, 2 * hh, 2 * ww, c)


def planar_to_nhwc(y: torch.Tensor, hh: int, ww: int) -> torch.Tensor:
    """(B, C, hh*ww) -> (B, hh, ww, C)."""
    b, c, _ = y.shape
    return y.reshape(b, c, hh, ww).permute(0, 2, 3, 1)


def nhwc_to_planar(y: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, H*W), contiguous."""
    b, h, w, c = y.shape
    return y.permute(0, 3, 1, 2).reshape(b, c, h * w).contiguous()


# ------------------------------------------------------------------------- #
# plain versions
# ------------------------------------------------------------------------- #

_VEC_KEYS = ("e_scale", "e_bias", "e_inv_sdw", "d_scale", "d_bias", "d_inv_sproj", "p_scale", "p_bias")


def _operands(we, e_scale, e_bias, e_inv_sdw, wd, d_scale, d_bias, d_inv_sproj, wp, p_scale, p_bias):
    """Check the eleven weight operands; -> (we, wd (9, Cmid), wp, {name:
    (C,) float32 vector})."""
    if we.dtype != torch.int8 or wp.dtype != torch.int8 or we.dim() != 2 or wp.dim() != 2:
        raise TypeError(f"we and wp must be 2-D int8, got {we.dtype} {tuple(we.shape)}, {wp.dtype} {tuple(wp.shape)}")
    cmid, cout = we.shape[0], wp.shape[0]
    if wp.shape[1] != cmid or wd.numel() != 9 * cmid:
        raise ValueError(f"wp must be (Cout, {cmid}) and wd (9, {cmid}), got {tuple(wp.shape)}, {tuple(wd.shape)}")
    vals = dict(zip(_VEC_KEYS, (e_scale, e_bias, e_inv_sdw, d_scale, d_bias, d_inv_sproj, p_scale, p_bias)))
    vecs = {}
    for k, v in vals.items():
        n = cout if k.startswith("p_") else cmid
        if v.numel() != n or v.dtype != torch.float32:
            raise ValueError(f"{k} must hold {n} float32 values, got {v.dtype} {tuple(v.shape)}")
        vecs[k] = v.reshape(n).contiguous()
    return we, wd.reshape(9, cmid), wp, vecs


def _requant(acc: torch.Tensor, scale, bias, inv) -> torch.Tensor:
    """int32 sums -> clip(round(clip(acc * scale + bias, 0, 6) * inv), +-127) int8."""
    y = (acc.float() * scale + bias).clamp_(0.0, 6.0)
    return torch.round(y * inv).clamp_(-127, 127).to(torch.int8)


def _block_body(xq, we, wd, wp, v, stride):
    """int8 NHWC input -> float32 project output yp (B, Ho, Wo, Cout)."""
    e = _requant(conv1x1_int8(xq, we.t()), v["e_scale"], v["e_bias"], v["e_inv_sdw"])
    wdi = wd.reshape(3, 3, -1).to(torch.int8)
    d = _requant(dwconv3x3_int8(e, wdi, stride), v["d_scale"], v["d_bias"], v["d_inv_sproj"])
    return conv1x1_int8(d, wp.t()).float() * v["p_scale"] + v["p_bias"]


def fused_block_int8_plain(x, we, e_scale, e_bias, e_inv_sdw, wd, d_scale, d_bias, d_inv_sproj, wp, p_scale, p_bias):
    """B6's plain version on NHWC: x (B, H, W, Cin) int8 -> (B, Ho, Wo, Cout)
    int8, Ho = (H - 1) // 2 + 1; mirrors `probe_fused_block.py::fused_block_ref`."""
    if x.dtype != torch.int8 or x.dim() != 4:
        raise TypeError(f"x must be (B, H, W, Cin) int8, got {x.dtype} {tuple(x.shape)}")
    we, wd, wp, v = _operands(we, e_scale, e_bias, e_inv_sdw, wd, d_scale, d_bias, d_inv_sproj, wp, p_scale, p_bias)
    yp = _block_body(x, we, wd, wp, v, stride=2)
    return torch.round(yp).clamp_(-127, 127).to(torch.int8)


def fused_block_int8_plain_planar(x_planar, *operands, hw_out: int):
    """B6's plain version on the JAX layout: (B, 4*Cin, hw_out^2) int8
    parity planes -> (B, Cout, hw_out^2) int8 (`fused_block_ref`'s
    signature)."""
    x = parity_planar_to_nhwc(x_planar, hw_out, hw_out)
    return nhwc_to_planar(fused_block_int8_plain(x, *operands))


def _as_scalar(v: Union[float, torch.Tensor], dev) -> torch.Tensor:
    """inv_se as a float32 0-d tensor on `dev` ((1, 1) in the JAX layout)."""
    t = torch.as_tensor(v, dtype=torch.float32)
    if t.numel() != 1:
        raise ValueError(f"inv_se must be one value, got shape {tuple(t.shape)}")
    return t.reshape(()).to(dev)


def fused_block_s1_plain(x, inv_se, we, e_scale, e_bias, e_inv_sdw, wd, d_scale, d_bias, d_inv_sproj, wp, p_scale,
                         p_bias, residual: bool = True):
    """B7's plain version on NHWC: x (B, H, W, Cin) bf16 -> (B, H, W, Cout)
    bf16; the residual adds x, zero-padded to Cout channels, in float32.
    Mirrors `probe_fused_block.py::fused_block_s1_ref`."""
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise TypeError(f"x must be (B, H, W, Cin) bf16, got {x.dtype} {tuple(x.shape)}")
    we, wd, wp, v = _operands(we, e_scale, e_bias, e_inv_sdw, wd, d_scale, d_bias, d_inv_sproj, wp, p_scale, p_bias)
    cin, cout = x.shape[-1], wp.shape[0]
    if residual and cout < cin:
        raise ValueError(f"the residual needs Cout >= Cin, got {cout} < {cin}")
    xf = x.float()
    xq = torch.round(xf * _as_scalar(inv_se, x.device)).clamp_(-127, 127).to(torch.int8)
    yp = _block_body(xq, we, wd, wp, v, stride=1)
    if residual:
        yp = yp + F.pad(xf, (0, cout - cin))
    return yp.to(torch.bfloat16)


def fused_block_s1_plain_planar(x_planar, inv_se, *operands, hw: int, residual: bool = True):
    """B7's plain version on the JAX layout: (B, Cin, hw^2) bf16 -> (B, Cout,
    hw^2) bf16 (`fused_block_s1_ref`'s signature)."""
    x = planar_to_nhwc(x_planar, hw, hw)
    return nhwc_to_planar(fused_block_s1_plain(x, inv_se, *operands, residual=residual))


# ------------------------------------------------------------------------- #
# the kernel
# ------------------------------------------------------------------------- #

_P, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built `tcf_int8_block` entry point of csrc/int8_block.cu, typed."""
    from tpucenterface_torch.kernels import build

    fn = build.load("int8_block").tcf_int8_block
    fn.argtypes = [_P] * 12 + [_F32, _P] + [_I32] * 8 + [_P]
    fn.restype = _I32
    return fn


def _launch(x, inv_se, operands, stride: int, residual: bool, out_dtype) -> torch.Tensor:
    we, wd, wp, v = _operands(*operands)
    dev = x.device
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous NHWC, 16-byte aligned")
    if x.numel() == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    b, h, w, cin = x.shape
    cmid, cout = we.shape[0], wp.shape[0]
    if we.shape[1] != cin or cin % 8 or cout % 8:
        raise ValueError(f"we must be (Cmid, {cin}); the kernel takes Cin and Cout multiples of 8, got {cin}, {cout}")
    if residual and cout < cin:
        raise ValueError(f"the residual needs Cout >= Cin, got {cout} < {cin}")
    if any(t.device != dev for t in (we, wd, wp, *v.values())):
        raise ValueError("all operands must be on x's device")
    # held in locals until the launch has been enqueued
    wdi, wec, wpc = wd.to(torch.int8).contiguous(), we.contiguous(), wp.contiguous()
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    out = torch.empty((b, ho, wo, cout), dtype=out_dtype, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        rc = fn(
            x.data_ptr(), wec.data_ptr(), v["e_scale"].data_ptr(), v["e_bias"].data_ptr(),
            v["e_inv_sdw"].data_ptr(), wdi.data_ptr(), v["d_scale"].data_ptr(), v["d_bias"].data_ptr(),
            v["d_inv_sproj"].data_ptr(), wpc.data_ptr(), v["p_scale"].data_ptr(), v["p_bias"].data_ptr(),
            float(inv_se), out.data_ptr(), b, h, w, cin, cmid, cout, stride, int(residual),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"int8 block kernel launch failed with CUDA error {rc}")
    return out


def _device_check(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")


def int8_block_s2(x, we, e_scale, e_bias, e_inv_sdw, wd, d_scale, d_bias, d_inv_sproj, wp, p_scale, p_bias):
    """B6: the stride-2 int8 block, NHWC int8 -> NHWC int8 (see the module
    docstring). CUDA tensors launch `csrc/int8_block.cu`; CPU tensors take
    the plain version. `int8_block_s2.launches` counts kernel launches."""
    ops = (we, e_scale, e_bias, e_inv_sdw, wd, d_scale, d_bias, d_inv_sproj, wp, p_scale, p_bias)
    if x.device.type == "cpu":
        return fused_block_int8_plain(x, *ops)
    _device_check(x, "int8_block_s2")
    if x.dtype != torch.int8 or x.dim() != 4:
        raise TypeError(f"x must be (B, H, W, Cin) int8, got {x.dtype} {tuple(x.shape)}")
    out = _launch(x, 0.0, ops, stride=2, residual=False, out_dtype=torch.int8)
    int8_block_s2.launches += 1
    return out


def int8_block_s1(x, inv_se, we, e_scale, e_bias, e_inv_sdw, wd, d_scale, d_bias, d_inv_sproj, wp, p_scale, p_bias,
                  residual: bool = True):
    """B7: the stride-1 block, NHWC bf16 -> NHWC bf16 (see the module
    docstring); `inv_se` a float or a one-element tensor. CUDA tensors launch
    `csrc/int8_block.cu`; CPU tensors take the plain version.
    `int8_block_s1.launches` counts kernel launches."""
    ops = (we, e_scale, e_bias, e_inv_sdw, wd, d_scale, d_bias, d_inv_sproj, wp, p_scale, p_bias)
    if x.device.type == "cpu":
        return fused_block_s1_plain(x, inv_se, *ops, residual=residual)
    _device_check(x, "int8_block_s1")
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise TypeError(f"x must be (B, H, W, Cin) bf16, got {x.dtype} {tuple(x.shape)}")
    out = _launch(x, float(inv_se), ops, stride=1, residual=residual, out_dtype=torch.bfloat16)
    int8_block_s1.launches += 1
    return out


int8_block_s1.launches = 0
int8_block_s2.launches = 0
