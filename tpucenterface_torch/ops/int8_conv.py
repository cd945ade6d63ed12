"""int8 1x1 convolution with an int8 requantizing epilogue: the CUDA kernel
`csrc/int8_conv.cu` and its plain version.

Replaces the TPU kernel `tpucenterface/bench/probe_int8_conv.py::
make_pallas_conv1x1_int8` and keeps its contract, planar:

    x (B, Cin, P) int8, w (Cout, Cin) int8, scale and bias (Cout,) float32
    acc = w @ x[b]                      int32 sums
    out = clip(round(acc * scale + bias), -127, 127)  int8, round half to even

The TPU kernel pads Cout to 32 rows, the int8 sublane tile; the port takes
the logical channel counts. The plain version `conv1x1_int8_plain` is the
probe's `xla_fn` (`probe_int8_conv.py:114-122`) in torch. No engine path
runs this kernel: every 1x1 conv of the quantized engine with an int8 output
has an activation ahead of its requantization, and every project emits bf16.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpucenterface_torch.quant.int8_ops import _mm


def _vec(t: torch.Tensor, n: int, name: str) -> torch.Tensor:
    """A (n,) or (n, 1) float32 operand as a contiguous (n,) tensor."""
    if t.numel() != n or t.dim() not in (1, 2) or (t.dim() == 2 and t.shape[1] != 1):
        raise ValueError(f"{name} must be ({n},) or ({n}, 1), got {tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    return t.reshape(n).contiguous()


def _check(x, w, scale, bias):
    if x.dim() != 3 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x must be (B, Cin, P) and w (Cout, Cin), got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"x and w must be int8, got {x.dtype}, {w.dtype}")
    cout = w.shape[0]
    return _vec(scale, cout, "scale"), _vec(bias, cout, "bias")


def conv1x1_int8_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain torch version: int32 product (`quant.int8_ops._mm`), then the
    float32 epilogue with one rounding after the product and one after the
    sum, round half to even, clip to +-127."""
    s, b = _check(x, w, scale, bias)
    bsz, cin, p = x.shape
    acc = _mm(x.permute(0, 2, 1).reshape(-1, cin), w.t())  # (B*P, Cout)
    y = acc.float() * s + b
    return torch.round(y).clamp_(-127, 127).to(torch.int8).reshape(bsz, p, -1).permute(0, 2, 1).contiguous()


_P, _I32 = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built `tcf_int8_conv1x1` entry point of csrc/int8_conv.cu, typed."""
    from tpucenterface_torch.kernels import build

    fn = build.load("int8_conv").tcf_int8_conv1x1
    fn.argtypes = [_P] * 5 + [_I32] * 4 + [_P]
    fn.restype = _I32
    return fn


def int8_conv1x1(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(B, Cin, P) int8 -> (B, Cout, P) int8 (see the module docstring).

    CUDA tensors launch `csrc/int8_conv.cu` (x and w contiguous); CPU tensors
    take the plain version. `int8_conv1x1.launches` counts kernel launches."""
    s, b = _check(x, w, scale, bias)
    if x.device.type == "cpu":
        return conv1x1_int8_plain(x, w, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv1x1 runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    if x.numel() == 0 or w.numel() == 0:
        raise ValueError(f"empty operands {tuple(x.shape)}, {tuple(w.shape)}")
    if any(t.device != x.device for t in (w, s, b)):
        raise ValueError("all operands must be on x's device")
    bsz, cin, p = x.shape
    cout = w.shape[0]
    out = torch.empty((bsz, cout, p), dtype=torch.int8, device=x.device)
    fn = _kernel()
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, cin, p, cout,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8 conv1x1 kernel launch failed with CUDA error {rc}")
    int8_conv1x1.launches += 1
    return out


int8_conv1x1.launches = 0
