"""Fused MobileNetV2 inverted-residual block: the CUDA kernel `csrc/mbconv.cu`,
its plain version and a float32 reference.

Mirrors `tpucenterface/ops/fused_mbconv.py` (`fused_mbconv`, `mbconv_reference`),
the TPU kernel it replaces, for stride-1 blocks:

    1x1 expand + bias + ReLU6 -> 3x3 depthwise + bias + ReLU6
    -> 1x1 project + bias [-> + skip]

in one kernel, so the expanded tensor never reaches device memory. Tensors
are NHWC: x (B, H, W, Cin); w1 (Cin, Ce) or None when the block has no
expand (then Ce == Cin); wd (3, 3, Ce); w2 (Ce, Cout); biases 1-D.

`fused_mbconv` launches the kernel for CUDA tensors and takes
`fused_mbconv_plain` only for tensors on the CPU. The plain version has the
kernel's own cast points (bfloat16 operands, float32 sums); `mbconv_reference`
is the same block in float32 throughout.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

# The kernel keeps a halo'd input tile and one chunk of w1 in shared memory at
# the input's full channel width; 208 channels is what 227 KB holds.
MAX_CIN = 208


def _act(v: torch.Tensor, relu6: bool) -> torch.Tensor:
    return v.clamp(0.0, 6.0) if relu6 else v.relu()


def _check_shapes(x, w1, b1, wd, bd, w2, b2, skip: bool):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Cin), got {tuple(x.shape)}")
    cin = x.shape[-1]
    if wd.dim() != 3 or tuple(wd.shape[:2]) != (3, 3):
        raise ValueError(f"wd must be (3, 3, Ce), got {tuple(wd.shape)}")
    ce = wd.shape[-1]
    if (w1 is None) != (b1 is None):
        raise ValueError("w1 and b1 are given together or not at all")
    if w1 is None:
        if ce != cin:
            raise ValueError(f"without an expand Ce must equal Cin, got {ce} and {cin}")
    elif tuple(w1.shape) != (cin, ce) or tuple(b1.shape) != (ce,):
        raise ValueError(f"w1 must be ({cin}, {ce}) and b1 ({ce},), got {tuple(w1.shape)}, {tuple(b1.shape)}")
    if w2.dim() != 2 or w2.shape[0] != ce:
        raise ValueError(f"w2 must be ({ce}, Cout), got {tuple(w2.shape)}")
    cout = w2.shape[1]
    if tuple(bd.shape) != (ce,) or tuple(b2.shape) != (cout,):
        raise ValueError(f"bd must be ({ce},) and b2 ({cout},), got {tuple(bd.shape)}, {tuple(b2.shape)}")
    if skip and cin != cout:
        raise ValueError(f"the skip needs Cin == Cout, got {cin} and {cout}")
    return cin, ce, cout


def mbconv_reference(x, w1, b1, wd, bd, w2, b2, *, skip: bool, relu6: bool = True) -> torch.Tensor:
    """The block in float32 (convolutions of the input as it is, one cast at
    the end to `x.dtype`)."""
    _, ce, _ = _check_shapes(x, w1, b1, wd, bd, w2, b2, skip)
    xf = x.float()
    y = xf.permute(0, 3, 1, 2)
    if w1 is not None:
        y = _act(F.conv2d(y, w1.float().t()[:, :, None, None], b1.float()), relu6)
    y = F.conv2d(y, wd.float().permute(2, 0, 1)[:, None], bd.float(), padding=1, groups=ce)
    y = F.conv2d(_act(y, relu6), w2.float().t()[:, :, None, None], b2.float())
    y = y.permute(0, 2, 3, 1)
    if skip:
        y = y + xf
    return y.to(x.dtype)


def fused_mbconv_plain(x, w1, b1, wd, bd, w2, b2, *, skip: bool, relu6: bool = True) -> torch.Tensor:
    """Plain torch version of the kernel, with its cast points: the input and
    all weights and biases are rounded to bfloat16; the expand sums in
    float32, adds b1, activates and rounds to bfloat16; expanded values at
    the image's zero-pad positions are 0 (not act(b1)); the nine depthwise
    taps sum in float32 in the order dy, dx; the depthwise result is rounded
    to bfloat16; the project sums in float32, adds b2 and the skip, and
    rounds once to `x.dtype`. bfloat16 values and their pairwise products are
    exact in float32, so float32 matrix products stand for the kernel's
    bfloat16 products with float32 accumulation."""
    _check_shapes(x, w1, b1, wd, bd, w2, b2, skip)
    bf = torch.bfloat16

    def r(t):  # round to bfloat16, continue in float32
        return t.to(bf).float()

    b, h, w, _ = x.shape
    xb = r(x)
    e = xb
    if w1 is not None:
        e = r(_act(torch.matmul(xb, r(w1)) + r(b1), relu6))
    # zero-pad after the expand: the border taps see 0
    ep = F.pad(e, (0, 0, 1, 1, 1, 1))
    wdf = r(wd)
    acc = torch.zeros_like(e)
    for dy in range(3):
        for dx in range(3):
            acc = acc + ep[:, dy : dy + h, dx : dx + w, :] * wdf[dy, dx]
    d = r(_act(acc + r(bd), relu6))
    p = torch.matmul(d, r(w2)) + r(b2)
    if skip:
        p = p + xb
    return p.to(x.dtype)


_P, _I32 = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built `tcf_mbconv` entry point of csrc/mbconv.cu, typed."""
    from tpucenterface_torch.kernels import build

    fn = build.load("mbconv").tcf_mbconv
    fn.argtypes = [_P] * 8 + [_I32] * 9 + [_P]
    fn.restype = _I32
    return fn


def _bf16_on(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t.to(device=dev, dtype=torch.bfloat16).contiguous()


def fused_mbconv(
    x: torch.Tensor,
    w1: Optional[torch.Tensor],
    b1: Optional[torch.Tensor],
    wd: torch.Tensor,
    bd: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    *,
    skip: bool,
    relu6: bool = True,
) -> torch.Tensor:
    """Fused inverted-residual block, stride 1 -> (B, H, W, Cout) in `x.dtype`.

    CUDA tensors launch `csrc/mbconv.cu` (x must be contiguous bfloat16 NHWC,
    channel counts multiples of 8, Cin <= MAX_CIN); CPU tensors take the plain
    version. `fused_mbconv.launches` counts kernel launches.
    """
    cin, ce, cout = _check_shapes(x, w1, b1, wd, bd, w2, b2, skip)
    if x.device.type == "cpu":
        return fused_mbconv_plain(x, w1, b1, wd, bd, w2, b2, skip=skip, relu6=relu6)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mbconv runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bfloat16 input, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous NHWC, 16-byte aligned")
    if x.numel() == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if cin % 8 or ce % 8 or cout % 8 or cin > MAX_CIN:
        raise ValueError(
            f"the kernel takes channel counts that are multiples of 8 and Cin <= {MAX_CIN}, "
            f"got Cin {cin}, Ce {ce}, Cout {cout}"
        )
    dev = x.device
    b, h, w, _ = x.shape
    wdb, bdb, w2b, b2b = (_bf16_on(t, dev) for t in (wd, bd, w2, b2))
    w1b, b1b = (_bf16_on(w1, dev), _bf16_on(b1, dev)) if w1 is not None else (None, None)
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        rc = fn(
            x.data_ptr(),
            w1b.data_ptr() if w1b is not None else None,
            b1b.data_ptr() if b1b is not None else None,
            wdb.data_ptr(), bdb.data_ptr(), w2b.data_ptr(), b2b.data_ptr(),
            out.data_ptr(),
            b, h, w, cin, ce, cout,
            int(w1 is not None), int(skip), int(relu6),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"mbconv kernel launch failed with CUDA error {rc}")
    fused_mbconv.launches += 1
    return out


fused_mbconv.launches = 0
