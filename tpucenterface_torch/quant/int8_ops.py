"""The quantized engine's int8 convolutions: int8 in, exact int32 out, NHWC.

The JAX engine computes every int8 conv as an XLA convolution with
`preferred_element_type=int32` (`tpucenterface/quant/engine.py:368-376`); no
Pallas kernel is involved, so library calls are the port's counterpart here.
One function per conv kind, the same on the card and on the CPU:

- `conv1x1_int8`: a matrix product over channels, `torch._int_mm`;
- `conv3x3_int8`: dense 3x3 (the stem, the neck's `smooth*`, `head.conv`):
  the nine taps of a zero-padded input gathered into one (positions, 9*Cin)
  int8 matrix (im2col), then `torch._int_mm`;
- `dwconv3x3_int8`: depthwise 3x3, nine shifted multiply-adds in int32.

Every route is exact by construction: int8 products summed in int32. Traps
this avoids:
- `F.conv2d` on int8 tensors returns int8 and wraps on overflow;
- `F.conv2d` on float32 copies is exact only if cuDNN picks a direct-sum
  algorithm (no Winograd, no FFT), which torch cannot force;
- `torch._int_mm` on the card wants more than 16 rows and inner and output
  sizes that are multiples of 8, and the cuBLASLt int8 product under it
  refuses many shapes with a row-major second operand (measured on the H100
  with torch 2.11: 7400x16 @ 16x96 and 400x24 @ 24x32 fail) and takes all of
  them column-major. `_mm` passes the second operand column-major and pads
  rows to 17 and K and N to multiples of 8 with zeros, on both devices, so
  the devices run one code path. The model needs the padding only on the
  weight side (the stem's K = 27 is padded in its im2col matrix; the fused
  `head.out` has 5 or 15 outputs).

Padding is the symmetric (k-1)//2 of the JAX engine, for stride 2 as well:
Ho = (H - 1) // stride + 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K', N) int8 -> (M, N) int32, exact, through
    `torch._int_mm`, the second operand column-major, M padded to 17 and K
    and N to multiples of 8 with zeros as the card requires;
    K and K' may differ where the shorter operand's missing rows or columns
    are zeros."""
    m, k = a.shape
    kw, n = w.shape
    mp, kp, np_ = max(m, 17), _round_up(max(k, kw), 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (kw, n):
        w = F.pad(w, (0, np_ - n, 0, kp - kw))
    # column-major second operand: no copy when w is already a transposed view
    out = torch._int_mm(a.contiguous(), w.t().contiguous().t())
    return out[:m, :n] if (mp, np_) != (m, n) else out


def _check_int8(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")


def conv1x1_int8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, Cin) int8, w (Cin, Cout) int8 -> (B, H, W, Cout) int32."""
    _check_int8(x, w)
    if w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"w must be ({x.shape[-1]}, Cout), got {tuple(w.shape)}")
    b, h, wd, cin = x.shape
    return _mm(x.reshape(-1, cin), w).reshape(b, h, wd, w.shape[1])


def _taps(xp: torch.Tensor, ho: int, wo: int, stride: int):
    """The nine (dy, dx) views of a zero-padded (B, H+2, W+2, C) input that
    a 3x3 conv at `stride` reads, in HWIO tap order."""
    for dy in range(3):
        for dx in range(3):
            yield xp[:, dy : dy + stride * (ho - 1) + 1 : stride, dx : dx + stride * (wo - 1) + 1 : stride, :]


def conv3x3_int8(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Dense 3x3 conv, padding 1: x (B, H, W, Cin) int8, w (3, 3, Cin, Cout)
    int8 (HWIO) -> (B, Ho, Wo, Cout) int32. The (positions, 9*Cin) im2col
    matrix is written once, zero in its padding columns."""
    _check_int8(x, w)
    b, h, wd, cin = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w must be (3, 3, {cin}, Cout), got {tuple(w.shape)}")
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    k = 9 * cin
    cols = torch.zeros((b, ho, wo, _round_up(k, 8)), dtype=torch.int8, device=x.device)
    for t, tap in enumerate(_taps(xp, ho, wo, stride)):
        cols[..., t * cin : (t + 1) * cin] = tap
    wk = w.reshape(k, w.shape[3])
    return _mm(cols.reshape(-1, cols.shape[-1]), wk).reshape(b, ho, wo, w.shape[3])


def dwconv3x3_int8(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Depthwise 3x3 conv, padding 1: x (B, H, W, C) int8, w (3, 3, C) int8
    -> (B, Ho, Wo, C) int32; nine shifted multiply-adds in int32."""
    _check_int8(x, w)
    b, h, wd, c = x.shape
    if tuple(w.shape) != (3, 3, c):
        raise ValueError(f"w must be (3, 3, {c}), got {tuple(w.shape)}")
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    wi = w.to(torch.int32).reshape(9, c)
    acc = torch.zeros((b, ho, wo, c), dtype=torch.int32, device=x.device)
    for t, tap in enumerate(_taps(xp, ho, wo, stride)):
        acc += tap.to(torch.int32) * wi[t]
    return acc
