"""Letterbox + mean-std normalization on the device.

Mirrors `tpucenterface/preprocess.py::pad_to_bucket`, `_letterbox_params`,
`_bilinear_rows`, `letterbox_normalize_matmul`, `normalize_images` and
`letterbox_normalize`. The only host work is zero-padding the uint8 frame to
a shape bucket; the bilinear letterbox is two batched matrix products with
per-image weight rows (plain products: the JAX package leaves them to XLA).

Cast points follow the JAX package: operands in `resize_dtype`, float32
accumulation, the intermediate rounded to `resize_dtype` once. A bfloat16
matmul in torch returns bfloat16, so each product is computed in float32 from
operands that hold `resize_dtype` values; the float32 product of two bfloat16
values is exact, so only the sums' order differs from XLA's. (Float32 matrix
products on the GPU run in full float32 unless TF32 is enabled for them.)

The `scale_and_translate` resize (`resize_impl != "matmul"`) is not ported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tpucenterface_torch.config import INPUT_PAD_MULTIPLE, PreprocessConfig, dtype_of
from tpucenterface_torch.weights.fold import raw_pixel_offset


def pad_to_bucket(img: np.ndarray, multiple: int = INPUT_PAD_MULTIPLE) -> np.ndarray:
    """Host-side: zero-pad an HxWx3 uint8 image up to the next shape bucket."""
    h, w = img.shape[:2]
    hp = -(-h // multiple) * multiple
    wp = -(-w // multiple) * multiple
    if hp == h and wp == w:
        return np.ascontiguousarray(img)
    out = np.zeros((hp, wp) + img.shape[2:], dtype=img.dtype)
    out[:h, :w] = img
    return out


def _letterbox_params(hw: torch.Tensor, size: int, cfg: PreprocessConfig):
    h = hw[..., 0].float()
    w = hw[..., 1].float()
    # tensor / tensor: `size / h` would be `size * reciprocal(h)` in torch,
    # one ulp away from the IEEE quotient the JAX package computes
    full = torch.full_like(h, float(size))
    s = torch.minimum(full / h, full / w)
    if cfg.center:
        pad_x = (size - w * s) * 0.5
        pad_y = (size - h * s) * 0.5
    else:
        pad_x = torch.zeros_like(s)
        pad_y = torch.zeros_like(s)
    return s, pad_x, pad_y


def _bilinear_rows(n_in: int, size: int, pad, scale, dtype) -> torch.Tensor:
    """Per-image bilinear resampling matrix (B, size, n_in), zero outside:
    output pixel o samples input coordinate (o + 0.5 - pad)/scale - 0.5 with
    triangular weights (cv2.INTER_LINEAR semantics)."""
    dev = scale.device
    o = torch.arange(size, dtype=torch.float32, device=dev)[None, :, None]
    i = torch.arange(n_in, dtype=torch.float32, device=dev)[None, None, :]
    u = (o + 0.5 - pad[:, None, None]) / scale[:, None, None] - 0.5
    return (1.0 - (u - i).abs()).clamp_min(0.0).to(dtype)


def _raw_offset(cfg: PreprocessConfig, device) -> torch.Tensor:
    off = np.ascontiguousarray(raw_pixel_offset(cfg), np.float32)
    return torch.from_numpy(off).to(device)


def letterbox_normalize_matmul(
    imgs_u8: torch.Tensor,
    hws: torch.Tensor,
    size: int,
    cfg: PreprocessConfig,
    raw: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """imgs_u8 (B, Hp, Wp, 3) uint8, hws (B, 2) -> (x (B,S,S,3) in
    resize_dtype, scales (B,), pads (B, 2) [pad_x, pad_y]).

    raw=True (stem-baked models): no BGR flip, no std division; emit
    `resampled - 255*mean` in the input channel order.
    """
    b, hp, wp, _ = imgs_u8.shape
    dtype = dtype_of(cfg.resize_dtype)
    s, pad_x, pad_y = _letterbox_params(hws, size, cfg)
    wy = _bilinear_rows(hp, size, pad_y, s, dtype).float()
    wx = _bilinear_rows(wp, size, pad_x, s, dtype).float()
    x = imgs_u8.float()  # uint8 values are exact in every resize_dtype
    if cfg.bgr_input and not raw:
        x = x.flip(-1)
    # rows: (B, S, Hp) @ (B, Hp, Wp*3) -> (B, S, Wp*3), rounded once
    y = torch.bmm(wy, x.reshape(b, hp, wp * 3)).to(dtype).float()
    # columns: (B, S*3, Wp) @ (B, Wp, S) -> (B, S, 3, S), viewed as (B, S, S, 3)
    y = y.reshape(b, size, wp, 3).transpose(2, 3).reshape(b, size * 3, wp)
    y = torch.bmm(y, wx.transpose(1, 2)).reshape(b, size, 3, size).transpose(2, 3)
    if raw:
        x = y - _raw_offset(cfg, y.device)
    else:
        mean = torch.tensor(cfg.mean, dtype=torch.float32, device=y.device) * 255.0
        std = torch.tensor(cfg.std, dtype=torch.float32, device=y.device) * 255.0
        x = (y - mean) / std
    x = x.to(dtype).contiguous()
    return x, s, torch.stack([pad_x, pad_y], dim=-1)


def normalize_images(
    imgs_u8: torch.Tensor, cfg: PreprocessConfig, raw: bool = False
) -> torch.Tensor:
    """Preprocess for inputs already at the model size (the letterbox is the
    identity there): BGR->RGB + mean/std, or `pixel - 255*mean` for raw."""
    dtype = dtype_of(cfg.resize_dtype)
    x = imgs_u8.float()
    if raw:
        return (x - _raw_offset(cfg, x.device)).to(dtype)
    if cfg.bgr_input:
        x = x.flip(-1)
    mean = torch.tensor(cfg.mean, dtype=torch.float32, device=x.device) * 255.0
    std = torch.tensor(cfg.std, dtype=torch.float32, device=x.device) * 255.0
    return ((x - mean) / std).to(dtype)


def letterbox_normalize(
    img_u8: torch.Tensor,
    hw: torch.Tensor,
    size: int,
    cfg: PreprocessConfig,
    raw: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One padded (Hp, Wp, 3) uint8 image -> (x (S,S,3), scale, pad_xy (2,))."""
    x, s, pads = letterbox_normalize_batch(img_u8[None], hw[None], size, cfg, raw=raw)
    return x[0], s[0], pads[0]


def letterbox_normalize_batch(
    imgs_u8: torch.Tensor,
    hws: torch.Tensor,
    size: int,
    cfg: PreprocessConfig,
    raw: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched letterbox of same-padded-shape images (B, Hp, Wp, 3)."""
    if cfg.resize_impl != "matmul":
        raise NotImplementedError(
            f"resize_impl={cfg.resize_impl!r}: the port has only the matmul letterbox"
        )
    return letterbox_normalize_matmul(imgs_u8, hws, size, cfg, raw=raw)
