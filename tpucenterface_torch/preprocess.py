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

Any other `resize_impl` takes the JAX package's `scale_and_translate`
letterbox (`_scale_translate_weights`): per image and axis, the weight
matrix `jax.image.scale_and_translate` builds with `method` and no
antialias, applied as two float32 products; its output stays float32, as
there. The padded sides take part: the zero pad beyond the content enters
the border taps, as in JAX.
"""

from __future__ import annotations

import functools
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


@functools.lru_cache(maxsize=64)
def _device_constant(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """float32 `values` on `device`, copied there once: a host-to-device copy
    from pageable memory waits for the device's stream, so a program that
    made its constants on every call would wait for the work queued ahead
    of it. Callers only read the tensor."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _raw_offset(cfg: PreprocessConfig, device) -> torch.Tensor:
    off = np.asarray(raw_pixel_offset(cfg), np.float32)
    return _device_constant(tuple(off.tolist()), torch.device(device))


def _mean_std(cfg: PreprocessConfig, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """255 * mean and 255 * std, float32 on `device`."""
    dev = torch.device(device)
    return (_device_constant(tuple(cfg.mean), dev) * 255.0, _device_constant(tuple(cfg.std), dev) * 255.0)


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
    # uint8 values are exact in every resize_dtype: only other input takes
    # the cast to it that JAX's letterbox makes
    x = imgs_u8.float() if imgs_u8.dtype == torch.uint8 else imgs_u8.to(dtype).float()
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
        mean, std = _mean_std(cfg, y.device)
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
    mean, std = _mean_std(cfg, x.device)
    return ((x - mean) / std).to(dtype)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return (1.0 - x.abs()).clamp_min(0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel, a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos(radius: float, x: torch.Tensor) -> torch.Tensor:
    # each sine of its float32 argument rounded once from float64
    px = np.pi * x
    y = radius * torch.sin(px.double()).float() * torch.sin((px / radius).double()).float()
    den = torch.where(x != 0, np.pi ** 2 * x ** 2, torch.ones_like(x))
    out = torch.where(x > 1e-3, y / den, torch.ones_like(x))
    return torch.where(x > radius, torch.zeros_like(x), out)


def _resize_kernel(method: str):
    """The kernel `jax.image.scale_and_translate` takes for `method`."""
    if method == "nearest":
        raise ValueError("Nearest neighbor resampling is not currently supported for scale_and_translate.")
    if method in ("linear", "bilinear", "trilinear", "triangle"):
        return _triangle
    if method in ("cubic", "bicubic", "tricubic"):
        return _keys_cubic
    if method == "lanczos3":
        return functools.partial(_lanczos, 3.0)
    if method == "lanczos5":
        return functools.partial(_lanczos, 5.0)
    raise ValueError(f'Unknown resize method "{method}"')


def _scale_translate_weights(
    in_size: int, out_size: int, scale: torch.Tensor, translation: torch.Tensor, method: str
) -> torch.Tensor:
    """(B, in_size, out_size) float32 weights of one axis for per-image
    `scale` and `translation` (B,): `jax._src.image.scale.compute_weight_mat`
    with antialias off (kernel scale 1). Output pixel o samples input
    coordinate (o + 0.5) / s - t / s - 0.5; each column is normalized by its
    sum where that sum exceeds 1000 float32 eps (0 elsewhere) and zeroed
    where the sample lies outside [-0.5, in_size - 0.5]."""
    kernel = _resize_kernel(method)
    dev = scale.device
    inv = torch.full_like(scale, 1.0) / scale
    o = torch.arange(out_size, dtype=torch.float32, device=dev)
    i = torch.arange(in_size, dtype=torch.float32, device=dev)
    sample = (o[None, :] + 0.5) * inv[:, None] - (translation * inv)[:, None] - 0.5  # (B, out)
    w = kernel((sample[:, None, :] - i[None, :, None]).abs())  # (B, in, out)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None, :], w, torch.zeros_like(w))


def letterbox_normalize_scale_translate(
    imgs_u8: torch.Tensor,
    hws: torch.Tensor,
    size: int,
    cfg: PreprocessConfig,
    raw: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The `scale_and_translate` letterbox of `tpucenterface/preprocess.py::
    letterbox_normalize` (vmapped over the batch there): imgs (B, Hp, Wp, 3),
    hws (B, 2) -> (x (B, S, S, 3) float32, scales (B,), pads (B, 2)). Input
    pixel i maps to output i * s + pad; samples outside the padded image
    are 0. Then the BGR flip and (x / 255 - mean) / std, or the raw offset."""
    _, hp, wp, _ = imgs_u8.shape
    s, pad_x, pad_y = _letterbox_params(hws, size, cfg)
    wy = _scale_translate_weights(hp, size, s, pad_y, cfg.method)
    wx = _scale_translate_weights(wp, size, s, pad_x, cfg.method)
    x = imgs_u8.float()
    if cfg.bgr_input and not raw:
        x = x.flip(-1)
    x = torch.einsum("bwt,bhwc->bhtc", wx, x)
    x = torch.einsum("bhs,bhtc->bstc", wy, x)
    if raw:
        x = x - _raw_offset(cfg, x.device)
    else:
        mean = _device_constant(tuple(cfg.mean), x.device)
        std = _device_constant(tuple(cfg.std), x.device)
        x = (x / 255.0 - mean) / std
    return x.contiguous(), s, torch.stack([pad_x, pad_y], dim=-1)


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
    """Batched letterbox of same-padded-shape images (B, Hp, Wp, 3): the
    matmul letterbox, or `scale_and_translate`'s where `resize_impl` names
    another."""
    if cfg.resize_impl == "matmul":
        return letterbox_normalize_matmul(imgs_u8, hws, size, cfg, raw=raw)
    return letterbox_normalize_scale_translate(imgs_u8, hws, size, cfg, raw=raw)
