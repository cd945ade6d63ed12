"""What every architecture's reference shares: variables on the device, the
float8 rounding of the control, float32 without TF32, and MobileNet's
channel rounding. The architectures themselves are `reference/<arch>.py`,
which `registry.reference` finds by the configuration's `architecture`.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Tuple

import torch


def fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 under one scale for the whole tensor (its
    largest magnitude to e4m3's 448), back in float32."""
    s = t.abs().amax().clamp_min(1e-12) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


@contextlib.contextmanager
def float32_exact() -> Iterator[None]:
    """Float32 convolutions and matrix products without TF32 inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def make_divisible(c: int, width_mult: float) -> int:
    """MobileNet's channel rounding: the scaled width to a multiple of 8, at
    least 8 and never below 0.9 of the scaled value."""
    if width_mult == 1.0:
        return c
    scaled = c * width_mult
    v = max(8, int(scaled + 4) // 8 * 8)
    if v < 0.9 * scaled:
        v += 8
    return v


def get(tree: dict, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def to_device(variables: dict, device) -> dict:
    """The variables as float32 tensors on `device` (copies)."""
    if isinstance(variables, dict):
        return {k: to_device(v, device) for k, v in variables.items()}
    return torch.as_tensor(variables).to(device=device, dtype=torch.float32)
