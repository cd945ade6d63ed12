"""Fused sigmoid + 3x3 pseudo-NMS: the CUDA kernel `csrc/nms.cu` and its plain
version.

Mirrors `tpucenterface/decode/pallas_nms.py::sigmoid_pseudo_nms_pallas`, the
TPU kernel it replaces: heatmap logits (B, H, W) float32 -> the sigmoid score
where the cell is its own 3x3 maximum (borders are -inf, a plateau keeps
every tied cell), else 0.

`sigmoid_pseudo_nms_fused` launches the kernel for CUDA tensors and takes
`sigmoid_pseudo_nms_plain` only for tensors on the CPU. On the GPU the two are
bit-equal: the kernel's sigmoid is the arithmetic of `torch.sigmoid` there.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpucenterface_torch.decode.reference import pseudo_nms


def sigmoid_pseudo_nms_plain(hm_logits: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel."""
    return pseudo_nms(torch.sigmoid(hm_logits))


_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built `tcf_sigmoid_nms` entry point of csrc/nms.cu, typed."""
    from tpucenterface_torch.kernels import build

    fn = build.load("nms").tcf_sigmoid_nms
    fn.argtypes = [_P, _I64, _I64, _I64, _P, _I32, _I32, _I32, _P]
    fn.restype = _I32
    return fn


def sigmoid_pseudo_nms_fused(hm_logits: torch.Tensor) -> torch.Tensor:
    """(B, H, W) float32 logits, any strides -> (B, H, W) peak-masked scores.

    CUDA tensors launch `csrc/nms.cu`; CPU tensors take the plain version.
    `sigmoid_pseudo_nms_fused.launches` counts kernel launches.
    """
    if hm_logits.dim() != 3:
        raise ValueError(f"hm_logits must be (B, H, W), got {tuple(hm_logits.shape)}")
    if hm_logits.dtype != torch.float32:
        raise TypeError(f"hm_logits must be float32, got {hm_logits.dtype}")
    if hm_logits.device.type == "cpu":
        return sigmoid_pseudo_nms_plain(hm_logits)
    if hm_logits.device.type != "cuda":
        raise ValueError(f"sigmoid_pseudo_nms_fused runs on cuda or cpu, not {hm_logits.device}")
    if hm_logits.numel() == 0:
        raise ValueError(f"empty map {tuple(hm_logits.shape)}")
    if any(s < 0 for s in hm_logits.stride()):
        raise ValueError("negative strides are not supported")
    dev = hm_logits.device
    b, h, w = hm_logits.shape
    out = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        rc = fn(
            hm_logits.data_ptr(), *hm_logits.stride(), out.data_ptr(), b, h, w,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"nms kernel launch failed with CUDA error {rc}")
    sigmoid_pseudo_nms_fused.launches += 1
    return out


sigmoid_pseudo_nms_fused.launches = 0
