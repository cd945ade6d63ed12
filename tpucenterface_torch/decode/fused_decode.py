"""Fused decode: the CUDA kernel `csrc/decode.cu` and its plain version.

Mirrors `tpucenterface/decode/pallas_decode.py::decode_feats_pallas`, the TPU
kernel it replaces: sigmoid -> 3x3 peak mask -> exact top-K with the lowest
flat index first among ties -> wh/off gather -> corner boxes, for each image.

`decode_feats_fused` launches the kernel for CUDA tensors and takes
`decode_feats_fused_plain` only for tensors on the CPU. The plain version is
sigmoid, `pseudo_nms`, then a stable descending sort of the flattened peaks,
first K: peaks are >= 0 and emitted cells become -1, so K rounds of
lowest-index argmax pick exactly the cells a stable sort puts first.

K is min(max_dets, H*W) on both routes (the JAX kernel does not clamp it;
its reference decode does).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from tpucenterface_torch.config import DecodeConfig
from tpucenterface_torch.decode.reference import (
    boxes_from_cells,
    gather_cells,
    pseudo_nms,
    topk_lowest_index,
)

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _planes(feats: Dict[str, torch.Tensor]):
    """(hm (B,H,W,1), wh (B,H,W,2), off (B,H,W,2)); views of `whoff` when
    the model has fused heads."""
    hm = feats["hm"]
    if "whoff" in feats:
        wh, off = feats["whoff"][..., 0:2], feats["whoff"][..., 2:4]
    else:
        wh, off = feats["wh"], feats["off"]
    if hm.dim() != 4 or hm.shape[-1] != 1:
        raise ValueError(f"hm must be (B, H, W, 1), got {tuple(hm.shape)}")
    for name, t in (("hm", hm), ("wh", wh), ("off", off)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != hm.device:
            raise ValueError(f"{name} is on {t.device}, hm on {hm.device}")
    if wh.shape != hm.shape[:3] + (2,) or off.shape != wh.shape:
        raise ValueError(
            f"wh/off must be (B, H, W, 2) beside hm {tuple(hm.shape)}, "
            f"got {tuple(wh.shape)} and {tuple(off.shape)}"
        )
    return hm, wh, off


def decode_feats_fused_plain(feats: Dict[str, torch.Tensor], cfg: DecodeConfig) -> Result:
    """Plain torch version of the kernel -> (boxes (B,K,4), scores (B,K),
    flat indices (B,K) int32)."""
    hm, wh, off = _planes(feats)
    b, h, w, _ = hm.shape
    k = min(cfg.max_dets, h * w)
    peaks = pseudo_nms(torch.sigmoid(hm[..., 0]))
    scores, idx = topk_lowest_index(peaks.reshape(b, h * w), k)
    boxes = boxes_from_cells(idx, gather_cells(wh, idx), gather_cells(off, idx), w, cfg)
    return boxes, scores, idx.int()


_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built `tcf_decode` entry point of csrc/decode.cu, typed."""
    from tpucenterface_torch.kernels import build

    fn = build.load("decode").tcf_decode
    fn.argtypes = (
        [_P, _I64, _I64, _I64]
        + [_P, _I64, _I64, _I64, _I64] * 2
        + [_P] * 4
        + [_I32] * 4
        + [ctypes.c_float, _I32, _P]
    )
    fn.restype = _I32
    return fn


def decode_feats_fused(feats: Dict[str, torch.Tensor], cfg: DecodeConfig) -> Result:
    """Fused decode -> (boxes (B,K,4), scores (B,K), flat indices (B,K) int32).

    CUDA tensors launch `csrc/decode.cu`; CPU tensors take the plain
    version. `decode_feats_fused.launches` counts kernel launches.
    """
    hm, wh, off = _planes(feats)
    if hm.device.type == "cpu":
        return decode_feats_fused_plain(feats, cfg)
    if hm.device.type != "cuda":
        raise ValueError(f"decode_feats_fused runs on cuda or cpu, not {hm.device}")
    b, h, w, _ = hm.shape
    k = min(cfg.max_dets, h * w)
    if b == 0 or k < 1:
        raise ValueError(f"nothing to decode: batch {b}, K {k}")
    if any(s < 0 for t in (hm, wh, off) for s in t.stride()):
        raise ValueError("negative strides are not supported")
    dev = hm.device
    peaks = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    boxes = torch.empty((b, k, 4), dtype=torch.float32, device=dev)
    scores = torch.empty((b, k), dtype=torch.float32, device=dev)
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        rc = fn(
            hm.data_ptr(), *hm.stride()[:3],
            wh.data_ptr(), *wh.stride(),
            off.data_ptr(), *off.stride(),
            peaks.data_ptr(), boxes.data_ptr(), scores.data_ptr(), idx.data_ptr(),
            b, h, w, k, float(cfg.stride), int(cfg.wh_log),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"decode kernel launch failed with CUDA error {rc}")
    decode_feats_fused.launches += 1
    return boxes, scores, idx


decode_feats_fused.launches = 0
