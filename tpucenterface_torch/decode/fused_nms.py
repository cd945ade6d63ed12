"""Fused sigmoid + 3x3 pseudo-NMS: the CUDA kernel `csrc/nms.cu` and its plain
version.

Mirrors `tpucenterface/decode/pallas_nms.py::sigmoid_pseudo_nms_pallas`, the
TPU kernel it replaces: heatmap logits (B, H, W) float32 -> the sigmoid score
where the cell is its own 3x3 maximum (borders are -inf, a plateau keeps
every tied cell), else 0.

`sigmoid_pseudo_nms_fused` launches the kernel for CUDA tensors and takes
`sigmoid_pseudo_nms_plain` only for tensors on the CPU. On the GPU the two are
bit-equal: the kernel's sigmoid is the arithmetic of `torch.sigmoid` there.
The kernel works tile by tile (NMS_TILE cells of one image a thread block,
each with a one-cell halo); `sigmoid_pseudo_nms_tiled` is that tiling in
torch, held to the whole-map plain version on the CPU.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from tpucenterface_torch.decode.reference import pseudo_nms
from tpucenterface_torch.runtime.profiling import counts_work

# (rows, columns) of the tile a thread block of csrc/nms.cu takes (kTileH, kTileW)
NMS_TILE = (32, 32)


def sigmoid_pseudo_nms_plain(hm_logits: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel."""
    return pseudo_nms(torch.sigmoid(hm_logits))


def nms_grid(h: int, w: int, tile=NMS_TILE):
    """(tiles down, tiles across) of a (h, w) map: the kernel's grid.y and grid.x."""
    return -(-h // tile[0]), -(-w // tile[1])


def sigmoid_pseudo_nms_tiled(hm_logits: torch.Tensor, tile=NMS_TILE) -> torch.Tensor:
    """The kernel's tiling in torch: for each tile of `tile` cells of the
    grid of `nms_grid`, the sigmoid of the tile and its one-cell halo (-inf
    outside the map), the 3x3 maximum of each of the tile's cells over it,
    and the cell kept where the maximum equals its own score. Equals
    `sigmoid_pseudo_nms_plain` wherever the halo index math is right."""
    b, h, w = hm_logits.shape
    th, tw = tile
    ty, tx = nms_grid(h, w, tile)
    # the map padded by one cell of -inf and to whole tiles, as the halo reads see it
    s = F.pad(torch.sigmoid(hm_logits), (1, tx * tw - w + 1, 1, ty * th - h + 1), value=float("-inf"))
    out = torch.zeros((b, ty * th, tx * tw), dtype=hm_logits.dtype, device=hm_logits.device)
    for y in range(ty):
        for x in range(tx):
            halo = s[:, y * th : y * th + th + 2, x * tw : x * tw + tw + 2]
            c = halo[:, 1:-1, 1:-1]
            m = c
            for dy in range(3):
                for dx in range(3):
                    m = torch.maximum(m, halo[:, dy : dy + th, dx : dx + tw])
            out[:, y * th : (y + 1) * th, x * tw : (x + 1) * tw] = torch.where(m == c, c, torch.zeros_like(c))
    return out[:, :h, :w].contiguous()


_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built `tcf_sigmoid_nms` entry point of csrc/nms.cu, typed."""
    from tpucenterface_torch.kernels import build

    fn = build.load("nms").tcf_sigmoid_nms
    fn.argtypes = [_P, _I64, _I64, _I64, _P, _I32, _I32, _I32, _P]
    fn.restype = _I32
    return fn


def nms_work(hm_logits: torch.Tensor):
    """(operations, bytes) of one call, as the kernel table's bound counts
    them: logits read once, scores written once; per cell nine sigmoids (4
    each), eight maxima and the select."""
    cells = hm_logits.numel()
    return cells * 45, 2 * cells * 4


@counts_work("sigmoid_nms", nms_work)
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
    # the launch goes to the current device: enter `dev` only where it is another
    with contextlib.nullcontext() if dev.index == torch.cuda.current_device() else torch.cuda.device(dev):
        rc = _kernel()(
            hm_logits.data_ptr(), *hm_logits.stride(), out.data_ptr(), b, h, w,
            # the current stream's handle, without building a Stream object
            torch._C._cuda_getCurrentRawStream(dev.index),
        )
    if rc != 0:
        raise RuntimeError(f"nms kernel launch failed with CUDA error {rc}")
    sigmoid_pseudo_nms_fused.launches += 1
    return out


sigmoid_pseudo_nms_fused.launches = 0
