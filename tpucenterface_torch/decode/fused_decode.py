"""Fused decode: the CUDA kernel `csrc/decode.cu` and its plain version.

Mirrors `tpucenterface/decode/pallas_decode.py::decode_feats_pallas`, the TPU
kernel it replaces: sigmoid -> 3x3 peak mask -> exact top-K with the lowest
flat index first among ties -> wh/off gather -> corner boxes, for each image.

`decode_feats_fused` launches the kernel for CUDA tensors and takes
`decode_feats_fused_plain` only for tensors on the CPU. The plain version is
sigmoid, `pseudo_nms`, then a stable descending sort of the flattened peaks,
first K.

The kernel selects in two stages, by 64-bit keys (`peak_keys`): a key is the
peak value's float bits above the complement of its flat index, so a larger
key is a higher score and, among equal scores, a lower index (the order of
`lax.top_k`). Peak values are >= +0, whose bits order as unsigned integers,
and keys are unique, so a selection by key is exact. Stage 1 keeps each band
of R rows' top K' = min(K, R*W) keys; stage 2 takes the top K of their union
(the global top K lies in it, as keys are unique) and gathers the boxes.
`plan_decode` sizes the two launches; `select_banded_plain` is the
selection's model in torch, which the CPU tests hold to `topk_lowest_index`.

K is min(max_dets, H*W) on both routes (the JAX kernel does not clamp it;
its reference decode does).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from tpucenterface_torch.config import DecodeConfig
from tpucenterface_torch.decode.reference import (
    boxes_from_cells,
    gather_cells,
    pseudo_nms,
    topk_lowest_index,
)

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# Shared memory a thread block can use on an H100 (227 KB).
MAX_SMEM = 232_448
# The kernel's scratch beside its arrays: a 256-bin histogram, two buffers
# of 32 per-warp counts and eight words, all 32-bit.
FIXED_SMEM = 4 * (256 + 64 + 8)
# Keys stage 2 takes for one image at most (8 bytes each in shared memory).
MAX_CANDIDATES = 24_000
# Band heights the planner weighs, each cut to the map, and stage 1's block sizes.
DECODE_ROWS = (1, 2, 4, 8, 12, 16, 20, 24, 32, 48, 64)
DECODE_THREADS = (256, 512)
# Stage 2's block size (csrc/decode.cu, kMergeThreads).
MERGE_THREADS = 512
NUM_SMS = 132
# Shared memory of one SM (228 KB); each resident block also takes 1 KB of it.
SM_SMEM = 233_472


def band_smem_bytes(rows: int, w: int) -> int:
    """Stage 1's dynamic shared memory (csrc/decode.cu, `band_kernel`): the
    keys of the band's positive peaks (8 bytes a cell), the sigmoids of its
    rows and the two halo rows, the peak map, the scratch."""
    return 8 * rows * w + 4 * (rows + 2) * w + 4 * rows * w + FIXED_SMEM


def merge_smem_bytes(candidates: int, k: int) -> int:
    """Stage 2's (`merge_kernel`): the candidate keys, the K survivors of the
    select, the K keys in rank order, the scratch."""
    return 8 * candidates + 16 * k + FIXED_SMEM


@dataclass(frozen=True)
class DecodePlan:
    """The two launches of B2 for K: stage 1 on a grid of (bands, B) blocks
    of `threads`, each band `rows` rows keeping its top `kb` keys; stage 2 on
    B blocks of MERGE_THREADS, selecting the top K of `bands * kb`
    candidates; each stage's dynamic shared memory."""

    k: int
    rows: int
    bands: int
    kb: int
    threads: int
    band_smem: int
    merge_smem: int

    @property
    def candidates(self) -> int:
        return self.bands * self.kb


def decode_plans(b: int, h: int, w: int, k: int):
    """Every plan of B2 for (b, h, w) heads and K that fits: each band height
    of DECODE_ROWS cut to the map, with each block size of DECODE_THREADS,
    where both stages' shared memory is within MAX_SMEM and the candidates
    within MAX_CANDIDATES. Raises ValueError on shapes the
    kernel does not take."""
    if min(b, h, w) < 1 or b > 65_535 or h * w >= 2**31 or not 1 <= k <= h * w:
        raise ValueError(f"B2 takes 1 <= B <= 65535, a map of fewer than 2^31 cells and 1 <= K <= H*W, "
                         f"got {(b, h, w)} and K {k}")
    for rows in dict.fromkeys(min(r, h) for r in DECODE_ROWS):
        bands, kb = -(-h // rows), min(k, rows * w)
        s1, s2 = band_smem_bytes(rows, w), merge_smem_bytes(bands * kb, k)
        if s1 > MAX_SMEM or s2 > MAX_SMEM or bands * kb > MAX_CANDIDATES:
            continue
        for threads in DECODE_THREADS:
            yield DecodePlan(k, rows, bands, kb, threads, s1, s2)


def _decode_cost(b: int, h: int, w: int, plan: DecodePlan) -> float:
    """Estimated device time of a plan, in microseconds. Stage 1: an SM runs
    its share of the (bands, B) blocks in rounds of as many as its threads
    and shared memory hold; a round costs 0.73 us and 0.82 us for each pass
    of a block over its band's cells with the halo rows, 21% more for each
    other block beside it. Stage 2 costs 0.66 us for each pass of its block
    over the candidates (load and select) and 24 us for every million
    comparisons of the rank (K^2); 11.7 us are the same for every plan.
    Fitted to `kernels/sweep_b2.py`'s device times at its four shapes
    (PERF.md §6), where it ranks the fastest plan first."""
    resident = max(1, min(2048 // plan.threads, SM_SMEM // (plan.band_smem + 1024), 32))
    per_sm = -(-(b * plan.bands) // NUM_SMS)
    passes = -(-(plan.rows + 2) * w // plan.threads)
    stage1 = -(-per_sm // resident) * (0.73 + 0.82 * passes) * (1 + 0.21 * (min(per_sm, resident) - 1))
    stage2 = 0.66 * -(-plan.candidates // MERGE_THREADS) + 24e-6 * plan.k * plan.k
    return 11.7 + stage1 + -(-b // NUM_SMS) * stage2


@functools.lru_cache(maxsize=256)
def plan_decode(b: int, h: int, w: int, k: int) -> DecodePlan:
    """B2's plan for (b, h, w) heads and K: of `decode_plans`, the one
    `_decode_cost` finds cheapest. Raises ValueError if none fits: a band of
    one row needs 16*W + 8*W + 1,312 bytes (W up to about 9,600), and the
    candidates, at least ceil(H/R) * min(K, R*W), must stay within
    MAX_CANDIDATES with 8 * candidates + 16 * K + 1,312 bytes within MAX_SMEM."""
    plans = list(decode_plans(b, h, w, k))
    if not plans:
        raise ValueError(f"no B2 plan fits heads {(b, h, w)} at K {k}")
    return min(plans, key=lambda plan: _decode_cost(b, h, w, plan))


def peak_keys(values: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """The kernel's keys, int64: the float bits of `values` (each >= +0)
    above 0xFFFFFFFF - `flat_idx`. A larger key is a higher value, then a
    lower index; every key of a cell is above 0, the key of an empty slot."""
    bits = values.float().contiguous().view(torch.int32).to(torch.int64)
    return (bits << 32) | (0xFFFFFFFF - flat_idx.to(torch.int64))


def select_banded_plain(peaks: torch.Tensor, plan: DecodePlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's two-stage selection in torch: (B, H, W) peak map ->
    (scores (B, K), flat indices (B, K) int64). Each band of `plan.rows` rows
    keeps its stable top min(kb, cells) as keys, padded to kb with key 0;
    the top K of their union by key, in key order."""
    b, h, w = peaks.shape
    flat = peaks.reshape(b, h * w)
    cands = []
    for band in range(plan.bands):
        lo, hi = band * plan.rows * w, min(h, (band + 1) * plan.rows) * w
        vals, idx = topk_lowest_index(flat[:, lo:hi], min(plan.kb, hi - lo))
        keys = peak_keys(vals, idx + lo)
        cands.append(F.pad(keys, (0, plan.kb - keys.shape[1])))
    top = torch.topk(torch.cat(cands, dim=1), plan.k, dim=1).values
    scores = (top >> 32).to(torch.int32).view(torch.float32)
    return scores, 0xFFFFFFFF - (top & 0xFFFFFFFF)


def _planes(feats: Dict[str, torch.Tensor]):
    """(hm (B,H,W,1), wh (B,H,W,2), off (B,H,W,2)): wh and off as given (the
    fused heads give them as views of one map), or as views of `whoff` where
    only that is given."""
    hm, wh, off = feats["hm"], feats.get("wh"), feats.get("off")
    if wh is None or off is None:
        wh, off = feats["whoff"][..., 0:2], feats["whoff"][..., 2:4]
    if hm.dim() != 4 or hm.shape[-1] != 1:
        raise ValueError(f"hm must be (B, H, W, 1), got {tuple(hm.shape)}")
    for name, t in (("hm", hm), ("wh", wh), ("off", off)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.get_device() != hm.get_device():
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
        + [ctypes.c_float, _I32]
        + [_I32] * 6
        + [_P]
    )
    fn.restype = _I32
    return fn


def _launch(hm, wh, off, cfg: DecodeConfig, plan: DecodePlan) -> Result:
    if hm.device.type != "cuda":
        raise ValueError(f"the decode kernel runs on cuda, not {hm.device}")
    if any(s < 0 for t in (hm, wh, off) for s in t.stride()):
        raise ValueError("negative strides are not supported")
    b, h, w, _ = hm.shape
    dev, k = hm.device, plan.k
    cand = torch.empty((b, plan.bands, plan.kb), dtype=torch.int64, device=dev)
    boxes = torch.empty((b, k, 4), dtype=torch.float32, device=dev)
    scores = torch.empty((b, k), dtype=torch.float32, device=dev)
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    # the launch goes to the current device: enter `dev` only where it is another
    with contextlib.nullcontext() if dev.index == torch.cuda.current_device() else torch.cuda.device(dev):
        rc = _kernel()(
            hm.data_ptr(), *hm.stride()[:3],
            wh.data_ptr(), *wh.stride(),
            off.data_ptr(), *off.stride(),
            cand.data_ptr(), boxes.data_ptr(), scores.data_ptr(), idx.data_ptr(),
            b, h, w, k, float(cfg.stride), int(cfg.wh_log),
            plan.rows, plan.bands, plan.kb, plan.threads, plan.band_smem, plan.merge_smem,
            # the current stream's handle: what torch.cuda.current_stream(dev).cuda_stream
            # gives, without building a Stream object (8 us of host time a call)
            torch._C._cuda_getCurrentRawStream(dev.index),
        )
    if rc != 0:
        raise RuntimeError(f"decode kernel launch failed with CUDA error {rc}")
    return boxes, scores, idx


def launch_decode(feats: Dict[str, torch.Tensor], cfg: DecodeConfig, plan: DecodePlan) -> Result:
    """Launch `csrc/decode.cu` on CUDA heads under `plan` (`kernels/sweep_b2.py`
    times every plan of `decode_plans` through it); raises if the kernel
    refuses the plan or fails to launch. Counts nothing."""
    hm, wh, off = _planes(feats)
    return _launch(hm, wh, off, cfg, plan)


def decode_feats_fused(feats: Dict[str, torch.Tensor], cfg: DecodeConfig) -> Result:
    """Fused decode -> (boxes (B,K,4), scores (B,K), flat indices (B,K) int32).

    CUDA tensors launch `csrc/decode.cu` (both stages, one entry point) under
    `plan_decode`'s plan; CPU tensors take the plain version.
    `decode_feats_fused.launches` counts calls that launch the kernel.
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
    out = _launch(hm, wh, off, cfg, plan_decode(b, h, w, k))
    decode_feats_fused.launches += 1
    return out


decode_feats_fused.launches = 0
