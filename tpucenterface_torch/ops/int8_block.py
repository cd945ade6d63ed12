"""The int8 MobileNetV2 block in one kernel: the CUDA kernels
`csrc/int8_block.cu` (stride 2, B6) and `csrc/int8_block_s1.cu` (stride 1,
B7), their plain versions, their launch plans, their packed operands, and the
JAX layout's helpers.

Replaces the TPU kernels of `tpucenterface/bench/probe_fused_block.py`:
- `make_fused_block_kernel` (B6): int8 in, stride-2 block, int8 out;
- `make_fused_block_s1_kernel` (B7): bf16 in, quantized inside the kernel at
  a scalar expand scale, stride-1 block, bf16 out with the residual added in
  float32.
Both compute, per position, with per-channel float32 vectors:

    e  = clip(round(clip(acc_e * e_scale + e_bias, 0, 6) * e_inv_sdw), +-127)
         acc_e = x_q @ we^T                           1x1 expand, int32 sums
    d  = clip(round(clip(acc_d * d_scale + d_bias, 0, 6) * d_inv_sproj), +-127)
         acc_d = sum of the nine taps e * wd          3x3 depthwise, exact
    yp = acc_p * p_scale + p_bias, acc_p = d @ wp^T   1x1 project, int32 sums
    B6: out = clip(round(yp), +-127) int8
    B7: x_q = clip(round(x * inv_se), +-127); out = bf16(yp [+ x])

with one float32 rounding after each product and each sum (no fused
multiply-add), rounding half to even, and zeros at the map's padding
positions of e. The depthwise taps hold integers (wd (9, Cmid), tap-major,
as float32 in the JAX layout); |9 * 127 * 127| < 2^24, so the JAX package's
float32 multiply-adds and the port's int32 ones give the same sums.

Layouts. The TPU kernels take planar (B, C, P) tensors, B6's input as
space-to-depth parity planes (`nhwc_to_parity_planar`) and both with halo'd
band copies (`pad_bands`): devices of Mosaic's weak strided lane access and
Pallas's disjoint blocks. The CUDA kernels read the engine's NHWC tensors
and their halo'd tiles directly. The plain versions take NHWC
(`fused_block_int8_plain`, `fused_block_s1_plain`) and the JAX layout
(`*_planar`), so the CPU tests hold them to the JAX functions; weights and
vectors take the JAX layout in both ((C,) or (C, 1) vectors).

Both kernels take their operands packed once (`pack_int8_block_s1`:
chunk-major, padded, 16-byte aligned, the depthwise taps of a row in one
word; the layout does not depend on the stride) and a launch plan fitted to
the map (`plan_int8_block_s1`, `plan_int8_block_s2`: the output tile, the
chunk width, the warps and the project's split over them);
`unpack_int8_block_s1` gives the JAX-layout operands back. B7 runs on the
quantized engine's path (`QuantEngine(fused_blocks=True)`); B6 is on no path:
its int8 output cannot feed the residual block after each stride-2 block,
which needs the bf16 value as its skip input.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple, Union

import torch
import torch.nn.functional as F

from tpucenterface_torch.quant.int8_ops import conv1x1_int8, dwconv3x3_int8
from tpucenterface_torch.runtime.profiling import counts_work

# ------------------------------------------------------------------------- #
# layout helpers of the JAX package (`probe_fused_block.py:55-74`)
# ------------------------------------------------------------------------- #


def nhwc_to_parity_planar(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 4*C, (H/2)*(W/2)): plane p = 2*pr + pc holds
    x[2r+pr, 2c+pc], rows ordered parity-major, channel-minor."""
    b, h, w, c = x.shape
    hh, ww = h // 2, w // 2
    return x.reshape(b, hh, 2, ww, 2, c).permute(0, 2, 4, 5, 1, 3).reshape(b, 4 * c, hh * ww)


def parity_planar_to_nhwc(x: torch.Tensor, hh: int, ww: int) -> torch.Tensor:
    """Inverse of `nhwc_to_parity_planar`."""
    b, c4, _ = x.shape
    c = c4 // 4
    return x.reshape(b, 2, 2, c, hh, ww).permute(0, 4, 1, 5, 2, 3).reshape(b, 2 * hh, 2 * ww, c)


def planar_to_nhwc(y: torch.Tensor, hh: int, ww: int) -> torch.Tensor:
    """(B, C, hh*ww) -> (B, hh, ww, C)."""
    b, c, _ = y.shape
    return y.reshape(b, c, hh, ww).permute(0, 2, 3, 1)


def nhwc_to_planar(y: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, H*W), contiguous."""
    b, h, w, c = y.shape
    return y.permute(0, 3, 1, 2).reshape(b, c, h * w).contiguous()


# ------------------------------------------------------------------------- #
# plain versions
# ------------------------------------------------------------------------- #

_VEC_KEYS = ("e_scale", "e_bias", "e_inv_sdw", "d_scale", "d_bias", "d_inv_sproj", "p_scale", "p_bias")


def _operands(we, e_scale, e_bias, e_inv_sdw, wd, d_scale, d_bias, d_inv_sproj, wp, p_scale, p_bias):
    """Check the eleven weight operands; -> (we, wd (9, Cmid), wp, {name:
    (C,) float32 vector})."""
    if we.dtype != torch.int8 or wp.dtype != torch.int8 or we.dim() != 2 or wp.dim() != 2:
        raise TypeError(f"we and wp must be 2-D int8, got {we.dtype} {tuple(we.shape)}, {wp.dtype} {tuple(wp.shape)}")
    cmid, cout = we.shape[0], wp.shape[0]
    if wp.shape[1] != cmid or wd.numel() != 9 * cmid:
        raise ValueError(f"wp must be (Cout, {cmid}) and wd (9, {cmid}), got {tuple(wp.shape)}, {tuple(wd.shape)}")
    vals = dict(zip(_VEC_KEYS, (e_scale, e_bias, e_inv_sdw, d_scale, d_bias, d_inv_sproj, p_scale, p_bias)))
    vecs = {}
    for k, v in vals.items():
        n = cout if k.startswith("p_") else cmid
        if v.numel() != n or v.dtype != torch.float32:
            raise ValueError(f"{k} must hold {n} float32 values, got {v.dtype} {tuple(v.shape)}")
        vecs[k] = v.reshape(n).contiguous()
    return we, wd.reshape(9, cmid), wp, vecs


def _requant(acc: torch.Tensor, scale, bias, inv) -> torch.Tensor:
    """int32 sums -> clip(round(clip(acc * scale + bias, 0, 6) * inv), +-127) int8."""
    y = (acc.float() * scale + bias).clamp_(0.0, 6.0)
    return torch.round(y * inv).clamp_(-127, 127).to(torch.int8)


def _block_body(xq, we, wd, wp, v, stride):
    """int8 NHWC input -> float32 project output yp (B, Ho, Wo, Cout)."""
    e = _requant(conv1x1_int8(xq, we.t()), v["e_scale"], v["e_bias"], v["e_inv_sdw"])
    wdi = wd.reshape(3, 3, -1).to(torch.int8)
    d = _requant(dwconv3x3_int8(e, wdi, stride), v["d_scale"], v["d_bias"], v["d_inv_sproj"])
    return conv1x1_int8(d, wp.t()).float() * v["p_scale"] + v["p_bias"]


def fused_block_int8_plain(x, we, e_scale, e_bias, e_inv_sdw, wd, d_scale, d_bias, d_inv_sproj, wp, p_scale, p_bias):
    """B6's plain version on NHWC: x (B, H, W, Cin) int8 -> (B, Ho, Wo, Cout)
    int8, Ho = (H - 1) // 2 + 1; mirrors `probe_fused_block.py::fused_block_ref`."""
    if x.dtype != torch.int8 or x.dim() != 4:
        raise TypeError(f"x must be (B, H, W, Cin) int8, got {x.dtype} {tuple(x.shape)}")
    we, wd, wp, v = _operands(we, e_scale, e_bias, e_inv_sdw, wd, d_scale, d_bias, d_inv_sproj, wp, p_scale, p_bias)
    yp = _block_body(x, we, wd, wp, v, stride=2)
    return torch.round(yp).clamp_(-127, 127).to(torch.int8)


def fused_block_int8_plain_planar(x_planar, *operands, hw_out: int):
    """B6's plain version on the JAX layout: (B, 4*Cin, hw_out^2) int8
    parity planes -> (B, Cout, hw_out^2) int8 (`fused_block_ref`'s
    signature)."""
    x = parity_planar_to_nhwc(x_planar, hw_out, hw_out)
    return nhwc_to_planar(fused_block_int8_plain(x, *operands))


def _as_scalar(v: Union[float, torch.Tensor], dev) -> torch.Tensor:
    """inv_se as a float32 0-d tensor on `dev` ((1, 1) in the JAX layout)."""
    t = torch.as_tensor(v, dtype=torch.float32)
    if t.numel() != 1:
        raise ValueError(f"inv_se must be one value, got shape {tuple(t.shape)}")
    return t.reshape(()).to(dev)


def fused_block_s1_plain(x, inv_se, we, e_scale, e_bias, e_inv_sdw, wd, d_scale, d_bias, d_inv_sproj, wp, p_scale,
                         p_bias, residual: bool = True):
    """B7's plain version on NHWC: x (B, H, W, Cin) bf16 -> (B, H, W, Cout)
    bf16; the residual adds x, zero-padded to Cout channels, in float32.
    Mirrors `probe_fused_block.py::fused_block_s1_ref`."""
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise TypeError(f"x must be (B, H, W, Cin) bf16, got {x.dtype} {tuple(x.shape)}")
    we, wd, wp, v = _operands(we, e_scale, e_bias, e_inv_sdw, wd, d_scale, d_bias, d_inv_sproj, wp, p_scale, p_bias)
    cin, cout = x.shape[-1], wp.shape[0]
    if residual and cout < cin:
        raise ValueError(f"the residual needs Cout >= Cin, got {cout} < {cin}")
    xf = x.float()
    xq = torch.round(xf * _as_scalar(inv_se, x.device)).clamp_(-127, 127).to(torch.int8)
    yp = _block_body(xq, we, wd, wp, v, stride=1)
    if residual:
        yp = yp + F.pad(xf, (0, cout - cin))
    return yp.to(torch.bfloat16)


def fused_block_s1_plain_planar(x_planar, inv_se, *operands, hw: int, residual: bool = True):
    """B7's plain version on the JAX layout: (B, Cin, hw^2) bf16 -> (B, Cout,
    hw^2) bf16 (`fused_block_s1_ref`'s signature)."""
    x = planar_to_nhwc(x_planar, hw, hw)
    return nhwc_to_planar(fused_block_s1_plain(x, inv_se, *operands, residual=residual))




# ------------------------------------------------------------------------- #
# the launch plans of B7 (csrc/int8_block_s1.cu) and B6 (csrc/int8_block.cu),
# and their packed operands
# ------------------------------------------------------------------------- #

MAX_SMEM = 232448   # bytes of shared memory a block may use on sm_90
NUM_SMS = 132       # H100 SXM
# (warps, PM, PN): the project rectangles a warp may own, PM M tiles of 16
# positions by PN N tiles of 8 output channels (csrc/int8_block_s1.cu,
# `dispatch`), and the blocks an SM holds of each at its launch bounds (8
# warps with 8 or 16 mma tiles a warp, 16 warps at 128 registers).
S1_BLOCKS_PER_SM = {(8, 2, 4): 3, (8, 2, 8): 2, (16, 1, 12): 1}
S1_VARIANTS = tuple(S1_BLOCKS_PER_SM)
# output tiles (rows, columns) the planner weighs, each cut to the map
S1_TILES = ((16, 16), (10, 20), (8, 40), (8, 32), (8, 20), (10, 10), (8, 16), (8, 8), (5, 10), (4, 8), (4, 4))


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def s1_chunk_width(cmid: int) -> int:
    """The chunk of expanded channels: the width that pads Cmid least, the
    wider one (64) on a tie."""
    return 64 if _round_up(cmid, 64) <= _round_up(cmid, 32) else 32


@dataclass(frozen=True)
class S1Layout:
    """Byte layout of one chunk of the packed operands of B7 and B6, which is
    also that of their shared-memory buffer: we [CK][XS] | wp [Cout][DSS] | taps [3][CK] u32 |
    vec [6][CK] f32."""

    cin: int
    cmid: int
    cout: int
    ck: int

    @property
    def cin_pad(self) -> int:
        return _round_up(self.cin, 32)

    @property
    def xs(self) -> int:   # row bytes of the expand weights and of the input tile
        return self.cin_pad + 16

    @property
    def dss(self) -> int:  # row bytes of the project weights and of d
        return self.ck + 16

    @property
    def nchunks(self) -> int:
        return -(-self.cmid // self.ck)

    @property
    def off_wp(self) -> int:
        return self.ck * self.xs

    @property
    def off_taps(self) -> int:
        return self.off_wp + self.cout * self.dss

    @property
    def off_vec(self) -> int:
        return self.off_taps + 12 * self.ck

    @property
    def chunk_bytes(self) -> int:
        return self.off_vec + 24 * self.ck

    @property
    def nbytes(self) -> int:
        """All chunks, then p_scale and p_bias (float32), padded to 16."""
        return self.nchunks * self.chunk_bytes + _round_up(8 * self.cout, 16)


def s1_smem_bytes(tile_h: int, tile_w: int, lay: S1Layout) -> int:
    """Dynamic shared memory of a block (csrc/int8_block_s1.cu, `derive`):
    the halo'd input tile, the expanded chunk channel-major, d
    position-major, two chunk buffers."""
    ih, iw = tile_h + 2, tile_w + 2
    rw = 4 * (-(-tile_w // 4)) + 4
    cs = ih * rw
    if (cs // 4) % 2 == 0:
        cs += 4
    mt = -(-(tile_h * tile_w) // 16)
    return ih * iw * lay.xs + _round_up(lay.ck * cs, 16) + mt * 16 * lay.dss + 2 * lay.chunk_bytes


@dataclass(frozen=True)
class Int8BlockPlan:
    """One launch of B7 or B6: the output tile (rows, columns), the chunk width,
    the warps of a block, each warp's project rectangle (PM M tiles by PN N
    tiles), the dynamic shared memory and the grid (one block a tile of one
    image)."""

    tile_h: int
    tile_w: int
    ck: int
    warps: int
    pm: int
    pn: int
    smem_bytes: int
    grid: Tuple[int, int, int]

    def describe(self) -> str:
        return (f"{self.tile_h}x{self.tile_w} tile, CK {self.ck}, {self.warps} warps, {self.pm}x{self.pn} "
                f"rectangles, {self.smem_bytes} B shared memory, grid {self.grid[0]}")


def s1_plans(b: int, h: int, w: int, cin: int, cmid: int, cout: int):
    """Every launch plan of B7 for x (b, h, w, cin) and (cmid, cout) that
    fits: each tile of S1_TILES (cut to the map) with each variant of
    S1_VARIANTS whose project rectangles cover the tile's outputs, within
    MAX_SMEM. Raises ValueError on shapes the kernel does not take."""
    if min(b, h, w, cmid) < 1 or cin < 8 or cin % 8 or cout < 8 or cout % 8:
        raise ValueError(f"B7 takes Cin and Cout multiples of 8 and a non-empty map, got "
                         f"{(b, h, w, cin, cmid, cout)}")
    lay = S1Layout(cin, cmid, cout, s1_chunk_width(cmid))
    for th, tw in dict.fromkeys((min(th, h), min(tw, w)) for th, tw in S1_TILES):
        smem = s1_smem_bytes(th, tw, lay)
        if smem > MAX_SMEM:
            continue
        mt, nt = -(-(th * tw) // 16), cout // 8
        for warps, pm, pn in S1_VARIANTS:
            if -(-mt // pm) * -(-nt // pn) <= warps:
                yield Int8BlockPlan(th, tw, lay.ck, warps, pm, pn, smem, (b * -(-h // th) * -(-w // tw), 1, 1))


def _s1_cost(b, h, w, lay, plan):
    """Estimated time of a plan, in warp instructions of the busiest SM. A
    chunk of a block costs its expand of the halo (mma and requantization),
    its depthwise (units of four outputs by four channels), its project mma
    and a fixed 2,000 for its barriers and the latency they expose. An SM
    runs its share of the blocks, at full rate once 16 warps are resident.
    Fitted to `kernels/sweep_b7.py` on the default model's blocks (PERF.md §6)."""
    th, tw = plan.tile_h, plan.tile_w
    npos = _round_up((th + 2) * (tw + 2), 16)
    mpad = _round_up(th * tw, 16)
    per_chunk = (npos // 16) * (lay.ck // 8) * (lay.cin_pad // 32) * 3 + npos * lay.ck * 14 // 32 \
        + (lay.ck // 4) * th * -(-tw // 4) * 330 // 32 + (mpad // 16) * (lay.cout // 8) * (lay.ck // 32) * 3 + 2000
    per_sm = -(-plan.grid[0] // NUM_SMS)
    resident = min(per_sm, S1_BLOCKS_PER_SM[plan.warps, plan.pm, plan.pn]) * plan.warps
    return lay.nchunks * per_chunk * per_sm * 16 / min(resident, 16)


@functools.lru_cache(maxsize=256)
def plan_int8_block_s1(b: int, h: int, w: int, cin: int, cmid: int, cout: int) -> Int8BlockPlan:
    """B7's launch plan for x (b, h, w, cin) and (cmid, cout): of `s1_plans`,
    the one `_s1_cost` finds cheapest (few halo positions and little ragged
    waste for the outputs, enough blocks to keep the SMs busy). Raises
    ValueError if none fits."""
    lay = S1Layout(cin, cmid, cout, s1_chunk_width(cmid))
    plans = list(s1_plans(b, h, w, cin, cmid, cout))
    if not plans:
        raise ValueError(f"no B7 plan fits {(b, h, w, cin, cmid, cout)}")
    return min(plans, key=lambda plan: _s1_cost(b, h, w, lay, plan))


SM_SMEM = 233472     # bytes of shared memory an SM holds on sm_90 (1,024 of them reserved a block)
# B6's (warps, PM, PN) variants (csrc/int8_block.cu, `dispatch`) and the blocks
# an SM holds of each at its launch bounds: B7's, and 8 warps of 2 x 3 mma
# tiles each, which hold fewer registers than 2 x 4 where Cout is 24
S2_BLOCKS_PER_SM = {(8, 2, 3): 3, **S1_BLOCKS_PER_SM}
S2_VARIANTS = tuple(S2_BLOCKS_PER_SM)
S2_MAX_CIN = 248     # the expand's int32 sums stay under 2^22, which B6 turns into floats exactly
# B6's output tiles (rows, columns), each cut to the output map
S2_TILES = ((16, 16), (8, 32), (16, 8), (10, 20), (8, 16), (10, 10), (8, 8), (5, 10), (4, 16), (4, 8), (4, 4))


def s2_smem_bytes(tile_h: int, tile_w: int, lay: S1Layout) -> int:
    """Dynamic shared memory of a B6 block (csrc/int8_block.cu, `derive`):
    the halo'd input tile ((2 tile_h + 1) rows of 2 tile_w + 2 positions, the
    last a pad; each Cin rounded to an odd number of 16 bytes; the staged
    output tile after the last chunk), the expanded chunk channel-major (its
    halo rows and slack for up to 15 positions past them, an odd number of
    words a channel), d position-major, p_scale and p_bias, two chunk
    buffers."""
    ih, iwp = 2 * tile_h + 1, 2 * tile_w + 2
    rw = 8 * -(-tile_w // 4) + 4
    cs = _round_up(ih * rw + 15 // iwp * rw + 15 % iwp + 1, 4)
    if (cs // 4) % 2 == 0:
        cs += 4
    kpad = _round_up(lay.cin, 16)
    xsx = kpad if (kpad // 16) % 2 else kpad + 16
    tile = _round_up(max(ih * iwp * xsx, tile_h * _round_up(tile_w * lay.cout, 16)), 16)
    mt = -(-(tile_h * tile_w) // 16)
    return tile + _round_up(lay.ck * cs, 16) + mt * 16 * lay.dss + 8 * lay.cout + 2 * lay.chunk_bytes


def s2_blocks_per_sm(plan: Int8BlockPlan) -> int:
    """B6 blocks an SM holds: its launch bounds' count, or fewer where the
    shared memory binds."""
    return min(S2_BLOCKS_PER_SM[plan.warps, plan.pm, plan.pn], SM_SMEM // (plan.smem_bytes + 1024))


def s2_plans(b: int, h: int, w: int, cin: int, cmid: int, cout: int):
    """Every launch plan of B6 for x (b, h, w, cin) and (cmid, cout) that
    fits: each tile of S2_TILES (cut to the output map) with each variant of
    S2_VARIANTS whose project rectangles cover the tile's outputs, within
    MAX_SMEM. Raises ValueError on shapes the kernel does not take."""
    if min(b, h, w, cmid) < 1 or cin < 8 or cin % 8 or cin > S2_MAX_CIN or cout < 8 or cout % 8:
        raise ValueError(f"B6 takes Cin and Cout multiples of 8, Cin at most {S2_MAX_CIN}, and a non-empty map, "
                         f"got {(b, h, w, cin, cmid, cout)}")
    lay = S1Layout(cin, cmid, cout, s1_chunk_width(cmid))
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    for th, tw in dict.fromkeys((min(th, ho), min(tw, wo)) for th, tw in S2_TILES):
        smem = s2_smem_bytes(th, tw, lay)
        if smem > MAX_SMEM:
            continue
        mt, nt = -(-(th * tw) // 16), cout // 8
        for warps, pm, pn in S2_VARIANTS:
            if -(-mt // pm) * -(-nt // pn) <= warps:
                yield Int8BlockPlan(th, tw, lay.ck, warps, pm, pn, smem, (b * -(-ho // th) * -(-wo // tw), 1, 1))


S2_HIDING_WARPS = 20   # resident warps an SM needs to run B6 at full rate (fitted)


def _s2_cost(lay, plan):
    """Estimated device milliseconds of a B6 plan. A chunk of a block costs
    its expand's mma over the halo (16 positions x 16 channels x 32 bytes of
    K a unit), the expand's requantizations (32 values a unit), the
    depthwise's units of four outputs by four channels (32 a unit) and a
    fixed share for its barriers; a block adds a share for each of its tile's
    rows (the halo rows it copies in, the output rows it stores) and a fixed
    one. An SM runs its share of the blocks, at full rate once
    S2_HIDING_WARPS warps are resident. The constants are fitted to
    `kernels/sweep_b6.py` on the default model's four stride-2 blocks at
    batch 32 (PERF.md §6)."""
    th, tw = plan.tile_h, plan.tile_w
    npos = _round_up((2 * th + 1) * (2 * tw + 2), 16)
    ksteps = _round_up(lay.cin, 16) / 32
    per_chunk = (9.1e-6 * (npos / 16) * (lay.ck / 16) * ksteps + 1.6e-6 * npos * lay.ck / 32
                 + 7.7e-5 * (lay.ck / 4) * th * -(-tw // 4) / 32 + 4.4e-4)
    per_block = lay.nchunks * per_chunk + 1.9e-5 * (3 * th + 1) + 1.0e-3
    per_sm = -(-plan.grid[0] // NUM_SMS)
    resident = min(per_sm, s2_blocks_per_sm(plan)) * plan.warps
    return per_block * per_sm * S2_HIDING_WARPS / min(resident, S2_HIDING_WARPS)


@functools.lru_cache(maxsize=256)
def plan_int8_block_s2(b: int, h: int, w: int, cin: int, cmid: int, cout: int) -> Int8BlockPlan:
    """B6's launch plan for x (b, h, w, cin) and (cmid, cout): of `s2_plans`,
    the one `_s2_cost` finds cheapest. Raises ValueError if none fits."""
    lay = S1Layout(cin, cmid, cout, s1_chunk_width(cmid))
    plans = list(s2_plans(b, h, w, cin, cmid, cout))
    if not plans:
        raise ValueError(f"no B6 plan fits {(b, h, w, cin, cmid, cout)}")
    return min(plans, key=lambda plan: _s2_cost(lay, plan))


@dataclass(frozen=True)
class PackedInt8BlockS1:
    """The operands of B7 or B6 in the kernels' layout (`pack_int8_block_s1`):
    `data` holds S1Layout(cin, cmid, cout, ck).nbytes bytes (uint8, one tensor)."""

    data: torch.Tensor
    cin: int
    cmid: int
    cout: int
    ck: int

    @property
    def layout(self) -> S1Layout:
        return S1Layout(self.cin, self.cmid, self.cout, self.ck)

    @property
    def device(self) -> torch.device:
        return self.data.device


def _f32_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def pack_int8_block_s1(we, e_scale, e_bias, e_inv_sdw, wd, d_scale, d_bias, d_inv_sproj, wp, p_scale,
                       p_bias) -> PackedInt8BlockS1:
    """Lay the eleven JAX-layout operands of B7 or B6 out once, on their
    device, in the kernels' layout (S1Layout): chunk by chunk of CK expanded channels,
    each chunk the contiguous bytes of its shared-memory buffer: the expand
    weights (CK rows of Cin, zero to XS bytes), the project weights (Cout
    rows of CK, zero to DSS bytes), the depthwise taps of each row dy as one
    word (w[dy, 0], w[dy, 1], w[dy, 2], 0) a channel, and the six vectors;
    channels past Cmid are zero. Then p_scale and p_bias."""
    we, wd, wp, v = _operands(we, e_scale, e_bias, e_inv_sdw, wd, d_scale, d_bias, d_inv_sproj, wp, p_scale, p_bias)
    cmid, cin = we.shape
    cout = wp.shape[0]
    if cin % 8 or cout % 8:
        raise ValueError(f"the int8 block kernels take Cin and Cout multiples of 8, got {cin}, {cout}")
    lay = S1Layout(cin, cmid, cout, s1_chunk_width(cmid))
    n, ck, dev = lay.nchunks, lay.ck, we.device
    cpad = n * ck
    wer = torch.zeros((cpad, lay.xs), dtype=torch.int8, device=dev)
    wer[:cmid, :cin] = we
    wpr = torch.zeros((cout, cpad + 16), dtype=torch.int8, device=dev)
    wpr[:, :cmid] = wp
    wpr = torch.stack([wpr[:, k * ck : k * ck + lay.dss] for k in range(n)])   # (n, Cout, DSS)
    wpr[:, :, ck:] = 0
    taps = torch.zeros((3, cpad, 4), dtype=torch.int8, device=dev)
    taps[:, :cmid, :3] = wd.reshape(3, 3, cmid).permute(0, 2, 1).to(torch.int8)
    vec = torch.zeros((6, cpad), dtype=torch.float32, device=dev)
    for r, k in enumerate(_VEC_KEYS[:6]):
        vec[r, :cmid] = v[k]
    chunks = torch.cat([
        wer.view(torch.uint8).reshape(n, ck * lay.xs),
        wpr.view(torch.uint8).reshape(n, cout * lay.dss),
        taps.view(torch.uint8).reshape(3, n, ck * 4).permute(1, 0, 2).reshape(n, 12 * ck),
        _f32_bytes(vec.reshape(6, n, ck).permute(1, 0, 2)).reshape(n, 24 * ck),
    ], dim=1)
    tail = torch.zeros(lay.nbytes - n * lay.chunk_bytes, dtype=torch.uint8, device=dev)
    tail[: 8 * cout] = _f32_bytes(torch.cat([v["p_scale"], v["p_bias"]]))
    data = torch.cat([chunks.reshape(-1), tail])
    return PackedInt8BlockS1(data, cin, cmid, cout, ck)


def unpack_int8_block_s1(packed: PackedInt8BlockS1) -> dict:
    """The JAX-layout operands back from `pack_int8_block_s1`: we (Cmid,
    Cin), wd (9, Cmid) float32, wp (Cout, Cmid), the vectors 1-D float32."""
    lay, d = packed.layout, packed.data
    n, ck, cin, cmid, cout = lay.nchunks, lay.ck, lay.cin, lay.cmid, lay.cout
    chunks = d[: n * lay.chunk_bytes].reshape(n, lay.chunk_bytes)
    we = chunks[:, : lay.off_wp].reshape(n * ck, lay.xs)[:cmid, :cin].view(torch.int8)
    wp = chunks[:, lay.off_wp : lay.off_taps].reshape(n, cout, lay.dss)[:, :, :ck]
    wp = wp.permute(1, 0, 2).reshape(cout, n * ck)[:, :cmid].view(torch.int8)
    taps = chunks[:, lay.off_taps : lay.off_vec].reshape(n, 3, ck, 4).permute(1, 3, 0, 2).reshape(3, 4, n * ck)
    wd = taps[:, :3, :cmid].view(torch.int8).reshape(9, cmid).float()
    vec = chunks[:, lay.off_vec :].contiguous().view(torch.float32).reshape(n, 6, ck).permute(1, 0, 2)
    vec = vec.reshape(6, n * ck)[:, :cmid]
    pv = d[n * lay.chunk_bytes : n * lay.chunk_bytes + 8 * cout].view(torch.float32)
    out = {"we": we.contiguous(), "wd": wd, "wp": wp.contiguous()}
    out.update({k: vec[r].contiguous() for r, k in enumerate(_VEC_KEYS[:6])})
    out.update(p_scale=pv[:cout].clone(), p_bias=pv[cout:].clone())
    return out


# ------------------------------------------------------------------------- #
# the kernels
# ------------------------------------------------------------------------- #

_P, _I32, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _kernel_s2():
    """The built `tcf_int8_block` entry point of csrc/int8_block.cu, typed."""
    from tpucenterface_torch.kernels import build

    fn = build.load("int8_block").tcf_int8_block
    fn.argtypes = [_P, _P, _P] + [_I32] * 6 + [_I32] * 7 + [_I64, _P]
    fn.restype = _I32
    return fn


@functools.lru_cache(maxsize=None)
def _kernel_s1():
    """The built `tcf_int8_block_s1` entry point of csrc/int8_block_s1.cu, typed."""
    from tpucenterface_torch.kernels import build

    fn = build.load("int8_block_s1").tcf_int8_block_s1
    fn.argtypes = [_P, _P, _F32, _P] + [_I32] * 7 + [_I32] * 7 + [_I64, _P]
    fn.restype = _I32
    return fn


def _device_check(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")


def _check_x(x: torch.Tensor) -> None:
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous NHWC, 16-byte aligned")
    if x.numel() == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")


def _block_work(x: torch.Tensor, packed: PackedInt8BlockS1, stride: int) -> Tuple[int, int]:
    """(operations, bytes) of one block launch, as the kernel table's bound
    counts them: x and out once (int8 at stride 2, bf16 at stride 1), the
    weights once; the expand at the input's positions, the depthwise's nine
    multiply-adds an output and the project, all on int8 operands."""
    b, h, w, cin = x.shape
    cmid, cout = packed.cmid, packed.cout
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    nbytes = (x.element_size() * (b * h * w * cin + b * ho * wo * cout) + cmid * cin + cout * cmid + 9 * cmid * 4
              + 4 * (6 * cmid + 2 * cout))
    return 2 * (b * h * w * cin * cmid + b * ho * wo * cmid * cout) + 2 * 9 * b * ho * wo * cmid, nbytes


def block_s2_work(x: torch.Tensor, packed: PackedInt8BlockS1):
    return _block_work(x, packed, 2)


def block_s1_work(x: torch.Tensor, inv_se, packed: PackedInt8BlockS1, residual: bool = True):
    return _block_work(x, packed, 1)


@counts_work("int8_block_s2", block_s2_work)
def int8_block_s2(x: torch.Tensor, packed: PackedInt8BlockS1) -> torch.Tensor:
    """B6: the stride-2 block, NHWC int8 (B, H, W, Cin) -> NHWC int8 (B, Ho,
    Wo, Cout), Ho = (H - 1) // 2 + 1 (see the module docstring), on operands
    packed by `pack_int8_block_s1`. CUDA tensors launch `csrc/int8_block.cu`
    with `plan_int8_block_s2`'s plan; CPU tensors take the plain version on
    the unpacked operands. Both raise on what the kernel does not take
    (dtype, shape, a non-contiguous or misaligned x). `int8_block_s2.launches`
    counts kernel launches."""
    if not isinstance(packed, PackedInt8BlockS1):
        raise TypeError(f"packed must come from pack_int8_block_s1, got {type(packed).__name__}")
    if x.device.type != "cpu":
        _device_check(x, "int8_block_s2")
    if x.dtype != torch.int8 or x.dim() != 4:
        raise TypeError(f"x must be (B, H, W, Cin) int8, got {x.dtype} {tuple(x.shape)}")
    _check_x(x)
    b, h, w, cin = x.shape
    if cin != packed.cin:
        raise ValueError(f"x has {cin} channels, the packed operands {packed.cin}")
    if x.device.type == "cpu":
        return fused_block_int8_plain(x, **unpack_int8_block_s1(packed))
    if packed.device != x.device or packed.data.data_ptr() % 16:
        raise ValueError("the packed operands must be on x's device, 16-byte aligned")
    out = torch.empty((b, (h - 1) // 2 + 1, (w - 1) // 2 + 1, packed.cout), dtype=torch.int8, device=x.device)
    launch_int8_block_s2(x, packed, plan_int8_block_s2(b, h, w, cin, packed.cmid, packed.cout), out)
    int8_block_s2.launches += 1
    return out


def launch_int8_block_s2(x, packed: PackedInt8BlockS1, plan: Int8BlockPlan, out) -> None:
    """Launch `csrc/int8_block.cu` with `plan` into `out`, on operands that
    `int8_block_s2` has checked (`kernels/sweep_b6.py` times every plan of
    `s2_plans` through it); raises if the kernel refuses the plan or fails to
    launch. Counts nothing."""
    with torch.cuda.device(x.device):
        rc = _kernel_s2()(
            x.data_ptr(), packed.data.data_ptr(), out.data_ptr(), *x.shape, packed.cmid, packed.cout,
            plan.tile_h, plan.tile_w, plan.ck, plan.warps, plan.pm, plan.pn, plan.smem_bytes, plan.grid[0],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"B6 kernel launch failed with CUDA error {rc}")


@counts_work("int8_block_s1", block_s1_work)
def int8_block_s1(x: torch.Tensor, inv_se: Union[float, torch.Tensor], packed: PackedInt8BlockS1,
                  residual: bool = True) -> torch.Tensor:
    """B7: the stride-1 block, NHWC bf16 -> NHWC bf16 (see the module
    docstring), on operands packed by `pack_int8_block_s1`; `inv_se` a float
    or a one-element tensor. CUDA tensors launch `csrc/int8_block_s1.cu` with
    `plan_int8_block_s1`'s plan; CPU tensors take the plain version on the
    unpacked operands. Both raise on what the kernel does not take (dtype,
    shape, a non-contiguous or misaligned x). `int8_block_s1.launches`
    counts kernel launches."""
    if not isinstance(packed, PackedInt8BlockS1):
        raise TypeError(f"packed must come from pack_int8_block_s1, got {type(packed).__name__}")
    if x.device.type != "cpu":
        _device_check(x, "int8_block_s1")
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise TypeError(f"x must be (B, H, W, Cin) bf16, got {x.dtype} {tuple(x.shape)}")
    _check_x(x)
    b, h, w, cin = x.shape
    if cin != packed.cin:
        raise ValueError(f"x has {cin} channels, the packed operands {packed.cin}")
    if residual and packed.cout < cin:
        raise ValueError(f"the residual needs Cout >= Cin, got {packed.cout} < {cin}")
    if x.device.type == "cpu":
        return fused_block_s1_plain(x, inv_se, **unpack_int8_block_s1(packed), residual=residual)
    if packed.device != x.device or packed.data.data_ptr() % 16:
        raise ValueError("the packed operands must be on x's device, 16-byte aligned")
    out = torch.empty((b, h, w, packed.cout), dtype=torch.bfloat16, device=x.device)
    launch_int8_block_s1(x, inv_se, packed, plan_int8_block_s1(b, h, w, cin, packed.cmid, packed.cout), residual, out)
    int8_block_s1.launches += 1
    return out


def launch_int8_block_s1(x, inv_se, packed: PackedInt8BlockS1, plan: Int8BlockPlan, residual: bool, out) -> None:
    """Launch `csrc/int8_block_s1.cu` with `plan` into `out`, on operands that
    `int8_block_s1` has checked (`kernels/sweep_b7.py` times every plan of
    `s1_plans` through it); raises if the kernel refuses the plan or fails
    to launch. Counts nothing."""
    with torch.cuda.device(x.device):
        rc = _kernel_s1()(
            x.data_ptr(), packed.data.data_ptr(), float(inv_se), out.data_ptr(),
            *x.shape, packed.cmid, packed.cout, int(residual),
            plan.tile_h, plan.tile_w, plan.ck, plan.warps, plan.pm, plan.pn, plan.smem_bytes, plan.grid[0],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"B7 kernel launch failed with CUDA error {rc}")


int8_block_s1.launches = 0
int8_block_s2.launches = 0
