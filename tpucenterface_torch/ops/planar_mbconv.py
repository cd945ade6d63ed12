"""Inverted-residual blocks on the row-padded planar layout: the CUDA kernels
of `csrc/planar_chain.cu` (one block, B4a, and a chain, B4b), their plain
versions, their launch plans and packed weights, and the layout helpers.

Mirrors `tpucenterface/ops/planar_mbconv.py` (`padded_width`,
`planar_from_nhwc`, `nhwc_from_planar`, `mbconv_reference_planar`,
`planar_mbconv`, `planar_mbconv_chain`), the two TPU kernels it replaces.

Layout: activations are (B, C, H*Wp), channel planes of H rows of
Wp = `padded_width(H, W)` pixels each. Columns W..Wp-1 of every row are pad
columns: on input they may hold anything finite and are read as zeros, on
output they are unspecified by the contract (these kernels and their plain
versions write zeros there). Wp comes from the TPU kernel's lane tiling; here
it is only the layout that the wrappers share with the JAX functions.

Weights: w1 (Cin, Ce) or None when the block has no expand (then Ce == Cin),
wd (3, 3, Ce), w2 (Ce, Cout), biases 1-D; the HWIO forms of the JAX functions
((1, 1, Cin, Ce), (3, 3, 1, Ce), (1, 1, Ce, Cout)) are taken as well.

Per block, both kernels and both plain versions compute
    e = bf16(act(w1 x + b1)), 0 at the pad columns      (bf16 operands, f32 sums)
    e = bf16(x), 0 at the pad columns                   (without an expand)
    d = bf16(act(sum_{dy,dx} f32(e[y+dy, x+dx]) * wd[dy, dx] + bd))
        nine taps in the order dy, dx from a zero float32 accumulator,
        wd and bd in float32, each product rounded before it is added;
        rows above 0 and below H-1 are zeros
    p = w2 d + b2 [+ x]                                 (bf16 operands, f32 sums)
with b1, wd, bd, b2 kept in float32 (the NHWC kernel `ops.fused_mbconv` rounds
them to bfloat16; this one does not). `planar_mbconv` returns p cast to
`x.dtype` (the kernel rounds the float32 sum once to bfloat16 in its
epilogue, `epilogue_bf16`); `planar_mbconv_chain` rounds p to bfloat16 after
every block, adds the skip from the rounded value of the block's input, and
makes ONE kernel launch for the whole chain.

Both kernels take their weights packed once (`pack_planar_chain`: block by
block, chunk by chunk of 32 expanded channels, each chunk one 16-byte aligned
slab in the layout of its shared-memory buffer; one block for B4a) and a
launch plan fitted to the map: `plan_planar_chain` (per block the tile, the
chunk width and each warp's rectangle of project tiles; per launch the kernel
variant, the shared memory and the cooperative grid) and
`plan_planar_mbconv` (the variant, among them the streamed one-block kernel,
the tile, the rectangles, the shared memory and the persistent grid).

A CUDA tensor launches the kernel (bfloat16 input only) or raises; a CPU
tensor takes the plain version. There is no `interpret` argument as in the
JAX functions: a CUDA kernel has no interpret mode, the plain version is what
runs without a card.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Any, List, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from tpucenterface_torch.ops.fused_mbconv import _act, mbconv_reference
from tpucenterface_torch.runtime.profiling import counts_work

LANE = 128
# Limits of csrc/planar_chain.cu: an input tile with its
# halo sits in shared memory at the block's full input width next to the chunk
# buffers, which 227 KB holds up to 256 channels; the chain's block table is a
# kernel argument.
MAX_CIN = 256
MAX_CHAIN = 16


def padded_width(h: int, w: int) -> int:
    """Smallest Wp >= w + 2 with h * Wp a multiple of 128."""
    wp = w + 2
    while (h * wp) % LANE:
        wp += 1
    return wp


def planar_from_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> row-padded planar (B, C, H*Wp); pad columns zero."""
    b, h, w, c = x.shape
    wp = padded_width(h, w)
    return F.pad(x.permute(0, 3, 1, 2), (0, wp - w)).reshape(b, c, h * wp)


def nhwc_from_planar(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Row-padded planar (B, C, H*Wp) -> (B, H, W, C); drops the pad columns."""
    b, c, _ = x.shape
    return x.reshape(b, c, h, padded_width(h, w))[..., :w].permute(0, 2, 3, 1)


class _Shapes(NamedTuple):
    cin: int
    ce: int
    cout: int


def _block_shapes(cin: int, w1, b1, wd, bd, w2, b2, skip: bool) -> _Shapes:
    """Check one block's weights against its input width; -> (Cin, Ce, Cout)."""
    if wd.shape[:2] != (3, 3) or wd.numel() != 9 * wd.shape[-1]:
        raise ValueError(f"wd must be (3, 3, Ce) or (3, 3, 1, Ce), got {tuple(wd.shape)}")
    ce, cout = wd.shape[-1], w2.shape[-1]
    if (w1 is None) != (b1 is None):
        raise ValueError("w1 and b1 are given together or not at all")
    if w1 is None:
        if ce != cin:
            raise ValueError(f"without an expand Ce must equal Cin, got {ce} and {cin}")
    elif w1.numel() != cin * ce or w1.shape[-1] != ce or b1.numel() != ce:
        raise ValueError(f"w1 must be ({cin}, {ce}) and b1 ({ce},), got {tuple(w1.shape)}, {tuple(b1.shape)}")
    if w2.numel() != ce * cout or bd.numel() != ce or b2.numel() != cout:
        raise ValueError(
            f"w2 must be ({ce}, Cout), bd ({ce},) and b2 (Cout,), got {tuple(w2.shape)}, "
            f"{tuple(bd.shape)}, {tuple(b2.shape)}"
        )
    if skip and cin != cout:
        raise ValueError(f"the skip needs Cin == Cout, got {cin} and {cout}")
    return _Shapes(cin, ce, cout)


def _check_planar(x: torch.Tensor, H: int, W: int) -> int:
    if x.dim() != 3:
        raise ValueError(f"x must be planar (B, C, H*Wp), got {tuple(x.shape)}")
    wp = padded_width(H, W)
    if x.shape[2] != H * wp:
        raise ValueError(f"x has {x.shape[2]} columns, H={H}, W={W} need H*Wp = {H * wp}")
    return wp


def mbconv_reference_planar(x, w1, b1, wd, bd, w2, b2, *, H: int, W: int, skip: bool, relu6: bool = True):
    """The block in float32 through `ops.fused_mbconv.mbconv_reference` on the
    NHWC view; returns row-padded planar with zero pad columns."""
    xn = nhwc_from_planar(x, H, W)
    c, e = xn.shape[-1], wd.shape[-1]
    y = mbconv_reference(
        xn,
        None if w1 is None else w1.reshape(c, e),
        None if w1 is None else b1.reshape(e),
        wd.reshape(3, 3, e),
        bd.reshape(e),
        w2.reshape(e, w2.shape[-1]),
        b2.reshape(-1),
        skip=skip,
        relu6=relu6,
    )
    return planar_from_nhwc(y)


def _r(t: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16, continue in float32."""
    return t.to(torch.bfloat16).float()


def _block_plain(v: torch.Tensor, w1, b1, wd, bd, w2, b2, skip: bool, relu6: bool) -> torch.Tensor:
    """One block on the real columns: v (B, Cin, H, W) in bfloat16 or float32
    -> p (B, Cout, H, W) float32, not rounded. Cast points as in
    `tpucenterface/ops/planar_mbconv.py:109-148` and `:273-300`. bfloat16
    values and their pairwise products are exact in float32, so float32
    matrix products stand for bfloat16 products with float32 sums. A float32
    `v` is not rounded before the expand and the skip (the JAX functions in
    interpret mode promote the bfloat16 weight instead), only where the block
    has no expand."""
    cin = v.shape[1]
    ce, cout = wd.shape[-1], w2.shape[-1]
    vf = v.float()
    if w1 is not None:
        e = torch.einsum("ce,bchw->behw", _r(w1.reshape(cin, ce)), vf)
        e = _r(_act(e + b1.float().reshape(1, ce, 1, 1), relu6))
    else:
        e = _r(vf)
    h, w = v.shape[2:]
    ep = F.pad(e, (1, 1, 1, 1))  # zeros after the expand: the border taps see 0, not act(b1)
    wdf = wd.float().reshape(3, 3, ce)
    acc = torch.zeros_like(e)
    for dy in range(3):
        for dx in range(3):
            acc = acc + ep[:, :, dy : dy + h, dx : dx + w] * wdf[dy, dx].reshape(1, ce, 1, 1)
    d = _r(_act(acc + bd.float().reshape(1, ce, 1, 1), relu6))
    p = torch.einsum("eo,behw->bohw", _r(w2.reshape(ce, cout)), d) + b2.float().reshape(1, cout, 1, 1)
    return p + vf if skip else p


def _real_columns(x: torch.Tensor, H: int, W: int, wp: int) -> torch.Tensor:
    return x.reshape(x.shape[0], x.shape[1], H, wp)[..., :W]


def _to_planar(p: torch.Tensor, wp: int) -> torch.Tensor:
    b, c, h, w = p.shape
    return F.pad(p, (0, wp - w)).reshape(b, c, h * wp)


def planar_mbconv_plain(x, w1, b1, wd, bd, w2, b2, *, H: int, W: int, skip: bool, relu6: bool = True):
    """Plain torch version of `planar_mbconv`: one block, the project summed
    in float32 and cast once to `x.dtype`; pad columns of the result zero."""
    wp = _check_planar(x, H, W)
    _block_shapes(x.shape[1], w1, b1, wd, bd, w2, b2, skip)
    if skip and w1 is None:
        raise ValueError("a skip without an expand is not supported")
    p = _block_plain(_real_columns(x, H, W, wp), w1, b1, wd, bd, w2, b2, skip, relu6)
    return _to_planar(p, wp).to(x.dtype)


def _block_tuple(blk: Mapping[str, Any]):
    return blk["w1"], blk["b1"], blk["wd"], blk["bd"], blk["w2"], blk["b2"], bool(blk["skip"])


def planar_mbconv_chain_plain(x, blocks: Sequence[Mapping[str, Any]], *, H: int, W: int, relu6: bool = True):
    """Plain torch version of `planar_mbconv_chain`: the blocks one after the
    other, each output rounded to bfloat16; returns bfloat16, pad columns
    zero."""
    wp = _check_planar(x, H, W)
    if not blocks:
        raise ValueError("a chain needs at least one block")
    v = _real_columns(x, H, W, wp)
    for blk in blocks:
        *weights, skip = _block_tuple(blk)
        _block_shapes(v.shape[1], *weights, skip)
        v = _block_plain(v, *weights, skip, relu6).to(torch.bfloat16)
    return _to_planar(v, wp)


# --------------------------------------------------------------------------- #
# the chain kernel's packed weights and launch plan (csrc/planar_chain.cu)
# --------------------------------------------------------------------------- #

CHAIN_CK = 32          # expanded channels a chunk
MAX_SMEM = 232448      # bytes of shared memory a block may use on sm_90
NUM_SMS = 132          # H100 SXM
# (warps, consumer warps, PMX, PNX): the kernel's instantiations
# (csrc/planar_chain.cu, `tcf_planar_chain`), one thread block of 16 warps an
# SM. With no consumer warps every warp takes every stage (tile load, expand,
# depthwise, project), in turn between barriers; else the producer warps take
# the first three and the consumer warps the project, a chunk behind, with
# setmaxnreg giving the consumers more registers. A warp of the project owns a
# rectangle of at most PMX M tiles (16 positions) by PNX N tiles (8 output
# channels), whose float32 sums stay in registers over all chunks, four a tile
# and thread: 32 of the 128 registers a thread has in the first, 80 of the 160
# a consumer thread takes in the second, which holds Cout 320 on a 10x10 tile.
CHAIN_VARIANTS = ((16, 0, 2, 4), (8, 8, 4, 5))
# the registers a thread of the project's warps has in each variant (the
# launch's 128, or the consumers' setmaxnreg)
CHAIN_REGISTERS = {(16, 0, 2, 4): 128, (8, 8, 4, 5): 160}
# output tiles (rows, columns) the planner weighs, each cut to the map
CHAIN_TILES = ((16, 16), (10, 20), (8, 32), (12, 12), (8, 20), (8, 16), (10, 14), (10, 10), (8, 10), (8, 8),
               (5, 10), (4, 16), (5, 5), (4, 8), (4, 4), (2, 8), (2, 2), (1, 8), (1, 1))


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


class ChainShape(NamedTuple):
    """One block of a chain: channel counts, and whether it expands (without
    an expand Ce equals Cin and the chunks are the input's own channels)."""

    cin: int
    ce: int
    cout: int
    expand: bool = True


@dataclass(frozen=True)
class ChainLayout:
    """Byte layout of one chain block's packed weights (`pack_planar_chain`):
    `nchunks` chunks of CHAIN_CK expanded channels, each the contiguous bytes
    of the kernel's shared-memory chunk buffer,
        w1 [CK][XW] bf16 (none without an expand) | w2 [N2][W2S] bf16 |
        taps [9][CK] f32 | b1 [CK] f32 | bd [CK] f32,
    rows padded by 16 bytes against bank conflicts, zeros past Ce, Cin and
    Cout; then b2 [Cout] f32, padded to 16 bytes."""

    shape: ChainShape

    @property
    def cin_pad(self) -> int:   # K of the expand
        return _round_up(self.shape.cin, 16)

    @property
    def xw(self) -> int:        # row of the w1 chunk, bf16
        return self.cin_pad + 8

    @property
    def w2s(self) -> int:       # row of the w2 chunk, bf16
        return CHAIN_CK + 8

    @property
    def n2(self) -> int:        # rows of the w2 chunk: output channels
        return _round_up(self.shape.cout, 16)

    @property
    def nchunks(self) -> int:
        return -(-self.shape.ce // CHAIN_CK)

    @property
    def off_w2(self) -> int:
        return CHAIN_CK * self.xw * 2 if self.shape.expand else 0

    @property
    def off_taps(self) -> int:
        return self.off_w2 + self.n2 * self.w2s * 2

    @property
    def off_b1(self) -> int:
        return self.off_taps + 9 * CHAIN_CK * 4

    @property
    def off_bd(self) -> int:
        return self.off_b1 + CHAIN_CK * 4

    @property
    def chunk_bytes(self) -> int:
        return self.off_bd + CHAIN_CK * 4

    @property
    def nbytes(self) -> int:
        return self.nchunks * self.chunk_bytes + _round_up(4 * self.shape.cout, 16)


def chain_tile_smem(tile_h: int, tile_w: int, cin: int, split: bool) -> int:
    """Shared memory of one tile of a block (csrc/planar_chain.cu, `derive`):
    the halo positions' offsets (int32), the input tile with its halo,
    channel-major (bf16, rows of XP positions), the expanded chunk
    position-major (float32, four positions more for the depthwise's reads
    past a row; two chunks when every warp takes every stage), the
    depthwise output position-major (bf16; two chunks with producer and
    consumer warps, `split`)."""
    npos = (tile_h + 2) * (tile_w + 2)
    mt = -(-(tile_h * tile_w) // 16)
    xp = _round_up(npos, 16) + 8
    nes, nds = (1, 2) if split else (2, 1)
    return (_round_up(4 * npos, 16) + _round_up(cin, 16) * xp * 2 + nes * (npos + 4) * (CHAIN_CK + 8) * 4
            + nds * mt * 16 * (CHAIN_CK + 8) * 2)


@dataclass(frozen=True)
class ChainBlockPlan:
    """One chain block of a launch: the output tile (rows, columns), the
    chunk width, each warp's project rectangle (PM M tiles by PN N tiles)."""

    tile_h: int
    tile_w: int
    ck: int
    pm: int
    pn: int


@dataclass(frozen=True)
class ChainPlan:
    """One launch of the chain kernel: a plan a block, the variant (warps,
    consumer warps, the largest rectangle PMX x PNX), the dynamic shared
    memory (three chunk buffers of the widest chunk, then the largest tile)
    and the cooperative grid (one thread block an SM)."""

    blocks: Tuple[ChainBlockPlan, ...]
    producers: int
    consumers: int
    pmx: int
    pnx: int
    smem_bytes: int
    grid: int


def _chain_shapes(shapes) -> Tuple[ChainShape, ...]:
    shapes = tuple(ChainShape(*s) for s in shapes)
    if not 1 <= len(shapes) <= MAX_CHAIN:
        raise ValueError(f"a chain has 1 to {MAX_CHAIN} blocks, got {len(shapes)}")
    for i, s in enumerate(shapes):
        if min(s.cin, s.ce, s.cout) < 1 or s.cin > MAX_CIN or (not s.expand and s.ce != s.cin):
            raise ValueError(f"block {i}: the chain kernel takes 1 <= Cin <= {MAX_CIN} and Ce == Cin without an "
                             f"expand, got {s}")
        if i and s.cin != shapes[i - 1].cout:
            raise ValueError(f"block {i} takes {s.cin} channels, block {i - 1} gives {shapes[i - 1].cout}")
    return shapes


def _rect(mt: int, nt: int, warps: int, pmx: int, pnx: int):
    """The smallest rectangle (PM, PN) within (PMX, PNX) whose copies cover
    the mt x nt project tiles with at most `warps` warps (the busiest warp's
    share), the squarer one on a tie (fewer fragment loads); None if none."""
    best = None
    for pm in range(1, min(pmx, mt) + 1):
        for pn in range(1, min(pnx, nt) + 1):
            if -(-mt // pm) * -(-nt // pn) <= warps:
                key = (pm * pn, pm + pn, -pm)
                if best is None or key < best[0]:
                    best = (key, (pm, pn))
    return None if best is None else best[1]


def _tiles(h: int, w: int):
    return dict.fromkeys((min(th, h), min(tw, w)) for th, tw in CHAIN_TILES)


def _chain_block_cost(b, h, w, s: ChainShape, bp: ChainBlockPlan, variant, grid: int) -> float:
    """Estimated time of one chain block, in cycles of the busiest SM. A
    chunk of a tile costs its expand of the halo (the K steps of an item's
    mma and its epilogue), its depthwise (units of four outputs by two
    channels) and its project (a warp's mma), each spread over the warps that
    take it; with consumer warps the project overlaps the other two. Fitted
    to `kernels/sweep_b4b.py`."""
    producers, consumers = variant[0], variant[1]
    th, tw = bp.tile_h, bp.tile_w
    npos = (th + 2) * (tw + 2)
    mt, nt = -(-(th * tw) // 16), -(-s.cout // 8)
    items = 2 * -(-npos // 16)
    if s.expand:
        stage_a = -(-items // producers) * ((_round_up(s.cin, 16) // 16) * 60 + 500)
    else:
        stage_a = -(-npos * 16 // (producers * 32)) * 40
    units = 16 * th * -(-tw // 4)
    stage_b = -(-units // (producers * 32)) * 900
    stage_c = bp.pm * bp.pn * 2 * 60 + 300
    chunk = max(stage_a + stage_b + 600, stage_c) if consumers else stage_a + stage_b + stage_c + 900
    nchunks = -(-s.ce // CHAIN_CK)
    tile = nchunks * chunk + s.cin * npos / (producers * 4) + 2000
    rounds = -(-(b * -(-h // th) * -(-w // tw)) // grid)
    return rounds * tile


def _plan_variant(shapes, b, h, w, variant, sms, tiles=None):
    """(cost, ChainPlan) of the variant (warps, consumer warps, PMX, PNX),
    each block on its cheapest tile of `tiles` (default: the planner's, cut to
    the map) that fits; None if some block has none."""
    producers, consumers, pmx, pnx = variant
    chunk = max(ChainLayout(s).chunk_bytes for s in shapes)
    budget = MAX_SMEM - 3 * chunk
    plans, cost = [], 0.0
    for s in shapes:
        best = None
        for th, tw in tiles or _tiles(h, w):
            if chain_tile_smem(th, tw, s.cin, consumers > 0) > budget:
                continue
            rect = _rect(-(-(th * tw) // 16), -(-s.cout // 8), consumers or producers, pmx, pnx)
            if rect is None:
                continue
            bp = ChainBlockPlan(th, tw, CHAIN_CK, *rect)
            c = _chain_block_cost(b, h, w, s, bp, variant, sms)
            if best is None or c < best[0]:
                best = (c, bp)
        if best is None:
            return None
        cost += best[0] + 4000   # the grid-wide sync after each block
        plans.append(best[1])
    items = max(b * -(-h // p.tile_h) * -(-w // p.tile_w) for p in plans)
    smem = 3 * chunk + max(chain_tile_smem(p.tile_h, p.tile_w, s.cin, consumers > 0) for p, s in zip(plans, shapes))
    return cost, ChainPlan(tuple(plans), producers, consumers, pmx, pnx, smem, min(items, sms))


def chain_plans(shapes, b: int, h: int, w: int, sms: int = NUM_SMS):
    """The launch plans `kernels/sweep_b4b.py` times: for each variant of
    CHAIN_VARIANTS, every tile of CHAIN_TILES (cut to the map) of at least 64
    positions (or the whole map) that fits every block, the same for all."""
    shapes = _chain_shapes(shapes)
    for variant in CHAIN_VARIANTS:
        for tile in _tiles(h, w):
            if tile[0] * tile[1] < min(64, h * w):
                continue
            got = _plan_variant(shapes, b, h, w, variant, sms, tiles=[tile])
            if got is not None:
                yield got[1]


@functools.lru_cache(maxsize=256)
def plan_planar_chain(shapes, b: int, h: int, w: int, sms: int = NUM_SMS) -> ChainPlan:
    """The chain kernel's launch plan for a chain of `shapes` (ChainShape, or
    (Cin, Ce, Cout[, expand]) tuples) on a (b, h, w) map on `sms` SMs: of
    the variants of CHAIN_VARIANTS, the one whose blocks, each on the tile
    that `_chain_block_cost` finds cheapest within the shared memory, cost
    least in all. Raises ValueError on shapes the kernel does not take or if
    no plan fits."""
    shapes = _chain_shapes(shapes)
    if min(b, h, w, sms) < 1:
        raise ValueError(f"a non-empty map and at least one SM, got {(b, h, w, sms)}")
    best = None
    for variant in CHAIN_VARIANTS:
        got = _plan_variant(shapes, b, h, w, variant, sms)
        if got is not None and (best is None or got[0] < best[0]):
            best = got
    if best is None:
        raise ValueError(f"no plan of the chain kernel fits {shapes} at {(b, h, w)}")
    return best[1]


# --------------------------------------------------------------------------- #
# the one-block kernel's launch plan (csrc/planar_chain.cu, tcf_planar_block)
# --------------------------------------------------------------------------- #

# (warps, consumer warps, PMX, PNX, streamed): B4a's variants. Streamed is the
# one-block kernel `planar_block_stream`: 8 warps that take every stage,
# persistent thread blocks, two an SM where the shared memory allows, the
# input tiles by tensor copies a tile ahead; rectangles of at most 2 x 2
# project tiles (16 float32 sums a thread, which leave the depthwise more
# registers) or 2 x 4. The others are the chain kernel's variants
# (CHAIN_VARIANTS) on a chain of one: one thread block an SM, the tile loaded
# when it is taken, 8 producer and 8 consumer warps for wide outputs.
ONE_BLOCK_VARIANTS = ((8, 0, 2, 2, True), (8, 0, 2, 4, True)) + tuple((*v, False) for v in CHAIN_VARIANTS)
# shared memory of a thread block when two share an SM: the SM's 228 KB, less
# the 1 KB the card keeps for each block
TWO_BLOCKS_SMEM = 233472 // 2 - 1024
# output tiles (rows, columns) the one-block planner weighs besides
# CHAIN_TILES, each cut to the map: widths of 16k - 1, whose halo rows, from
# the 16 bytes at or before their first position, fill boxes of an odd
# number of 16 bytes (rows of xs that ldmatrix reads on distinct banks)
ONE_BLOCK_TILES = CHAIN_TILES + ((16, 15), (8, 15), (16, 31), (12, 31), (8, 31), (6, 31), (4, 31), (8, 47), (6, 47),
                                 (4, 47), (4, 63), (2, 63))


def block_tile_smem(tile_h: int, tile_w: int, cin: int) -> int:
    """Shared memory of one tile of the streamed one-block kernel
    (csrc/planar_chain.cu, `derive` with rows): two mbarriers (128 bytes),
    two buffers of the input rows ([tile_h + 2][cin rounded up to 16][IWB]
    bf16: a halo row of tile_w + 2 positions read from the 16 bytes at or
    before it, IWB = tile_w + 9 rounded up to 8), one expanded chunk
    (float32, position-major, four positions more) and one depthwise output
    (bf16)."""
    npos = (tile_h + 2) * (tile_w + 2)
    mt = -(-(tile_h * tile_w) // 16)
    return (128 + 2 * (tile_h + 2) * _round_up(cin, 16) * block_row_width(tile_w) * 2
            + (npos + 4) * (CHAIN_CK + 8) * 4 + mt * 16 * (CHAIN_CK + 8) * 2)


def block_row_width(tile_w: int) -> int:
    """IWB: positions of a halo row in the streamed kernel's input buffer,
    tile_w + 2 of them read from the 16 bytes at or before the first."""
    return _round_up(tile_w + 9, 8)


@dataclass(frozen=True)
class OneBlockPlan:
    """One launch of the one-block kernel (B4a): the variant (warps, consumer
    warps, PMX, PNX, streamed), the output tile (rows, columns), each warp's
    project rectangle (PM M tiles by PN N tiles), the chunk buffers (three, a
    ring; or, streamed, one for each of more than three chunks, copied once),
    the dynamic shared memory (the chunk buffers, then the tile), thread
    blocks an SM, and the grid."""

    variant: Tuple[int, int, int, int, bool]
    tile_h: int
    tile_w: int
    pm: int
    pn: int
    chunk_buffers: int
    smem_bytes: int
    blocks_per_sm: int
    grid: int

    @property
    def streamed(self) -> bool:
        return self.variant[4]

    def describe(self) -> str:
        warps, consumers, pmx, pnx, streamed = self.variant
        kind = (f"streamed, {warps} warps, {self.blocks_per_sm} blocks an SM, {self.chunk_buffers} chunk buffers"
                if streamed else
                f"chain of one, {warps} + {consumers} warps" if consumers else f"chain of one, {warps} warps")
        return (f"{self.tile_h}x{self.tile_w} tile, {kind}, {self.pm}x{self.pn} rectangles of at most {pmx}x{pnx}, "
                f"grid {self.grid}")


def _one_block_shape(shape, skip: bool) -> ChainShape:
    s = ChainShape(*shape)
    if min(s.cin, s.ce, s.cout) < 1 or s.cin > MAX_CIN or (not s.expand and s.ce != s.cin):
        raise ValueError(f"the one-block kernel takes 1 <= Cin <= {MAX_CIN} and Ce == Cin without an expand, got {s}")
    if skip and not s.expand:
        raise ValueError("a skip without an expand is not supported")
    if skip and s.cin != s.cout:
        raise ValueError(f"the skip needs Cin == Cout, got {s.cin} and {s.cout}")
    return s


def _block_stream_cost(b, h, w, s: ChainShape, th, tw, pm, pn, pnx, resident, per_sm, sms) -> float:
    """Estimated time of the streamed kernel, in cycles of the busiest SM: a
    chunk of a tile is its expand over whole rows of the input buffer, its
    depthwise (units of four outputs by two channels) and its project one
    after the other over the 8 warps, two barriers between (three when the
    weights are not resident); two thread blocks on an SM overlap part of
    each other's work; the 2 x 4 variant's eight more sums a thread cost the
    rest of the kernel 7%. The input rows arrive ahead, so the time is
    also at least the bytes that the tiles read (their halos included) and
    write, at 10 bytes a cycle of an SM. Fitted to `kernels/sweep_b4a.py`."""
    iwb = block_row_width(tw)
    mtiles = -(-((th + 2) * iwb) // 16)
    if s.expand:
        stage_a = -(-mtiles // 8) * ((_round_up(s.cin, 16) // 16) * 30 + 690)
    else:
        stage_a = -(-mtiles // 8) * 800
    stage_b = -(-(16 * th * -(-tw // 4)) // 256) * 490
    chunk = stage_a + stage_b + pm * pn * 2 * 60 + 300 + (2 if resident else 3) * 350
    tile = -(-s.ce // CHAIN_CK) * chunk + 1060 + pm * pn * 200
    items = b * -(-h // th) * -(-w // tw)
    compute = -(-items // (sms * per_sm)) * tile * (1.34 if per_sm == 2 else 1.0) * (1.07 if pnx > 2 else 1.0)
    nbytes = items * (th + 2) * iwb * s.cin * 2 + b * h * w * s.cout * 2
    return max(compute, nbytes / (10.0 * sms))


def _one_block_candidates(s: ChainShape, b, h, w, sms, variants, tiles):
    """(cost, OneBlockPlan) of every variant, tile and (streamed) chunk
    buffering that fits."""
    chunk = ChainLayout(s).chunk_bytes
    nchunks = -(-s.ce // CHAIN_CK)
    nt = -(-s.cout // 8)
    for variant in variants:
        warps, consumers, pmx, pnx, streamed = variant
        for th, tw in dict.fromkeys((min(th, h), min(tw, w)) for th, tw in tiles):
            rect = _rect(-(-(th * tw) // 16), nt, consumers or warps, pmx, pnx)
            if rect is None or (streamed and block_row_width(tw) > 256):
                continue
            items = b * -(-h // th) * -(-w // tw)
            if not streamed:
                smem = 3 * chunk + chain_tile_smem(th, tw, s.cin, consumers > 0)
                if smem <= MAX_SMEM:
                    # the chain's cost, and its tile load from device memory, not
                    # overlapped: eight 2-byte loads in flight a producer thread
                    # (~2290 cycles a round of them, fitted to kernels/sweep_b4a.py)
                    load = -(-(_round_up(s.cin, 16) * (th + 2) * (tw + 2)) // (warps * 32 * 8)) * 2290
                    cost = (_chain_block_cost(b, h, w, s, ChainBlockPlan(th, tw, CHAIN_CK, *rect), variant[:4], sms)
                            + -(-items // sms) * load)
                    yield cost, OneBlockPlan(variant, th, tw, *rect, 3, smem, 1, min(items, sms))
                continue
            for buffers in dict.fromkeys((3, max(3, nchunks))):
                smem = buffers * chunk + block_tile_smem(th, tw, s.cin)
                if smem > MAX_SMEM:
                    continue
                per_sm = 2 if smem <= TWO_BLOCKS_SMEM else 1
                cost = _block_stream_cost(b, h, w, s, th, tw, *rect, pnx, buffers >= nchunks, per_sm, sms)
                yield cost, OneBlockPlan(variant, th, tw, *rect, buffers, smem, per_sm, min(items, sms * per_sm))


def one_block_plans(shape, b: int, h: int, w: int, sms: int = NUM_SMS, *, skip: bool = False):
    """The launch plans `kernels/sweep_b4a.py` times: every variant of
    ONE_BLOCK_VARIANTS with every tile of ONE_BLOCK_TILES (cut to the map)
    of at least 64 positions (or the whole map) that fits."""
    s = _one_block_shape(shape, skip)
    tiles = [t for t in ONE_BLOCK_TILES if min(t[0], h) * min(t[1], w) >= min(64, h * w)]
    for _, plan in _one_block_candidates(s, b, h, w, sms, ONE_BLOCK_VARIANTS, tiles):
        yield plan


@functools.lru_cache(maxsize=256)
def plan_planar_mbconv(shape, b: int, h: int, w: int, sms: int = NUM_SMS, *, skip: bool = False) -> OneBlockPlan:
    """The one-block kernel's launch plan for a block of `shape` (ChainShape,
    or (Cin, Ce, Cout[, expand])) on a (b, h, w) map on `sms` SMs: of every
    variant of ONE_BLOCK_VARIANTS and tile of ONE_BLOCK_TILES (cut to the
    map) that fits the shared memory, the one that its cost model
    (`_block_stream_cost`, `_chain_block_cost`) finds cheapest. Raises
    ValueError on a block the kernel does not take (Cin > MAX_CIN, a skip
    without an expand) or if no plan fits."""
    s = _one_block_shape(shape, skip)
    if min(b, h, w, sms) < 1:
        raise ValueError(f"a non-empty map and at least one SM, got {(b, h, w, sms)}")
    best = min(_one_block_candidates(s, b, h, w, sms, ONE_BLOCK_VARIANTS, ONE_BLOCK_TILES), key=lambda c: c[0],
               default=None)
    if best is None:
        raise ValueError(f"no plan of the one-block kernel fits {s} at {(b, h, w)}")
    return best[1]


def epilogue_bf16(sums: torch.Tensor) -> torch.Tensor:
    """The kernels' epilogue rounding in plain torch: float32 sums (the
    project, b2 and the skip added) rounded once to the nearest bfloat16,
    ties to even, as `__float2bfloat16_rn` does; NaN stays NaN."""
    bits = sums.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    up = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16
    up = torch.where(torch.isnan(sums.float()), (bits >> 16) | 0x40, up) & 0xFFFF
    return (up - ((up >> 15) << 16)).to(torch.int16).view(torch.bfloat16)


@dataclass(frozen=True)
class PackedChain:
    """A chain's weights in the chain kernel's layout (`pack_planar_chain`):
    `data` holds the blocks' ChainLayout bytes one after the other (uint8,
    one tensor, on one device); `shapes` and `skips` a block."""

    data: torch.Tensor
    shapes: Tuple[ChainShape, ...]
    skips: Tuple[bool, ...]

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def offsets(self) -> Tuple[int, ...]:
        """Byte offset of each block's chunks in `data`."""
        offs, at = [], 0
        for s in self.shapes:
            offs.append(at)
            at += ChainLayout(s).nbytes
        return tuple(offs)


def _bytes(t: torch.Tensor, n: int) -> torch.Tensor:
    """(n, ...) -> (n, bytes of a row) uint8."""
    return t.contiguous().view(torch.uint8).reshape(n, -1)


def pack_planar_chain(blocks: Sequence[Mapping[str, Any]], cin: int, device) -> PackedChain:
    """Check a chain of blocks ({w1, b1, wd, bd, w2, b2, skip}, tensors or
    numpy arrays; w1 and b1 None without an expand) that starts at `cin`
    channels and lay its weights out once, in the chain kernel's layout
    (ChainLayout), on `device`. `unpack_planar_chain` gives them back."""
    parts, shapes, skips = [], [], []
    c = cin
    for blk in blocks:
        w1, b1, wd, bd, w2, b2, skip = (
            torch.as_tensor(a) if a is not None and not isinstance(a, bool) else a for a in _block_tuple(blk)
        )
        sh = _block_shapes(c, w1, b1, wd, bd, w2, b2, skip)
        s = ChainShape(sh.cin, sh.ce, sh.cout, w1 is not None)
        if s.cin > MAX_CIN:
            raise ValueError(f"the planar kernels take at most {MAX_CIN} input channels a block, got {s.cin}")
        lay = ChainLayout(s)
        n, ck = lay.nchunks, CHAIN_CK
        cpad = n * ck

        def padded(t, shape, dtype):
            out = torch.zeros(shape, dtype=dtype)
            out[tuple(slice(0, d) for d in t.shape)] = t.to(dtype)
            return out

        chunk = []
        if s.expand:
            w1c = padded(w1.reshape(s.cin, s.ce).t().float(), (cpad, lay.xw), torch.bfloat16)
            chunk.append(_bytes(w1c.reshape(n, ck, lay.xw), n))
        w2c = padded(w2.reshape(s.ce, s.cout).t().float(), (lay.n2, cpad), torch.bfloat16)
        w2c = torch.cat([w2c.reshape(lay.n2, n, ck).permute(1, 0, 2),
                         torch.zeros((n, lay.n2, lay.w2s - ck), dtype=torch.bfloat16)], dim=2)
        chunk.append(_bytes(w2c, n))
        taps = padded(wd.reshape(9, s.ce).float(), (9, cpad), torch.float32)
        chunk.append(_bytes(taps.reshape(9, n, ck).permute(1, 0, 2), n))
        for v in (b1 if s.expand else torch.zeros(s.ce), bd):
            chunk.append(_bytes(padded(v.reshape(s.ce).float(), (cpad,), torch.float32).reshape(n, ck), n))
        parts += [torch.cat(chunk, dim=1).reshape(-1),
                  padded(b2.reshape(s.cout).float(), (_round_up(s.cout, 4),), torch.float32).view(torch.uint8)]
        shapes.append(s)
        skips.append(bool(skip))
        c = s.cout
    shapes = _chain_shapes(shapes)
    return PackedChain(torch.cat(parts).to(device), shapes, tuple(skips))


def unpack_planar_chain(packed: PackedChain) -> List[dict]:
    """The blocks back from `pack_planar_chain`, in the port's layout: w1
    (Cin, Ce) and w2 (Ce, Cout) bfloat16 (None without an expand), wd
    (3, 3, Ce), b1, bd, b2 float32, and skip."""
    d = packed.data.cpu()
    out = []
    for s, skip, at in zip(packed.shapes, packed.skips, packed.offsets):
        lay = ChainLayout(s)
        n, ck = lay.nchunks, CHAIN_CK
        chunks = d[at : at + n * lay.chunk_bytes].reshape(n, lay.chunk_bytes)

        def part(lo, hi, dtype, *shape):
            return chunks[:, lo:hi].contiguous().view(dtype).reshape(n, *shape)

        w1 = None
        if s.expand:
            w1 = part(0, lay.off_w2, torch.bfloat16, ck, lay.xw).reshape(n * ck, lay.xw)[: s.ce, : s.cin]
        w2 = part(lay.off_w2, lay.off_taps, torch.bfloat16, lay.n2, lay.w2s)[:, : s.cout, :ck]
        taps = part(lay.off_taps, lay.off_b1, torch.float32, 9, ck).permute(1, 0, 2).reshape(9, n * ck)
        b1 = part(lay.off_b1, lay.off_bd, torch.float32, ck).reshape(-1)[: s.ce]
        bd = part(lay.off_bd, lay.chunk_bytes, torch.float32, ck).reshape(-1)[: s.ce]
        b2 = d[at + n * lay.chunk_bytes : at + n * lay.chunk_bytes + 4 * s.cout].view(torch.float32)
        out.append({
            "w1": None if w1 is None else w1.t().contiguous(), "b1": b1.clone() if s.expand else None,
            "wd": taps[:, : s.ce].reshape(3, 3, s.ce).clone(), "bd": bd.clone(),
            "w2": w2.permute(0, 2, 1).reshape(n * ck, s.cout)[: s.ce].contiguous(), "b2": b2.clone(),
            "skip": skip,
        })
    return out


# --------------------------------------------------------------------------- #
# the kernels
# --------------------------------------------------------------------------- #

_P, _I32 = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _kernels():
    """The built entry points of csrc/planar_chain.cu, typed: (tcf_planar_block,
    the one-block kernel; tcf_planar_chain)."""
    from tpucenterface_torch.kernels import build

    lib = build.load("planar_chain")
    one, chain = lib.tcf_planar_block, lib.tcf_planar_chain
    # x, out, packed, packed bytes, table[10], B, H, W, Wp, relu6, producers, consumers, pmx, pnx,
    # streamed, chunk buffers, smem, grid, stream
    one.argtypes = [_P] * 3 + [ctypes.c_longlong, _P] + [_I32] * 13 + [_P]
    # x, out, scratch0, scratch1, packed, packed bytes, table[10 n], n, B, H, W, Wp, relu6,
    # producers, consumers, pmx, pnx, smem, grid, stream
    chain.argtypes = [_P] * 5 + [ctypes.c_longlong, _P] + [_I32] * 12 + [_P]
    one.restype = chain.restype = _I32
    return one, chain


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _device_index(x: torch.Tensor) -> int:
    return torch.cuda.current_device() if x.device.index is None else x.device.index


def _check_cuda_input(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the {what} kernel takes bfloat16 input, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous planar (B, C, H*Wp)")
    if x.numel() == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")


def _shapes_of(blocks, cin: int):
    """The (Cin, Ce, Cout, expand) of each block of a PackedChain or of the
    blocks' dicts."""
    if isinstance(blocks, PackedChain):
        return [(s.cin, s.ce, s.cout, s.expand) for s in blocks.shapes]
    out = []
    for blk in blocks:
        ce, cout = blk["wd"].shape[-1], blk["w2"].shape[-1]
        out.append((cin, ce, cout, blk["w1"] is not None))
        cin = cout
    return out


def chain_work(x: torch.Tensor, blocks, *, H: int, W: int, **_) -> Tuple[int, int]:
    """(operations, bytes) of a chain of blocks, as the kernel table's bound
    counts them: each block's expand and project products and its depthwise's
    nine multiply-adds an expanded value; x read once and the last block's
    output written once (bfloat16), every weight read once (w1 and w2 in
    bfloat16, wd and the biases in float32)."""
    pos = x.shape[0] * H * W
    shapes = _shapes_of(blocks, x.shape[1])
    ops, nbytes = 0, 2 * pos * (shapes[0][0] + shapes[-1][2])
    for cin, ce, cout, expand in shapes:
        ex = cin * ce if expand else 0
        ops += 2 * pos * (ex + ce * cout + 9 * ce)
        nbytes += 2 * (ex + ce * cout) + 4 * (9 * ce + ce + cout + (ce if expand else 0))
    return ops, nbytes


def block_work(x: torch.Tensor, w1=None, b1=None, wd=None, bd=None, w2=None, b2=None, *, H: int, W: int,
               **_) -> Tuple[int, int]:
    """`chain_work` of one block: its PackedChain of one, or its weights."""
    blocks = w1 if isinstance(w1, PackedChain) else [{"w1": w1, "wd": wd, "w2": w2}]
    return chain_work(x, blocks, H=H, W=W)


@counts_work("planar_block", block_work)
def planar_mbconv(
    x: torch.Tensor,
    w1: Union[Optional[torch.Tensor], PackedChain],
    b1: Optional[torch.Tensor] = None,
    wd: Optional[torch.Tensor] = None,
    bd: Optional[torch.Tensor] = None,
    w2: Optional[torch.Tensor] = None,
    b2: Optional[torch.Tensor] = None,
    *,
    H: int,
    W: int,
    skip: Optional[bool] = None,
    relu6: bool = True,
) -> torch.Tensor:
    """One fused inverted-residual block, stride 1, row-padded planar:
    x (B, Cin, H*Wp) -> (B, Cout, H*Wp) in `x.dtype`, summed in float32 and
    rounded once.

    The block is its six weights and `skip`, as in the JAX function, or, in
    the place of `w1`, its `PackedChain` of one block (`pack_planar_chain`;
    then `skip` is the packed one's). CUDA tensors launch `tcf_planar_block`
    of csrc/planar_chain.cu with `plan_planar_mbconv`'s plan (bfloat16 input,
    Cin <= MAX_CIN); CPU tensors take `planar_mbconv_plain`. A skip needs an
    expand, as in the JAX function. `planar_mbconv.launches` counts kernel
    launches. No `interpret` argument: see the module docstring.
    """
    wp = _check_planar(x, H, W)
    packed = w1 if isinstance(w1, PackedChain) else None
    if packed is None:
        if wd is None or bd is None or w2 is None or b2 is None or skip is None:
            raise TypeError("planar_mbconv takes w1, b1, wd, bd, w2, b2 and skip, or the PackedChain of one block")
        if skip and w1 is None:
            raise ValueError("a skip without an expand is not supported")
    if x.device.type == "cpu":
        if packed is not None:
            raise ValueError("packed blocks are for the kernel; pass the block's weights on the CPU")
        return planar_mbconv_plain(x, w1, b1, wd, bd, w2, b2, H=H, W=W, skip=skip, relu6=relu6)
    if x.device.type != "cuda":
        raise ValueError(f"planar_mbconv runs on cuda or cpu, not {x.device}")
    _check_cuda_input(x, "planar block")
    if packed is None:
        blk = {"w1": w1, "b1": b1, "wd": wd, "bd": bd, "w2": w2, "b2": b2, "skip": skip}
        packed = pack_planar_chain([blk], x.shape[1], x.device)
    if packed.device != x.device or packed.shapes[0].cin != x.shape[1]:
        raise ValueError(f"the block was packed for {packed.shapes[0].cin} channels on {packed.device}, "
                         f"x has {x.shape[1]} on {x.device}")
    if len(packed.shapes) != 1:
        raise ValueError(f"planar_mbconv takes one block, got a PackedChain of {len(packed.shapes)}")
    b = x.shape[0]
    plan = plan_planar_mbconv(packed.shapes[0], b, H, W, _num_sms(_device_index(x)), skip=packed.skips[0])
    out = torch.empty((b, packed.shapes[0].cout, H * wp), dtype=torch.bfloat16, device=x.device)
    launch_planar_mbconv(x, packed, plan, out, H=H, W=W, relu6=relu6)
    planar_mbconv.launches += 1
    return out


def launch_planar_mbconv(x, packed: PackedChain, plan: OneBlockPlan, out, *, H: int, W: int,
                         relu6: bool = True) -> None:
    """Launch the one-block kernel (`tcf_planar_block`) with `plan` into
    `out`, on a block and an input that `planar_mbconv` has checked
    (`kernels/sweep_b4a.py` times every plan of `one_block_plans` through
    it); raises if the kernel refuses the plan or fails to launch. Counts
    nothing."""
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("the one-block kernel reads x by tensor copies: x and out must start on 16 bytes")
    s, skip = packed.shapes[0], packed.skips[0]
    table = [s.cin, s.ce, s.cout, int(skip), int(s.expand), CHAIN_CK, plan.tile_h, plan.tile_w, plan.pm, plan.pn]
    warps, consumers, pmx, pnx, streamed = plan.variant
    fn, _ = _kernels()
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), out.data_ptr(), packed.data.data_ptr(), packed.data.numel(), (_I32 * 10)(*table),
            x.shape[0], H, W, padded_width(H, W), int(relu6), warps, consumers, pmx, pnx, int(streamed),
            plan.chunk_buffers, plan.smem_bytes, plan.grid, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"planar block kernel launch failed with CUDA error {rc}")


planar_mbconv.launches = 0


@counts_work("planar_chain", chain_work)
def planar_mbconv_chain(
    x: torch.Tensor,
    blocks: Union[Sequence[Mapping[str, Any]], PackedChain],
    *,
    H: int,
    W: int,
    relu6: bool = True,
) -> torch.Tensor:
    """N consecutive stride-1 inverted-residual blocks in ONE kernel launch:
    x (B, C0, H*Wp) -> (B, C_last, H*Wp) bfloat16.

    `blocks` is a sequence of dicts {w1, b1, wd, bd, w2, b2, skip} (w1 and b1
    None without an expand) or their `PackedChain` (`pack_planar_chain`).
    CUDA tensors launch `tcf_planar_chain` of csrc/planar_chain.cu once,
    whatever N is (bfloat16 input, N <= MAX_CHAIN, Cin <= MAX_CIN in every
    block), with `plan_planar_chain`'s plan; CPU tensors take
    `planar_mbconv_chain_plain`. `planar_mbconv_chain.launches` counts kernel
    launches. No `interpret` argument: see the module docstring.
    """
    wp = _check_planar(x, H, W)
    if x.device.type == "cpu":
        if isinstance(blocks, PackedChain):
            raise ValueError("packed blocks are for the kernel; pass the blocks' dicts on the CPU")
        return planar_mbconv_chain_plain(x, blocks, H=H, W=W, relu6=relu6)
    if x.device.type != "cuda":
        raise ValueError(f"planar_mbconv_chain runs on cuda or cpu, not {x.device}")
    _check_cuda_input(x, "planar chain")
    packed = blocks if isinstance(blocks, PackedChain) else pack_planar_chain(blocks, x.shape[1], x.device)
    if packed.device != x.device or packed.shapes[0].cin != x.shape[1]:
        raise ValueError(f"the chain was packed for {packed.shapes[0].cin} channels on {packed.device}, "
                         f"x has {x.shape[1]} on {x.device}")
    b = x.shape[0]
    plan = plan_planar_chain(packed.shapes, b, H, W, _num_sms(_device_index(x)))
    out = torch.empty((b, packed.shapes[-1].cout, H * wp), dtype=torch.bfloat16, device=x.device)
    launch_planar_chain(x, packed, plan, out, H=H, W=W, relu6=relu6)
    planar_mbconv_chain.launches += 1
    return out


def launch_planar_chain(x, packed: PackedChain, plan: ChainPlan, out, *, H: int, W: int, relu6: bool = True) -> None:
    """Launch csrc/planar_chain.cu with `plan` into `out`, on a chain and an
    input that `planar_mbconv_chain` has checked (`kernels/sweep_b4b.py`
    times every plan of `chain_plans` through it); raises if the kernel
    refuses the plan or fails to launch. Counts nothing."""
    b, n, wp = x.shape[0], len(packed.shapes), padded_width(H, W)
    # the blocks' outputs between the first and the last go through two
    # buffers in turn, wide enough for the widest of them
    scratch = [None, None]
    if n > 1:
        widest = max(s.cout for s in packed.shapes[:-1])
        for i in range(min(n - 1, 2)):
            scratch[i] = torch.empty((b, widest, H * wp), dtype=torch.bfloat16, device=x.device)
    table = []
    for s, skip, bp in zip(packed.shapes, packed.skips, plan.blocks):
        table += [s.cin, s.ce, s.cout, int(skip), int(s.expand), bp.ck, bp.tile_h, bp.tile_w, bp.pm, bp.pn]
    _, fn = _kernels()
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), out.data_ptr(), *(None if t is None else t.data_ptr() for t in scratch),
            packed.data.data_ptr(), packed.data.numel(), (_I32 * len(table))(*table), n,
            b, H, W, wp, int(relu6), plan.producers, plan.consumers, plan.pmx, plan.pnx, plan.smem_bytes, plan.grid,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"planar chain kernel launch failed with CUDA error {rc}")


planar_mbconv_chain.launches = 0
