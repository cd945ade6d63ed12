"""Fused MobileNetV2 inverted-residual block: the CUDA kernel `csrc/mbconv.cu`,
its launch plan and packed weights, its plain version and a float32 reference.

Mirrors `tpucenterface/ops/fused_mbconv.py` (`fused_mbconv`, `mbconv_reference`),
the TPU kernel it replaces, for stride-1 blocks:

    1x1 expand + bias + ReLU6 -> 3x3 depthwise + bias + ReLU6
    -> 1x1 project + bias [-> + skip]

in one kernel, so the expanded tensor never reaches device memory. Tensors
are NHWC: x (B, H, W, Cin); w1 (Cin, Ce) or None when the block has no
expand (then Ce == Cin); wd (3, 3, Ce); w2 (Ce, Cout); biases 1-D.

`fused_mbconv` launches the kernel for CUDA tensors and takes
`fused_mbconv_plain` only for tensors on the CPU. It takes the six weights,
or a `PackedMBConv` from `pack_fused_mbconv` (the kernel's layout, made once:
`model/fast_forward.py` packs every block at build). The launch plan comes
from `plan_fused_mbconv` (the output tile, fitted to the map, the warps and
each warp's share of the project). The plain version has the kernel's own
cast points (bfloat16 operands, float32 sums); `mbconv_reference` is the same
block in float32 throughout.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from tpucenterface_torch.runtime.profiling import counts_work

# The kernel keeps a halo'd input tile and two chunks of w1 in shared memory at
# the input's full channel width; model/fast_forward.py sends it blocks of at
# most this many input channels (every shape up to it has a plan).
MAX_CIN = 208


def _act(v: torch.Tensor, relu6: bool) -> torch.Tensor:
    return v.clamp(0.0, 6.0) if relu6 else v.relu()


def _weight_dims(w1, b1, wd, bd, w2, b2, cin: Optional[int] = None):
    """(Cin, Ce, Cout) of the six weights; Cin is w1's rows, or Ce without an
    expand. Raises ValueError on shapes that do not fit together or `cin`."""
    if wd.dim() != 3 or tuple(wd.shape[:2]) != (3, 3):
        raise ValueError(f"wd must be (3, 3, Ce), got {tuple(wd.shape)}")
    ce = wd.shape[-1]
    if (w1 is None) != (b1 is None):
        raise ValueError("w1 and b1 are given together or not at all")
    if w1 is None:
        if cin is not None and ce != cin:
            raise ValueError(f"without an expand Ce must equal Cin, got {ce} and {cin}")
        cin = ce
    else:
        cin = w1.shape[0] if cin is None else cin
        if tuple(w1.shape) != (cin, ce) or tuple(b1.shape) != (ce,):
            raise ValueError(f"w1 must be ({cin}, {ce}) and b1 ({ce},), got {tuple(w1.shape)}, {tuple(b1.shape)}")
    if w2.dim() != 2 or w2.shape[0] != ce:
        raise ValueError(f"w2 must be ({ce}, Cout), got {tuple(w2.shape)}")
    cout = w2.shape[1]
    if tuple(bd.shape) != (ce,) or tuple(b2.shape) != (cout,):
        raise ValueError(f"bd must be ({ce},) and b2 ({cout},), got {tuple(bd.shape)}, {tuple(b2.shape)}")
    return cin, ce, cout


def _check_shapes(x, w1, b1, wd, bd, w2, b2, skip: bool):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Cin), got {tuple(x.shape)}")
    cin, ce, cout = _weight_dims(w1, b1, wd, bd, w2, b2, cin=x.shape[-1])
    if skip and cin != cout:
        raise ValueError(f"the skip needs Cin == Cout, got {cin} and {cout}")
    return cin, ce, cout


def mbconv_reference(x, w1, b1, wd, bd, w2, b2, *, skip: bool, relu6: bool = True) -> torch.Tensor:
    """The block in float32 (convolutions of the input as it is, one cast at
    the end to `x.dtype`)."""
    _, ce, _ = _check_shapes(x, w1, b1, wd, bd, w2, b2, skip)
    xf = x.float()
    y = xf.permute(0, 3, 1, 2)
    if w1 is not None:
        y = _act(F.conv2d(y, w1.float().t()[:, :, None, None], b1.float()), relu6)
    y = F.conv2d(y, wd.float().permute(2, 0, 1)[:, None], bd.float(), padding=1, groups=ce)
    y = F.conv2d(_act(y, relu6), w2.float().t()[:, :, None, None], b2.float())
    y = y.permute(0, 2, 3, 1)
    if skip:
        y = y + xf
    return y.to(x.dtype)


def fused_mbconv_plain(x, w1, b1, wd, bd, w2, b2, *, skip: bool, relu6: bool = True) -> torch.Tensor:
    """Plain torch version of the kernel, with its cast points: the input and
    all weights and biases are rounded to bfloat16; the expand sums in
    float32, adds b1, activates and rounds to bfloat16; expanded values at
    the image's zero-pad positions are 0 (not act(b1)); the nine depthwise
    taps sum in float32 in the order dy, dx; the depthwise result is rounded
    to bfloat16; the project sums in float32, adds b2 and the skip, and
    rounds once to `x.dtype`. bfloat16 values and their pairwise products are
    exact in float32, so float32 matrix products stand for the kernel's
    bfloat16 products with float32 accumulation."""
    _check_shapes(x, w1, b1, wd, bd, w2, b2, skip)
    bf = torch.bfloat16

    def r(t):  # round to bfloat16, continue in float32
        return t.to(bf).float()

    b, h, w, _ = x.shape
    xb = r(x)
    e = xb
    if w1 is not None:
        e = r(_act(torch.matmul(xb, r(w1)) + r(b1), relu6))
    # zero-pad after the expand: the border taps see 0
    ep = F.pad(e, (0, 0, 1, 1, 1, 1))
    wdf = r(wd)
    acc = torch.zeros_like(e)
    for dy in range(3):
        for dx in range(3):
            acc = acc + ep[:, dy : dy + h, dx : dx + w, :] * wdf[dy, dx]
    d = r(_act(acc + r(bd), relu6))
    p = torch.matmul(d, r(w2)) + r(b2)
    if skip:
        p = p + xb
    return p.to(x.dtype)


# ------------------------------------------------------------------------- #
# the launch plan and the packed weights (csrc/mbconv.cu)
# ------------------------------------------------------------------------- #

MAX_SMEM = 232448       # bytes of shared memory a block may use on sm_90
SM_SMEM = 233472        # bytes of shared memory of an SM, 1 KB of it reserved a block
NUM_SMS = 132           # H100 SXM
# (warps, PM, PN): the project rectangles a warp may own, PM M tiles of 16
# positions by PN N tiles of 8 output channels (csrc/mbconv.cu, `dispatch`),
# and the blocks an SM holds of each at its launch bounds (`occupancy`). A
# warp's sums take 4 * PM * PN registers whether its N tiles are used or not:
# the planner takes the first of equally cheap plans, the narrowest.
MBCONV_BLOCKS_PER_SM = {(8, 2, 4): 2, (8, 2, 8): 2, (16, 1, 12): 1}
MBCONV_VARIANTS = tuple(MBCONV_BLOCKS_PER_SM)
# output tiles (rows, columns) the planner weighs, each cut to the map
MBCONV_TILES = ((16, 16), (20, 20), (10, 20), (8, 40), (8, 32), (8, 20), (10, 10), (8, 16), (8, 8), (5, 10),
                (4, 8), (4, 4))
# rows past the halo that a depthwise window may read (csrc/mbconv.cu, kSpare)
_SPARE = 4


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


MBCONV_CHUNKS = (64, 48, 32)


def mbconv_chunk_width(ce: int) -> int:
    """The chunk of expanded channels (MBCONV_CHUNKS): the width that pads Ce
    least, the wider one on a tie."""
    return min(MBCONV_CHUNKS, key=lambda ck: (_round_up(ce, ck), -ck))


@dataclass(frozen=True)
class MBConvLayout:
    """Byte layout of one chunk of B3's packed weights, which is also that of
    its shared-memory buffer: w1 [CK][XS] bf16 (with an expand) | w2
    [Cout][CK + 8] bf16 | taps [9][CK] f32 | b1 [CK] f32 | bd [CK] f32."""

    cin: int
    ce: int
    cout: int
    ck: int
    expand: bool

    @property
    def cin_pad(self) -> int:
        """K of the expand; without one, the input's channels in whole chunks."""
        return _round_up(self.cin, 16) if self.expand else _round_up(self.cin, self.ck)

    @property
    def xs(self) -> int:   # row of the input tile and of w1, bf16
        return self.cin_pad + 8

    @property
    def cw(self) -> int:   # row of the expanded chunk, of d and of w2, bf16
        return self.ck + 8

    @property
    def nchunks(self) -> int:
        return -(-self.ce // self.ck)

    @property
    def off_w2(self) -> int:
        return self.ck * self.xs * 2 if self.expand else 0

    @property
    def off_taps(self) -> int:
        return self.off_w2 + self.cout * self.cw * 2

    @property
    def chunk_bytes(self) -> int:
        return self.off_taps + 44 * self.ck   # taps, b1, bd: 11 float32 a channel

    @property
    def nbytes(self) -> int:
        """All chunks, then b2 (float32), padded to 16."""
        return self.nchunks * self.chunk_bytes + _round_up(4 * self.cout, 16)


def mbconv_smem_bytes(tile_h: int, tile_w: int, lay: MBConvLayout) -> int:
    """Dynamic shared memory of a block (csrc/mbconv.cu, `derive`): the
    halo'd input tile (two without an expand), the expanded chunk, d, two
    chunk buffers."""
    rows = (tile_h + 2) * (tile_w + 2) + _SPARE
    xs = rows * lay.xs * 2 * (1 if lay.expand else 2)   # two input tiles without an expand
    es = rows * lay.cw * 2 if lay.expand else 0
    return xs + es + _round_up(tile_h * tile_w, 16) * lay.cw * 2 + 2 * lay.chunk_bytes


@dataclass(frozen=True)
class MBConvPlan:
    """One launch of B3: the output tile (rows, columns), the chunk width,
    the warps of a block, each warp's project rectangle (PM M tiles by PN N
    tiles), the output channels a block computes (all of them, or a group;
    groups go along grid.y), the dynamic shared memory and the grid: along x
    as many blocks as the SMs hold at once, at most one a tile (`tiles`, of
    all images), each walking the tiles x, x + grid.x, ..."""

    tile_h: int
    tile_w: int
    ck: int
    warps: int
    pm: int
    pn: int
    cout_group: int
    smem_bytes: int
    grid: Tuple[int, int, int]
    tiles: int


def mbconv_blocks_per_sm(warps: int, pm: int, pn: int, smem_bytes: int) -> int:
    """Blocks of a plan an SM holds at once: the kernel's launch bounds and
    the shared memory."""
    return min(MBCONV_BLOCKS_PER_SM[warps, pm, pn], SM_SMEM // (smem_bytes + 1024))


def _check_kernel_dims(cin: int, ce: int, cout: int, expand: bool) -> None:
    if min(cin, ce, cout) < 8 or cin % 8 or ce % 8 or cout % 8 or cin > MAX_CIN:
        raise ValueError(f"the kernel takes channel counts that are multiples of 8 and Cin <= {MAX_CIN}, "
                         f"got Cin {cin}, Ce {ce}, Cout {cout}")
    if not expand and ce != cin:
        raise ValueError(f"without an expand Ce must equal Cin, got {ce} and {cin}")


def fused_mbconv_plans(b: int, h: int, w: int, cin: int, ce: int, cout: int,
                       expand: bool = True) -> Iterator[MBConvPlan]:
    """Every launch plan of B3 for x (b, h, w, cin) and (ce, cout) that fits:
    each tile of MBCONV_TILES (cut to the map) with each variant of
    MBCONV_VARIANTS, all output channels in one pass where the variant's
    rectangles cover them, else the fewest groups that they cover, within
    MAX_SMEM. Raises ValueError on shapes the kernel does not take."""
    if min(b, h, w) < 1:
        raise ValueError(f"empty input {(b, h, w, cin)}")
    _check_kernel_dims(cin, ce, cout, expand)
    lay = MBConvLayout(cin, ce, cout, mbconv_chunk_width(ce), expand)
    nt = cout // 8
    for th, tw in dict.fromkeys((min(th, h), min(tw, w)) for th, tw in MBCONV_TILES):
        smem = mbconv_smem_bytes(th, tw, lay)
        if smem > MAX_SMEM:
            continue
        mt = -(-th * tw // 16)   # M tiles of the tile's outputs
        tiles = b * -(-h // th) * -(-w // tw)
        # stage A's items, (halo M tile, 32 or 48 expanded channels): at most 16 a warp
        a_items = -(-(th + 2) * (tw + 2) // 16) * (2 if lay.ck == 64 else 1)
        for warps, pm, pn in MBCONV_VARIANTS:
            if expand and -(-a_items // warps) > 16:
                continue
            nmax = warps // -(-mt // pm) * pn   # N tiles the variant covers in one pass
            if nmax < 1:
                continue
            groups = -(-nt // nmax)
            cg = 8 * -(-nt // groups)
            groups = -(-cout // cg)
            if tiles > 2 ** 31 - 1 or groups > 65535:
                continue
            resident = max(1, mbconv_blocks_per_sm(warps, pm, pn, smem) * NUM_SMS // groups)
            yield MBConvPlan(th, tw, lay.ck, warps, pm, pn, cg, smem, (min(tiles, resident), groups, 1), tiles)


# the rate of an SM holding one or two blocks of a plan at once
_BLOCKS_GAIN = (1.0, 1.25)


def _mbconv_cost(lay: MBConvLayout, plan: MBConvPlan) -> float:
    """Estimated time of a plan, in warp instructions of the busiest SM. A
    chunk of a block costs its expand of the halo (mma and epilogue), its
    depthwise (150 instructions for four outputs by two channels), its
    project mma and a fixed 2,000 for its barriers and the latency they
    expose; a block adds the copy of its halo'd tile. An SM runs its share of
    the blocks, at full rate once 16 warps are resident (blocks an SM: the
    launch bounds and the shared memory), and faster by _BLOCKS_GAIN with two
    blocks at once, whose stages fill each other's waits at their barriers
    (fitted to `kernels/sweep_b3.py` on the default model's blocks, PERF.md
    section 6)."""
    th, tw = plan.tile_h, plan.tile_w
    npos = _round_up((th + 2) * (tw + 2), 16)
    mpad = _round_up(th * tw, 16)
    expand = 0
    if lay.expand:
        expand = (npos // 16) * (lay.ck // 8) * (lay.cin_pad // 16) * 3 + npos * lay.ck * 8 // 32
    depthwise = (lay.ck // 2) * th * -(-tw // 4) * 150 // 32
    project = (mpad // 16) * (plan.cout_group // 8) * (lay.ck // 16) * 3
    per_block = lay.nchunks * (expand + depthwise + project + 2000) + npos * lay.cin_pad // 8 * 8 // 32
    blocks = plan.tiles * plan.grid[1]
    per_sm = -(-blocks // NUM_SMS)
    fit = mbconv_blocks_per_sm(plan.warps, plan.pm, plan.pn, plan.smem_bytes)
    blocks_at_once = min(per_sm, fit)
    return per_block * per_sm * 16 / min(blocks_at_once * plan.warps, 16) / _BLOCKS_GAIN[blocks_at_once - 1]


@functools.lru_cache(maxsize=256)
def plan_fused_mbconv(b: int, h: int, w: int, cin: int, ce: int, cout: int, expand: bool = True) -> MBConvPlan:
    """B3's launch plan for x (b, h, w, cin) and (ce, cout), with or without
    the expand: of `fused_mbconv_plans`, the one `_mbconv_cost` finds
    cheapest (few halo positions and dead outputs, enough blocks to keep the
    SMs busy). Raises ValueError on shapes the kernel does not take or if no
    plan fits."""
    lay = MBConvLayout(cin, ce, cout, mbconv_chunk_width(ce), expand)
    plans = list(fused_mbconv_plans(b, h, w, cin, ce, cout, expand))
    if not plans:
        raise ValueError(f"no B3 plan fits {(b, h, w, cin, ce, cout)}, expand={expand}")
    return min(plans, key=lambda plan: _mbconv_cost(lay, plan))


@dataclass(frozen=True)
class PackedMBConv:
    """B3's weights in the kernel's layout (`pack_fused_mbconv`): `data`
    holds MBConvLayout(cin, ce, cout, ck, expand).nbytes bytes (uint8, one
    tensor)."""

    data: torch.Tensor
    cin: int
    ce: int
    cout: int
    ck: int
    expand: bool

    @property
    def layout(self) -> MBConvLayout:
        return MBConvLayout(self.cin, self.ce, self.cout, self.ck, self.expand)

    @property
    def device(self) -> torch.device:
        return self.data.device


def pack_fused_mbconv(w1, b1, wd, bd, w2, b2, device=None) -> PackedMBConv:
    """Lay the six weights of a block out once, on `device` (else wd's), in
    the kernel's layout (MBConvLayout), each rounded to bfloat16 as the
    kernel computes with them: chunk by chunk of CK expanded channels, each
    chunk the contiguous bytes of its shared-memory buffer: w1 transposed (CK
    rows of Cin, zero to XS), w2 transposed (Cout rows of CK, zero to CK + 8),
    the nine taps, b1 and bd as float32; channels past Ce are zero. Then b2
    as float32."""
    cin, ce, cout = _weight_dims(w1, b1, wd, bd, w2, b2)
    expand = w1 is not None
    _check_kernel_dims(cin, ce, cout, expand)
    dev = torch.device(device) if device is not None else wd.device
    lay = MBConvLayout(cin, ce, cout, mbconv_chunk_width(ce), expand)
    n, ck, cw = lay.nchunks, lay.ck, lay.cw
    bf = torch.bfloat16

    def r(t):
        return t.to(device=dev, dtype=bf)

    parts = []
    if expand:
        w1r = torch.zeros((n * ck, lay.xs), dtype=bf, device=dev)
        w1r[:ce, :cin] = r(w1).t()
        parts.append(w1r.view(torch.uint8).reshape(n, ck * lay.xs * 2))
    w2r = torch.zeros((cout, n, cw), dtype=bf, device=dev)
    w2t = torch.zeros((cout, n * ck), dtype=bf, device=dev)
    w2t[:, :ce] = r(w2).t()
    w2r[:, :, :ck] = w2t.reshape(cout, n, ck)
    parts.append(w2r.permute(1, 0, 2).contiguous().view(torch.uint8).reshape(n, cout * cw * 2))
    vec = torch.zeros((11, n * ck), dtype=torch.float32, device=dev)
    vec[:9, :ce] = r(wd).float().reshape(9, ce)
    if expand:
        vec[9, :ce] = r(b1).float()
    vec[10, :ce] = r(bd).float()
    parts.append(vec.reshape(11, n, ck).permute(1, 0, 2).contiguous().view(torch.uint8).reshape(n, 44 * ck))
    tail = torch.zeros(lay.nbytes - n * lay.chunk_bytes, dtype=torch.uint8, device=dev)
    tail[: 4 * cout] = r(b2).float().view(torch.uint8)
    data = torch.cat([torch.cat(parts, dim=1).reshape(-1), tail])
    return PackedMBConv(data, cin, ce, cout, ck, expand)


def unpack_fused_mbconv(packed: PackedMBConv):
    """The six weights back from `pack_fused_mbconv`, in bfloat16: (w1 (Cin,
    Ce), b1, wd (3, 3, Ce), bd, w2 (Ce, Cout), b2), w1 and b1 None without
    an expand."""
    lay, d = packed.layout, packed.data
    n, ck, cw, cin, ce, cout = lay.nchunks, lay.ck, lay.cw, lay.cin, lay.ce, lay.cout
    bf = torch.bfloat16
    chunks = d[: n * lay.chunk_bytes].reshape(n, lay.chunk_bytes)
    w1 = b1 = None
    if lay.expand:
        w1 = chunks[:, : lay.off_w2].contiguous().view(bf).reshape(n * ck, lay.xs)[:ce, :cin].t().contiguous()
    w2 = chunks[:, lay.off_w2 : lay.off_taps].contiguous().view(bf).reshape(n, cout, cw)[:, :, :ck]
    w2 = w2.permute(1, 0, 2).reshape(cout, n * ck)[:, :ce].t().contiguous()
    vec = chunks[:, lay.off_taps :].contiguous().view(torch.float32).reshape(n, 11, ck).permute(1, 0, 2)
    vec = vec.reshape(11, n * ck)[:, :ce].to(bf)
    if lay.expand:
        b1 = vec[9].contiguous()
    b2 = d[n * lay.chunk_bytes : n * lay.chunk_bytes + 4 * cout].clone().view(torch.float32).to(bf)
    return w1, b1, vec[:9].reshape(3, 3, ce).contiguous(), vec[10].contiguous(), w2, b2


# ------------------------------------------------------------------------- #
# the kernel
# ------------------------------------------------------------------------- #

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built `tcf_mbconv` entry point of csrc/mbconv.cu, typed."""
    from tpucenterface_torch.kernels import build

    fn = build.load("mbconv").tcf_mbconv
    fn.argtypes = [_P] * 3 + [_I32] * 9 + [_I32] * 8 + [_I64, _I32, _P]
    fn.restype = _I32
    return fn


def _check_x(x: torch.Tensor, cin: int, cout: int, skip: bool) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Cin), got {tuple(x.shape)}")
    if x.shape[-1] != cin:
        raise ValueError(f"x has {x.shape[-1]} channels, the packed weights {cin}")
    if skip and cin != cout:
        raise ValueError(f"the skip needs Cin == Cout, got {cin} and {cout}")


def mbconv_work(x: torch.Tensor, w1=None, b1=None, wd=None, bd=None, w2=None, b2=None, **_) -> Tuple[int, int]:
    """(operations, bytes) of one block, as the kernel table's bound counts
    them: the expand's and the project's products, the depthwise's nine
    multiply-adds an expanded value; x read once, out written once, the
    weights and biases read once (bfloat16)."""
    if isinstance(w1, PackedMBConv):
        ce, cout, expand = w1.ce, w1.cout, w1.expand
    else:
        ce, cout, expand = wd.shape[-1], w2.shape[-1], w1 is not None
    b, h, w, cin = x.shape
    pos = b * h * w
    ex = cin * ce if expand else 0
    return 2 * pos * (ex + ce * cout + 9 * ce), 2 * (pos * (cin + cout) + ex + 9 * ce + ce * cout + 2 * ce + cout)


@counts_work("mbconv", mbconv_work)
def fused_mbconv(
    x: torch.Tensor,
    w1=None,
    b1: Optional[torch.Tensor] = None,
    wd: Optional[torch.Tensor] = None,
    bd: Optional[torch.Tensor] = None,
    w2: Optional[torch.Tensor] = None,
    b2: Optional[torch.Tensor] = None,
    *,
    skip: bool,
    relu6: bool = True,
) -> torch.Tensor:
    """Fused inverted-residual block, stride 1 -> (B, H, W, Cout) in `x.dtype`.

    Takes the six weights (w1 and b1 None without an expand), packed here on
    every call, or one `PackedMBConv` in w1's place (`fused_mbconv(x, packed,
    skip=..., relu6=...)`). CUDA tensors launch `csrc/mbconv.cu` under
    `plan_fused_mbconv`'s plan (x must be contiguous bfloat16 NHWC, 16-byte
    aligned, channel counts multiples of 8, Cin <= MAX_CIN); CPU tensors take
    the plain version. `fused_mbconv.launches` counts kernel launches.
    """
    if isinstance(w1, PackedMBConv):
        if any(t is not None for t in (b1, wd, bd, w2, b2)):
            raise TypeError("a PackedMBConv takes the place of all six weights")
        packed = w1
        _check_x(x, packed.cin, packed.cout, skip)
        if packed.device != x.device:
            raise ValueError(f"the packed weights are on {packed.device}, x on {x.device}")
        if x.device.type == "cpu":
            return fused_mbconv_plain(x, *unpack_fused_mbconv(packed), skip=skip, relu6=relu6)
    else:
        _check_shapes(x, w1, b1, wd, bd, w2, b2, skip)
        if x.device.type == "cpu":
            return fused_mbconv_plain(x, w1, b1, wd, bd, w2, b2, skip=skip, relu6=relu6)
        packed = None
    if x.device.type != "cuda":
        raise ValueError(f"fused_mbconv runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bfloat16 input, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous NHWC, 16-byte aligned")
    if x.numel() == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if packed is None:
        packed = pack_fused_mbconv(w1, b1, wd, bd, w2, b2, device=x.device)
    b, h, w, cin = x.shape
    plan = plan_fused_mbconv(b, h, w, cin, packed.ce, packed.cout, packed.expand)
    out = torch.empty((b, h, w, packed.cout), dtype=x.dtype, device=x.device)
    launch_fused_mbconv(x, packed, plan, out, skip, relu6)
    fused_mbconv.launches += 1
    return out


def launch_fused_mbconv(x, packed: PackedMBConv, plan: MBConvPlan, out, skip: bool, relu6: bool) -> None:
    """Launch `csrc/mbconv.cu` with `plan` into `out`, on operands that
    `fused_mbconv` has checked (`kernels/sweep_b3.py` times every plan of
    `fused_mbconv_plans` through it); raises if the kernel refuses the plan
    or fails to launch. Counts nothing."""
    dev = x.device
    # the launch goes to the current device: enter `dev` only where it is another
    with contextlib.nullcontext() if dev.index == torch.cuda.current_device() else torch.cuda.device(dev):
        rc = _kernel()(
            x.data_ptr(), packed.data.data_ptr(), out.data_ptr(),
            *x.shape, packed.ce, packed.cout, int(packed.expand), int(skip), int(relu6),
            plan.tile_h, plan.tile_w, plan.ck, plan.warps, plan.pm, plan.pn, plan.cout_group, plan.smem_bytes,
            plan.grid[0], plan.grid[1],
            # the current stream's handle, without building a Stream object
            torch._C._cuda_getCurrentRawStream(dev.index),
        )
    if rc != 0:
        raise RuntimeError(f"mbconv kernel launch failed with CUDA error {rc}")


fused_mbconv.launches = 0
