"""Inverted-residual blocks on the row-padded planar layout: the CUDA kernels
of `csrc/planar.cu`, their plain versions and the layout helpers.

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
`x.dtype`; `planar_mbconv_chain` rounds p to bfloat16 after every block, adds
the skip from the rounded value of the block's input, and makes ONE kernel
launch for the whole chain.

A CUDA tensor launches the kernel (bfloat16 input only) or raises; a CPU
tensor takes the plain version. There is no `interpret` argument as in the
JAX functions: a CUDA kernel has no interpret mode, the plain version is what
runs without a card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, List, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from tpucenterface_torch.ops.fused_mbconv import _act, mbconv_reference

LANE = 128
# Limits of csrc/planar.cu: an input tile with its halo (up to 324 positions)
# sits in shared memory at the block's full input width next to one chunk of
# weights, which 227 KB holds up to 256 channels; the chain's block table is a
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
# the kernels
# --------------------------------------------------------------------------- #

_P, _I32 = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _kernels():
    """The built entry points of csrc/planar.cu, typed:
    (tcf_planar_mbconv, tcf_planar_chain)."""
    from tpucenterface_torch.kernels import build

    lib = build.load("planar")
    one, chain = lib.tcf_planar_mbconv, lib.tcf_planar_chain
    # x, out, pointers[6], dims[4], B, H, W, Wp, relu6, stream
    one.argtypes = [_P] * 4 + [_I32] * 5 + [_P]
    # x, out, scratch0, scratch1, pointers[6n], dims[4n], n, B, H, W, Wp, relu6, stream
    chain.argtypes = [_P] * 6 + [_I32] * 6 + [_P]
    one.restype = chain.restype = _I32
    return one, chain


class PackedBlocks(NamedTuple):
    """A chain's weights as the kernels read them, on one device: w1 (Ce, Cin)
    and w2 (Cout, Ce) in bfloat16, wd (Ce, 9) with tap dy*3+dx, b1, bd, b2 in
    float32; six pointers and (Cin, Ce, Cout, skip) per block in host arrays."""

    tensors: Tuple[Optional[torch.Tensor], ...]   # keeps the device memory alive
    pointers: Any                                  # ctypes c_void_p[6 n]
    dims: Any                                      # ctypes c_int[4 n]
    shapes: Tuple[_Shapes, ...]


def pack_planar_blocks(blocks: Sequence[Mapping[str, Any]], cin: int, device) -> PackedBlocks:
    """Check a chain of blocks ({w1, b1, wd, bd, w2, b2, skip}, tensors or
    numpy arrays) that starts at `cin` channels and lay its weights out for
    the kernels on `device`. A caller that runs the same blocks again packs
    once; the wrappers pack what they are given unpacked at every call."""
    device = torch.device(device)
    tensors: List[Optional[torch.Tensor]] = []
    shapes: List[_Shapes] = []
    dims: List[int] = []
    c = cin
    for blk in blocks:
        w1, b1, wd, bd, w2, b2, skip = (
            torch.as_tensor(a) if a is not None and not isinstance(a, bool) else a for a in _block_tuple(blk)
        )
        sh = _block_shapes(c, w1, b1, wd, bd, w2, b2, skip)
        if sh.cin > MAX_CIN:
            raise ValueError(f"the planar kernels take at most {MAX_CIN} input channels a block, got {sh.cin}")

        def on(t, dtype):
            return t.to(device=device, dtype=dtype).contiguous()

        tensors += [
            None if w1 is None else on(w1.reshape(sh.cin, sh.ce).t(), torch.bfloat16),
            None if w1 is None else on(b1.reshape(sh.ce), torch.float32),
            on(wd.reshape(9, sh.ce).t(), torch.float32),
            on(bd.reshape(sh.ce), torch.float32),
            on(w2.reshape(sh.ce, sh.cout).t(), torch.bfloat16),
            on(b2.reshape(sh.cout), torch.float32),
        ]
        shapes.append(sh)
        dims += [sh.cin, sh.ce, sh.cout, int(skip)]
        c = sh.cout
    if not 1 <= len(shapes) <= MAX_CHAIN:
        raise ValueError(f"a chain has 1 to {MAX_CHAIN} blocks, got {len(shapes)}")
    pointers = (_P * len(tensors))(*[None if t is None else t.data_ptr() for t in tensors])
    return PackedBlocks(tuple(tensors), pointers, (_I32 * len(dims))(*dims), tuple(shapes))


def _check_cuda_input(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the {what} kernel takes bfloat16 input, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous planar (B, C, H*Wp)")
    if x.numel() == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")


def _check_packed_for(packed: PackedBlocks, x: torch.Tensor) -> None:
    if packed.tensors[-1].device != x.device or packed.shapes[0].cin != x.shape[1]:
        raise ValueError(
            f"the blocks were packed for {packed.shapes[0].cin} channels on {packed.tensors[-1].device}, "
            f"x has {x.shape[1]} on {x.device}"
        )


def planar_mbconv(
    x: torch.Tensor,
    w1: Union[Optional[torch.Tensor], PackedBlocks],
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
    x (B, Cin, H*Wp) -> (B, Cout, H*Wp) in `x.dtype`, summed in float32.

    The block is its six weights and `skip`, as in the JAX function, or, in
    the place of `w1`, the `PackedBlocks` of one block (then `skip` is the
    packed one's). CUDA tensors launch `tcf_planar_mbconv` of csrc/planar.cu
    (bfloat16 input, Cin <= MAX_CIN); CPU tensors take `planar_mbconv_plain`.
    A skip needs an expand, as in the JAX function. `planar_mbconv.launches`
    counts kernel launches. No `interpret` argument: see the module docstring.
    """
    wp = _check_planar(x, H, W)
    packed = w1 if isinstance(w1, PackedBlocks) else None
    if packed is None:
        if wd is None or bd is None or w2 is None or b2 is None or skip is None:
            raise TypeError("planar_mbconv takes w1, b1, wd, bd, w2, b2 and skip, or the PackedBlocks of one block")
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
        packed = pack_planar_blocks([blk], x.shape[1], x.device)
    _check_packed_for(packed, x)
    if len(packed.shapes) != 1 or (packed.dims[3] and packed.tensors[0] is None):
        raise ValueError("planar_mbconv takes one block, and no skip without an expand")
    out = torch.empty((x.shape[0], packed.shapes[0].cout, H * wp), dtype=torch.float32, device=x.device)
    fn, _ = _kernels()
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), out.data_ptr(), packed.pointers, packed.dims,
            x.shape[0], H, W, wp, int(relu6),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"planar block kernel launch failed with CUDA error {rc}")
    planar_mbconv.launches += 1
    return out.to(x.dtype)


planar_mbconv.launches = 0


def planar_mbconv_chain(
    x: torch.Tensor,
    blocks: Union[Sequence[Mapping[str, Any]], PackedBlocks],
    *,
    H: int,
    W: int,
    relu6: bool = True,
) -> torch.Tensor:
    """N consecutive stride-1 inverted-residual blocks in ONE kernel launch:
    x (B, C0, H*Wp) -> (B, C_last, H*Wp) bfloat16.

    `blocks` is a sequence of dicts {w1, b1, wd, bd, w2, b2, skip} (w1 and b1
    None without an expand) or the `PackedBlocks` of one. CUDA tensors launch
    `tcf_planar_chain` of csrc/planar.cu once, whatever N is (bfloat16 input,
    N <= MAX_CHAIN, Cin <= MAX_CIN in every block); CPU tensors take
    `planar_mbconv_chain_plain`. `planar_mbconv_chain.launches` counts kernel
    launches. No `interpret` argument: see the module docstring.
    """
    wp = _check_planar(x, H, W)
    if x.device.type == "cpu":
        if isinstance(blocks, PackedBlocks):
            raise ValueError("packed blocks are for the kernel; pass the blocks' dicts on the CPU")
        return planar_mbconv_chain_plain(x, blocks, H=H, W=W, relu6=relu6)
    if x.device.type != "cuda":
        raise ValueError(f"planar_mbconv_chain runs on cuda or cpu, not {x.device}")
    _check_cuda_input(x, "planar chain")
    packed = blocks if isinstance(blocks, PackedBlocks) else pack_planar_blocks(blocks, x.shape[1], x.device)
    _check_packed_for(packed, x)
    b, n = x.shape[0], len(packed.shapes)
    out = torch.empty((b, packed.shapes[-1].cout, H * wp), dtype=torch.bfloat16, device=x.device)
    # the blocks' outputs between the first and the last go through two
    # buffers in turn, wide enough for the widest of them
    scratch = [None, None]
    if n > 1:
        widest = max(sh.cout for sh in packed.shapes[:-1])
        scratch = [torch.empty((b, widest, H * wp), dtype=torch.bfloat16, device=x.device) for _ in range(min(n - 1, 2))]
        scratch += [None] * (2 - len(scratch))
    _, fn = _kernels()
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), out.data_ptr(),
            *(None if s is None else s.data_ptr() for s in scratch),
            packed.pointers, packed.dims, n,
            b, H, W, wp, int(relu6),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"planar chain kernel launch failed with CUDA error {rc}")
    planar_mbconv_chain.launches += 1
    return out


planar_mbconv_chain.launches = 0
