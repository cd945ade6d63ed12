"""The port's planar MBConv functions against the JAX package's.

`planar_mbconv_plain` and `planar_mbconv_chain_plain` (the plain versions the
CUDA kernels of `csrc/planar_chain.cu` are held against on the card) are compared
with the Pallas kernels `planar_mbconv` and `planar_mbconv_chain` in interpret
mode, as tests/test_planar_mbconv.py runs them. Inputs come from numpy with a
seed; pad columns of the input hold garbage. Only real columns are compared:
pad columns of an output are unspecified.

Tolerances. Both sides round at the same points (bfloat16 operands of the two
products, float32 sums, bfloat16 after the expand and after the depthwise,
float32 b1/wd/bd/b2, products of the depthwise rounded before they are
added), so they differ only where another float32 summation order lands a
value on the other side of a bfloat16 rounding boundary: one bfloat16 step of
an intermediate, carried to the output. Measured on the CPU on the cases
below: bit-equal for bfloat16 input (single blocks and chains), and at most
5e-7 for float32 input (the project's float32 sum is not rounded there).
Nothing guarantees either side's summation order, so the bounds are
- bfloat16 results: one bfloat16 step, atol 0.02 + rtol 2^-7, on at most 0.2%
  of the values (the bound tests/test_torch_mbconv.py states for the NHWC
  kernel's plain version);
- float32 results of one block: atol 1e-5 on 99.8% of the values and the same
  one-step bound on the rest (a flipped bfloat16 intermediate).
Both are far tighter than the JAX test's kernel-against-float32 bound
(atol 3e-2, rtol 3e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucenterface.ops import planar_mbconv as J
from tpucenterface_torch.ops import planar_mbconv as T
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

ATOL, RTOL, MAX_DIFFERING = 0.02, 2.0 ** -7, 0.002
F32_ATOL = 1e-5


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _planar_input(rng, b, c, h, w, garbage=True):
    """(B, C, H*Wp) float32 numpy: 0.5 * randn in the real columns, garbage
    (or zeros) in the pad columns."""
    wp = J.padded_width(h, w)
    x = np.zeros((b, c, h, wp), np.float32)
    x[..., :w] = rng.randn(b, c, h, w) * 0.5
    if garbage:
        x[..., w:] = rng.randn(b, c, h, wp - w) * 7.0
    return x.reshape(b, c, h * wp)


def _block(rng, c, e, cout, b1_shift=0.0):
    """HWIO weights as the JAX functions take them; no expand when e == c."""
    expand = e != c
    return {
        "w1": (rng.randn(1, 1, c, e) * 0.2).astype(np.float32) if expand else None,
        "b1": (rng.randn(e) * 0.1 + b1_shift).astype(np.float32) if expand else None,
        "wd": (rng.randn(3, 3, 1, e) * 0.3).astype(np.float32),
        "bd": (rng.randn(e) * 0.1).astype(np.float32),
        "w2": (rng.randn(1, 1, e, cout) * 0.2).astype(np.float32),
        "b2": (rng.randn(cout) * 0.1).astype(np.float32),
    }


_KEYS = ("w1", "b1", "wd", "bd", "w2", "b2")


def _real(planar, h, w, nhwc_from_planar):
    return np.asarray(nhwc_from_planar(planar, h, w), np.float32)


def _assert_close(got, want, f32=False):
    diff = np.abs(got - want)
    loose = ATOL + RTOL * np.abs(want)
    assert (diff <= loose).all(), float(diff.max())
    tight = diff <= F32_ATOL if f32 else diff == 0
    assert 1.0 - tight.mean() <= MAX_DIFFERING, float(1.0 - tight.mean())


# --------------------------------------------------------------------------- #
# (a) layout
# --------------------------------------------------------------------------- #

GRID = [(h, w) for h in (1, 3, 5, 8, 10, 16, 20, 23, 40, 64, 80) for w in (1, 6, 10, 16, 20, 37, 40, 80, 126)]


@pytest.mark.parametrize("h,w", GRID)
def test_padded_width_equals_jax(h, w):
    wp = T.padded_width(h, w)
    assert wp == J.padded_width(h, w)
    assert wp >= w + 2 and (h * wp) % 128 == 0


@pytest.mark.parametrize("h,w", [(5, 6), (10, 10), (8, 16), (23, 37), (1, 1)])
def test_layout_helpers_equal_jax(h, w):
    rng = np.random.RandomState(h * 100 + w)
    x = rng.randn(2, h, w, 3).astype(np.float32)
    p = T.planar_from_nhwc(torch.from_numpy(x))
    wp = T.padded_width(h, w)
    assert tuple(p.shape) == (2, 3, h * wp)
    np.testing.assert_array_equal(p.numpy(), np.asarray(J.planar_from_nhwc(jnp.asarray(x))))
    np.testing.assert_array_equal(p.numpy().reshape(2, 3, h, wp)[..., w:], 0.0)
    back = T.nhwc_from_planar(p, h, w)
    np.testing.assert_array_equal(back.numpy(), x)
    g = _planar_input(rng, 2, 3, h, w)
    np.testing.assert_array_equal(
        T.nhwc_from_planar(torch.from_numpy(g), h, w).numpy(), np.asarray(J.nhwc_from_planar(jnp.asarray(g), h, w))
    )


# --------------------------------------------------------------------------- #
# (b) one block
# --------------------------------------------------------------------------- #

BLOCKS = [
    # b, c, e, cout, h, w, skip: the shapes of tests/test_planar_mbconv.py
    (2, 24, 144, 24, 16, 16, True),
    (1, 32, 32, 16, 8, 16, False),
    (2, 16, 96, 24, 8, 16, False),
    (1, 8, 48, 8, 10, 6, True),
]


@pytest.mark.parametrize("relu6", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,c,e,cout,h,w,skip", BLOCKS)
def test_block_plain_matches_pallas_interpret(b, c, e, cout, h, w, skip, dtype, relu6):
    rng = np.random.RandomState(c * 1000 + e)
    x = _planar_input(rng, b, c, h, w)
    blk = _block(rng, c, e, cout)
    xj, xt = jnp.asarray(x).astype(getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))
    want = J.planar_mbconv(xj, *[_j(blk[k]) for k in _KEYS], H=h, W=w, skip=skip, relu6=relu6, interpret=True)
    got = T.planar_mbconv_plain(xt, *[_t(blk[k]) for k in _KEYS], H=h, W=w, skip=skip, relu6=relu6)
    assert got.dtype == xt.dtype and str(want.dtype) == dtype
    assert tuple(got.shape) == tuple(want.shape) == (b, cout, h * T.padded_width(h, w))
    _assert_close(
        T.nhwc_from_planar(got, h, w).float().numpy(), _real(want.astype(jnp.float32), h, w, J.nhwc_from_planar),
        f32=dtype == "float32",
    )


@pytest.mark.parametrize("relu6", [True, False])
def test_block_pad_positions_are_zero_after_the_expand(relu6):
    """With b1 = +3, act(b1) at the pad columns and above and below the image
    would leak into the border's depthwise taps. The Pallas kernel masks the
    pad columns and pads the rows with zeros; so must the plain version. A
    version that leaves act(b1) outside the image is far off on the border."""
    rng = np.random.RandomState(3)
    b, c, e, cout, h, w = 1, 16, 96, 24, 8, 12
    x = _planar_input(rng, b, c, h, w)
    blk = _block(rng, c, e, cout, b1_shift=3.0)
    xb = torch.from_numpy(x).bfloat16()
    want = _real(
        J.planar_mbconv(jnp.asarray(x).astype(jnp.bfloat16), *[_j(blk[k]) for k in _KEYS], H=h, W=w, skip=False,
                        relu6=relu6, interpret=True).astype(jnp.float32), h, w, J.nhwc_from_planar)
    got = T.nhwc_from_planar(
        T.planar_mbconv_plain(xb, *[_t(blk[k]) for k in _KEYS], H=h, W=w, skip=False, relu6=relu6), h, w
    ).float().numpy()
    _assert_close(got, want)
    # the wrong version: the block on the image zero-padded by two, cropped
    xn = T.nhwc_from_planar(xb, h, w)
    xp = T.planar_from_nhwc(torch.nn.functional.pad(xn, (0, 0, 2, 2, 2, 2)))
    wrong = T.nhwc_from_planar(
        T.planar_mbconv_plain(xp, *[_t(blk[k]) for k in _KEYS], H=h + 4, W=w + 4, skip=False, relu6=relu6), h + 4, w + 4
    )[:, 2:-2, 2:-2].float().numpy()
    assert np.abs(wrong - want)[:, [0, -1]].max() > 1.0
    assert (np.abs(wrong - want)[:, 2:-2, 2:-2] <= ATOL + RTOL * np.abs(want[:, 2:-2, 2:-2])).all()


def test_float32_input_is_not_rounded_before_the_expand():
    """What the JAX function does with float32 input in interpret mode, pinned:
    the bfloat16 w1 meets the unrounded x (and the skip adds the unrounded x),
    so the result differs from the one on x rounded to bfloat16 first."""
    rng = np.random.RandomState(4)
    b, c, e, cout, h, w = 1, 8, 48, 8, 10, 6
    x = _planar_input(rng, b, c, h, w)
    blk = _block(rng, c, e, cout)
    args_t, args_j = [_t(blk[k]) for k in _KEYS], [_j(blk[k]) for k in _KEYS]
    want = _real(J.planar_mbconv(jnp.asarray(x), *args_j, H=h, W=w, skip=True, interpret=True), h, w, J.nhwc_from_planar)
    got = T.nhwc_from_planar(T.planar_mbconv_plain(torch.from_numpy(x), *args_t, H=h, W=w, skip=True), h, w).numpy()
    rounded = T.nhwc_from_planar(
        T.planar_mbconv_plain(torch.from_numpy(x).bfloat16().float(), *args_t, H=h, W=w, skip=True), h, w).numpy()
    assert np.abs(got - want).max() <= F32_ATOL
    assert np.abs(rounded - want).max() > 100 * F32_ATOL


def test_block_plain_is_near_the_f32_reference():
    """The JAX test's own bound (atol 3e-2, rtol 3e-2) of the kernel against
    the float32 reference, for the plain version against the port's."""
    rng = np.random.RandomState(5)
    b, c, e, cout, h, w = 2, 24, 144, 24, 16, 16
    x = torch.from_numpy(_planar_input(rng, b, c, h, w, garbage=False))
    args = [_t(v) for v in (_block(rng, c, e, cout)[k] for k in _KEYS)]
    got = T.nhwc_from_planar(T.planar_mbconv_plain(x, *args, H=h, W=w, skip=True), h, w).numpy()
    ref = T.nhwc_from_planar(T.mbconv_reference_planar(x, *args, H=h, W=w, skip=True), h, w).numpy()
    np.testing.assert_allclose(got, ref, atol=3e-2, rtol=3e-2)
    jref = J.mbconv_reference_planar(jnp.asarray(x.numpy()), *[_j(a.numpy()) for a in args], H=h, W=w, skip=True)
    np.testing.assert_allclose(ref, _real(jref, h, w, J.nhwc_from_planar), atol=1e-4, rtol=0)


# --------------------------------------------------------------------------- #
# (c) chains
# --------------------------------------------------------------------------- #

CHAINS = {
    # name: (b, c0, h, w, [(e, cout), ...]); no expand where e == c, skip where cout == c
    "one": (2, 16, 8, 16, [(96, 16)]),
    "one-no-expand": (1, 32, 8, 16, [(32, 16)]),
    "two": (2, 16, 10, 6, [(96, 16), (96, 24)]),
    "six-mixed": (1, 16, 8, 8, [(16, 8), (48, 8), (48, 8), (48, 16), (96, 16), (96, 24)]),
    "no-expand-skip": (1, 8, 5, 7, [(8, 8), (48, 8)]),
}


def _chain(rng, c0, spec, b1_shift_at=None):
    blocks, c = [], c0
    for i, (e, cout) in enumerate(spec):
        blk = _block(rng, c, e, cout, b1_shift=3.0 if i == b1_shift_at else 0.0)
        blk["skip"] = c == cout
        blocks.append(blk)
        c = cout
    return blocks


def _both(blocks):
    tb = [{k: (v if k == "skip" else _t(v)) for k, v in blk.items()} for blk in blocks]
    jb = [{k: (v if k == "skip" else _j(v)) for k, v in blk.items()} for blk in blocks]
    return tb, jb


@pytest.mark.parametrize("relu6", [True, False])
@pytest.mark.parametrize("name", list(CHAINS))
def test_chain_plain_matches_pallas_interpret(name, relu6):
    b, c0, h, w, spec = CHAINS[name]
    rng = np.random.RandomState(len(spec) * 10 + c0)
    x = _planar_input(rng, b, c0, h, w)
    tb, jb = _both(_chain(rng, c0, spec, b1_shift_at=1))
    want = J.planar_mbconv_chain(jnp.asarray(x).astype(jnp.bfloat16), jb, H=h, W=w, relu6=relu6, interpret=True)
    got = T.planar_mbconv_chain_plain(torch.from_numpy(x).bfloat16(), tb, H=h, W=w, relu6=relu6)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert tuple(got.shape) == tuple(want.shape) == (b, spec[-1][1], h * T.padded_width(h, w))
    _assert_close(
        T.nhwc_from_planar(got, h, w).float().numpy(), _real(want.astype(jnp.float32), h, w, J.nhwc_from_planar)
    )


def test_chain_of_float32_input_returns_bfloat16_like_jax():
    b, c0, h, w, spec = CHAINS["two"]
    rng = np.random.RandomState(6)
    x = _planar_input(rng, b, c0, h, w)
    tb, jb = _both(_chain(rng, c0, spec))
    want = J.planar_mbconv_chain(jnp.asarray(x), jb, H=h, W=w, interpret=True)
    got = T.planar_mbconv_chain_plain(torch.from_numpy(x), tb, H=h, W=w)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _assert_close(
        T.nhwc_from_planar(got, h, w).float().numpy(), _real(want.astype(jnp.float32), h, w, J.nhwc_from_planar)
    )


def test_chain_rounds_after_every_block():
    """The chain is not the one-block function applied N times in float32:
    every block's output is rounded to bfloat16 and the skip adds the rounded
    value. A chain of one equals the one-block result rounded once."""
    b, c0, h, w, spec = CHAINS["six-mixed"]
    rng = np.random.RandomState(7)
    x = torch.from_numpy(_planar_input(rng, b, c0, h, w)).bfloat16()
    tb, _ = _both(_chain(rng, c0, spec))
    got = T.planar_mbconv_chain_plain(x, tb, H=h, W=w)
    v = x
    # the one-block function has no skip without an expand; this chain has no such block
    assert not any(blk["skip"] and blk["w1"] is None for blk in tb)
    for blk in tb:
        v = T.planar_mbconv_plain(v, *[blk[k] for k in _KEYS], H=h, W=w, skip=blk["skip"])
    assert torch.equal(got, v)  # bfloat16 in, so each one-block call rounds once too


# --------------------------------------------------------------------------- #
# the wrappers
# --------------------------------------------------------------------------- #


def test_wrappers_on_cpu_are_the_plain_versions_and_count_no_launch():
    b, c0, h, w, spec = CHAINS["two"]
    rng = np.random.RandomState(8)
    x = torch.from_numpy(_planar_input(rng, b, c0, h, w)).bfloat16()
    tb, _ = _both(_chain(rng, c0, spec))
    before = T.planar_mbconv.launches, T.planar_mbconv_chain.launches
    args = [tb[0][k] for k in _KEYS]
    assert torch.equal(
        T.planar_mbconv(x, *args, H=h, W=w, skip=True), T.planar_mbconv_plain(x, *args, H=h, W=w, skip=True)
    )
    assert torch.equal(T.planar_mbconv_chain(x, tb, H=h, W=w), T.planar_mbconv_chain_plain(x, tb, H=h, W=w))
    assert (T.planar_mbconv.launches, T.planar_mbconv_chain.launches) == before
    # the port's own weight layout ((Cin, Ce), (3, 3, Ce), (Ce, Cout)) gives the same
    flat = [a if a is None else a.reshape(a.shape[-2:] if a.dim() == 4 and a.shape[0] == 1 else
                                           ((3, 3, a.shape[-1]) if a.dim() == 4 else a.shape)) for a in args]
    assert torch.equal(
        T.planar_mbconv(x, *flat, H=h, W=w, skip=True), T.planar_mbconv_plain(x, *args, H=h, W=w, skip=True)
    )


def test_wrappers_reject_what_they_cannot_run():
    rng = np.random.RandomState(9)
    h, w = 8, 16
    x = torch.from_numpy(_planar_input(rng, 1, 16, h, w)).bfloat16()
    blk = {k: (_t(v)) for k, v in _block(rng, 16, 96, 24).items()}
    args = [blk[k] for k in _KEYS]
    with pytest.raises(ValueError, match="skip needs"):
        T.planar_mbconv(x, *args, H=h, W=w, skip=True)                      # Cin != Cout
    with pytest.raises(ValueError, match="without an expand"):
        T.planar_mbconv(x, None, None, *args[2:], H=h, W=w, skip=False)     # Ce != Cin
    noexp = {k: _t(v) for k, v in _block(rng, 16, 16, 16).items()}
    with pytest.raises(ValueError, match="skip without an expand"):
        T.planar_mbconv(x, *[noexp[k] for k in _KEYS], H=h, W=w, skip=True)  # as the JAX function asserts
    with pytest.raises(ValueError, match="columns"):
        T.planar_mbconv(x, *args, H=h + 1, W=w, skip=False)                 # not H*Wp wide
    with pytest.raises(ValueError, match="planar"):
        T.planar_mbconv_chain(x[0], [dict(blk, skip=False)], H=h, W=w)
    with pytest.raises(ValueError, match="at least one"):
        T.planar_mbconv_chain(x, [], H=h, W=w)
    with pytest.raises(ValueError, match="w1 must be"):
        T.planar_mbconv_chain(x, [dict(blk, skip=False), dict(blk, skip=False)], H=h, W=w)  # 24 into 16
    # the kernel's limits, checked where the weights are laid out for it
    with pytest.raises(ValueError, match="1 to 16 blocks"):
        T.pack_planar_chain([dict(noexp, skip=True)] * 17, 16, "cpu")
    wide = {k: _t(v) for k, v in _block(rng, 264, 264, 8).items()}
    with pytest.raises(ValueError, match="at most 256 input channels"):
        T.pack_planar_chain([dict(wide, skip=False)], 264, "cpu")


def test_packed_blocks_hold_the_kernels_layout():
    """The one-block kernel takes one block packed as the chain kernel packs
    it (`pack_planar_chain`, ChainLayout): each chunk of 32 expanded channels
    holds w1 (expanded channel major, rows padded to cin_pad + 8) and w2
    (output channel major, rows of 40) in bfloat16, then the nine taps (tap
    dy*3+dx), b1 and bd in float32; b2 follows the chunks; values carried
    one by one."""
    rng = np.random.RandomState(10)
    c, e, cout = 8, 48, 16
    blk = _block(rng, c, e, cout)
    packed = T.pack_planar_chain([dict({k: _t(v) for k, v in blk.items()}, skip=False)], c, "cpu")
    lay = T.ChainLayout(packed.shapes[0])
    assert packed.shapes == (T.ChainShape(c, e, cout, True),) and packed.skips == (False,)
    assert packed.data.dtype == torch.uint8 and packed.data.numel() == lay.nbytes
    chunks = packed.data[: lay.nchunks * lay.chunk_bytes].reshape(lay.nchunks, lay.chunk_bytes)

    def part(lo, hi, dtype, *shape):
        return chunks[:, lo:hi].contiguous().view(dtype).reshape(lay.nchunks, *shape)

    w1 = part(0, lay.off_w2, torch.bfloat16, T.CHAIN_CK, lay.xw)
    w2 = part(lay.off_w2, lay.off_taps, torch.bfloat16, lay.n2, lay.w2s)
    taps = part(lay.off_taps, lay.off_b1, torch.float32, 9, T.CHAIN_CK)
    b1 = part(lay.off_b1, lay.off_bd, torch.float32, T.CHAIN_CK)
    for i in range(c):
        for o in range(0, e, 7):
            assert w1[o // 32, o % 32, i].item() == torch.tensor(blk["w1"][0, 0, i, o]).bfloat16().item()
    for i in range(0, e, 5):
        for o in range(cout):
            assert w2[i // 32, o, i % 32].item() == torch.tensor(blk["w2"][0, 0, i, o]).bfloat16().item()
    for dy in range(3):
        for dx in range(3):
            np.testing.assert_array_equal(taps[:, dy * 3 + dx].reshape(-1)[:e].numpy(), blk["wd"][dy, dx, 0])
    np.testing.assert_array_equal(b1.reshape(-1)[:e].numpy(), blk["b1"])
    b2 = packed.data[lay.nchunks * lay.chunk_bytes:][: 4 * cout].view(torch.float32)
    np.testing.assert_array_equal(b2.numpy(), blk["b2"])


def test_one_block_takes_packed_blocks_only_for_the_kernel():
    """`planar_mbconv` takes the `PackedChain` of one block in the place of
    its weights, for the kernel: a CPU tensor raises, as in the chain wrapper,
    and so does a call with neither the weights nor a packed block."""
    rng = np.random.RandomState(11)
    h, w = 8, 16
    x = torch.from_numpy(_planar_input(rng, 1, 16, h, w)).bfloat16()
    blk = dict({k: _t(v) for k, v in _block(rng, 16, 96, 16).items()}, skip=True)
    packed = T.pack_planar_chain([blk], 16, "cpu")
    assert packed.shapes == (T.ChainShape(16, 96, 16, True),) and packed.skips == (True,)
    with pytest.raises(ValueError, match="packed blocks are for the kernel"):
        T.planar_mbconv(x, packed, H=h, W=w)
    with pytest.raises(ValueError, match="packed blocks are for the kernel"):
        T.planar_mbconv_chain(x, packed, H=h, W=w)
    with pytest.raises(TypeError, match="or the PackedChain of one block"):
        T.planar_mbconv(x, blk["w1"], blk["b1"], H=h, W=w, skip=True)
    with pytest.raises(TypeError, match="or the PackedChain of one block"):
        T.planar_mbconv(x, *[blk[k] for k in _KEYS], H=h, W=w)              # no `skip`
