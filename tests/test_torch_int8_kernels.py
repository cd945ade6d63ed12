"""The int8 kernels' plain versions (B5, B6, B7) and the library int8 convs of
the port against the JAX package.

- B5 `ops.int8_conv.conv1x1_int8_plain` against the Pallas kernel
  `bench/probe_int8_conv.py::make_pallas_conv1x1_int8` in interpret mode and
  its `xla_fn` arithmetic, at the shapes of tests/test_probe_int8_conv.py;
- B6 `ops.int8_block.fused_block_int8_plain(_planar)` against
  `make_fused_block_kernel` (interpret mode), `fused_block_ref` and the NHWC
  conv chain `xla_nhwc_chain`, at tests/test_probe_fused_block.py's shapes,
  and on ragged maps against the chain;
- B7 `fused_block_s1_plain(_planar)` against `make_fused_block_s1_kernel`
  (interpret mode), `fused_block_s1_ref` and `xla_nhwc_chain_s1`;
- tie-heavy operands (scales of powers of two and small integers, so scaled
  values land on .5) pin round half to even;
- the NHWC and JAX-layout entry points of each plain version agree, and the
  wrappers take the plain versions for CPU tensors;
- `quant.int8_ops` against int64 numpy sums, padding cases included;
- B7's launch plan (`plan_int8_block_s1`) covers every output position once
  and splits the project over the warps, within the card's limits, at the
  flagship's blocks, at `chip_smoke.py`'s shapes and on a hypothesis grid;
  its packed operands unpack to the JAX ones with zero padding, and the
  packed depthwise tap words give the depthwise sums.

All of it is integer-exact up to float32 epilogues that both sides round
alike, so every comparison is bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke

from tpucenterface.bench.probe_fused_block import (
    fused_block_ref,
    fused_block_s1_ref,
    make_fused_block_kernel,
    make_fused_block_s1_kernel,
    make_params,
    pad_bands,
    xla_nhwc_chain,
    xla_nhwc_chain_s1,
)
from tpucenterface.bench.probe_fused_block import nhwc_to_parity_planar as jax_parity_planar
from tpucenterface.bench.probe_int8_conv import make_pallas_conv1x1_int8
from tpucenterface_torch.ops.int8_block import (
    fused_block_int8_plain,
    fused_block_int8_plain_planar,
    fused_block_s1_plain,
    fused_block_s1_plain_planar,
    int8_block_s1,
    int8_block_s2,
    MAX_SMEM,
    S1_VARIANTS,
    s1_plans,
    S1Layout,
    nhwc_to_parity_planar,
    pack_int8_block_s1,
    plan_int8_block_s1,
    s1_chunk_width,
    s1_smem_bytes,
    unpack_int8_block_s1,
    nhwc_to_planar,
    parity_planar_to_nhwc,
    planar_to_nhwc,
)
from tpucenterface_torch.ops.int8_conv import conv1x1_int8_plain, int8_conv1x1
from tpucenterface_torch.quant.int8_ops import _mm, conv1x1_int8, conv3x3_int8, dwconv3x3_int8
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

KEYS = ("we", "e_scale", "e_bias", "e_inv_sdw", "wd", "d_scale", "d_bias", "d_inv_sproj", "wp", "p_scale", "p_bias")


def _t(a):
    return torch.from_numpy(np.array(a))


def _tie_params(cin, cmid, cout, seed):
    """Block operands whose epilogues land on .5 often: small integer
    weights, power-of-two scales, zero biases (see the module docstring)."""
    rng = np.random.RandomState(seed)
    col = lambda v, n: np.full((n, 1), v, np.float32)  # noqa: E731
    return dict(
        we=rng.randint(-3, 4, (cmid, cin)).astype(np.int8),
        e_scale=col(2.0 ** -6, cmid), e_bias=col(0.0, cmid), e_inv_sdw=col(32.0, cmid),
        wd=rng.randint(-3, 4, (9, cmid)).astype(np.float32),
        d_scale=col(2.0 ** -8, cmid), d_bias=col(0.0, cmid), d_inv_sproj=col(128.0, cmid),
        wp=rng.randint(-3, 4, (cout, cmid)).astype(np.int8),
        p_scale=col(0.5, cout), p_bias=col(0.0, cout),
    )


# --------------------------------------------------------------------------- #
# B5
# --------------------------------------------------------------------------- #

B5_B, B5_CIN, B5_COUT, B5_NPIX, B5_PBLK = 2, 32, 32, 512, 256


def _b5_case(tie):
    rng = np.random.RandomState(0)
    if tie:
        x = rng.randint(-3, 4, (B5_B, B5_CIN, B5_NPIX)).astype(np.int8)
        w = rng.randint(-3, 4, (B5_COUT, B5_CIN)).astype(np.int8)
        scale = np.full((B5_COUT, 1), 0.5, np.float32)
        bias = np.full((B5_COUT, 1), 0.5, np.float32)
    else:
        x = rng.randint(-127, 128, (B5_B, B5_CIN, B5_NPIX), np.int8)
        w = rng.randint(-127, 128, (B5_COUT, B5_CIN), np.int8)
        scale = rng.rand(B5_COUT, 1).astype(np.float32) * 1e-2
        bias = rng.rand(B5_COUT, 1).astype(np.float32)
    return x, w, scale, bias


@pytest.mark.parametrize("tie", [False, True], ids=["random", "ties"])
def test_b5_plain_matches_pallas_kernel(tie):
    x, w, scale, bias = _b5_case(tie)
    fn = make_pallas_conv1x1_int8(B5_B, B5_CIN, B5_COUT, B5_NPIX, B5_PBLK, interpret=True)
    ref = np.asarray(fn(jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(x)))
    got = conv1x1_int8_plain(_t(x), _t(w), _t(scale), _t(bias)).numpy()
    np.testing.assert_array_equal(got, ref)
    if tie:  # half the sums are odd: those land on .5 and round to even
        acc = np.einsum("oc,bcp->bop", w.astype(np.int64), x.astype(np.int64))
        assert (acc % 2 == 0).mean() > 0.3
        np.testing.assert_array_equal(got, np.clip(np.round(acc * 0.5 + 0.5), -127, 127))


def test_b5_xla_fn_arithmetic_and_wrapper():
    """The probe's `xla_fn` (float32 dot, scale, bias, round, clip) written
    in jnp on ragged logical shapes (Cout 16, P not a multiple of any tile);
    the wrapper takes the plain version on the CPU and counts no launch."""
    rng = np.random.RandomState(3)
    x = rng.randint(-127, 128, (3, 24, 1001), np.int8)
    w = rng.randint(-127, 128, (16, 24), np.int8)
    scale = rng.rand(16).astype(np.float32) * 1e-3
    bias = (rng.rand(16).astype(np.float32) - 0.5) * 4
    acc = jax.lax.dot_general(jnp.asarray(w), jnp.asarray(x), (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * jnp.asarray(scale)[:, None, None] + jnp.asarray(bias)[:, None, None]
    ref = np.asarray(jnp.clip(jnp.round(y), -127.0, 127.0).astype(jnp.int8).transpose(1, 0, 2))
    before = int8_conv1x1.launches
    got = int8_conv1x1(_t(x), _t(w), _t(scale), _t(bias)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert int8_conv1x1.launches == before


# --------------------------------------------------------------------------- #
# B6
# --------------------------------------------------------------------------- #

B6_B, B6_HWIN, B6_CIN, B6_CMID, B6_COUT = 2, 32, 8, 24, 32
B6_HW_OUT, B6_ROW_BAND = B6_HWIN // 2, 4


def _b6_case(tie, b=B6_B, h=B6_HWIN, w=B6_HWIN):
    prm = _tie_params(B6_CIN, B6_CMID, B6_COUT, seed=4) if tie else make_params(B6_CIN, B6_CMID, B6_COUT, seed=3)
    rng = np.random.RandomState(1)
    lo, hi = (-3, 4) if tie else (-127, 128)
    x = rng.randint(lo, hi, (b, h, w, B6_CIN)).astype(np.int8)
    return prm, x


def _chain_args(prm, cin, cmid, cout):
    """The NHWC conv chain's weight operands (HWIO kernels, broadcast rows)."""
    we = jnp.asarray(prm["we"]).T.reshape(1, 1, cin, cmid)
    wd = jnp.asarray(prm["wd"].reshape(3, 3, 1, cmid).astype(np.int8))
    wp = jnp.asarray(prm["wp"]).T.reshape(1, 1, cmid, cout)
    bc = lambda v: jnp.asarray(v.reshape(1, 1, 1, -1))  # noqa: E731
    return (we, bc(prm["e_scale"]), bc(prm["e_bias"]), bc(prm["e_inv_sdw"]), wd, bc(prm["d_scale"]),
            bc(prm["d_bias"]), bc(prm["d_inv_sproj"]), wp, bc(prm["p_scale"]), bc(prm["p_bias"]))


@pytest.mark.parametrize("tie", [False, True], ids=["random", "ties"])
def test_b6_plain_matches_pallas_kernel_and_ref(tie):
    prm, x = _b6_case(tie)
    args = [jnp.asarray(prm[k]) for k in KEYS]
    xp = jax_parity_planar(jnp.asarray(x))
    ker = make_fused_block_kernel(B6_B, B6_CIN, B6_CMID, B6_COUT, B6_HW_OUT, B6_ROW_BAND, interpret=True)
    got_k = np.asarray(ker(*args, pad_bands(xp, B6_HW_OUT, B6_ROW_BAND)))
    ref = np.asarray(fused_block_ref(xp, *args, hw_out=B6_HW_OUT))
    np.testing.assert_array_equal(got_k, ref)
    ops = [_t(prm[k]) for k in KEYS]
    got = fused_block_int8_plain_planar(_t(np.asarray(xp)), *ops, hw_out=B6_HW_OUT).numpy()
    np.testing.assert_array_equal(got, ref)
    # the NHWC entry, and the wrapper on the CPU, give the same values
    nhwc = fused_block_int8_plain(_t(x), *ops)
    assert nhwc.shape == (B6_B, B6_HW_OUT, B6_HW_OUT, B6_COUT)
    np.testing.assert_array_equal(nhwc_to_planar(nhwc).numpy(), ref)
    before = int8_block_s2.launches
    assert torch.equal(int8_block_s2(_t(x), *ops), nhwc)
    assert int8_block_s2.launches == before
    if tie:
        assert (got == 127).any() and (got != 127).any()


@pytest.mark.parametrize("hw", [(13, 19), (9, 32), (1, 5)], ids=["13x19", "9x32", "1x5"])
def test_b6_nhwc_on_ragged_maps_matches_conv_chain(hw):
    """Odd and ragged maps, which the parity-planar layout cannot hold:
    against the engine-style NHWC chain (3x3/s2, padding 1)."""
    prm, x = _b6_case(False, b=2, h=hw[0], w=hw[1])
    ref = np.asarray(xla_nhwc_chain(B6_CIN, B6_CMID, B6_COUT)(jnp.asarray(x), *_chain_args(prm, B6_CIN, B6_CMID, B6_COUT)))
    got = fused_block_int8_plain(_t(x), *[_t(prm[k]) for k in KEYS]).numpy()
    assert got.shape == ref.shape == (2, (hw[0] + 1) // 2, (hw[1] + 1) // 2, B6_COUT)
    np.testing.assert_array_equal(got, ref)


# --------------------------------------------------------------------------- #
# B7
# --------------------------------------------------------------------------- #

B7_B, B7_CIN, B7_CMID, B7_HW, B7_ROW_BAND, B7_COUT = 2, 24, 48, 16, 4, 32


def _b7_case(tie, b=B7_B, h=B7_HW, w=B7_HW):
    """(params, NHWC bf16 x, inv_se). Ties: odd integers times inv_se 0.5."""
    rng = np.random.RandomState(2)
    if tie:
        prm = _tie_params(B7_CIN, B7_CMID, B7_COUT, seed=6)
        x = rng.randint(-7, 8, (b, h, w, B7_CIN)).astype(np.float32)
        inv_se = 0.5
    else:
        prm = make_params(B7_CIN, B7_CMID, B7_COUT, seed=5)
        x = rng.rand(b, h, w, B7_CIN).astype(np.float32) * 4 - 2
        inv_se = 37.5
    xb = torch.from_numpy(x).to(torch.bfloat16)
    return prm, xb, inv_se


@pytest.mark.parametrize("tie", [False, True], ids=["random", "ties"])
def test_b7_plain_matches_pallas_kernel_and_ref(tie):
    prm, xb, inv_se = _b7_case(tie)
    x_planar = nhwc_to_planar(xb)
    xj = jnp.asarray(x_planar.float().numpy()).astype(jnp.bfloat16)
    inv = jnp.asarray(np.array([[inv_se]], np.float32))
    args = [inv] + [jnp.asarray(prm[k]) for k in KEYS]
    ref = np.asarray(fused_block_s1_ref(xj, *args, hw=B7_HW).astype(jnp.float32))
    # the kernel takes the input and the expand weight zero-padded to 32 rows
    pad = B7_COUT - B7_CIN
    x32 = jnp.concatenate([xj, jnp.zeros((B7_B, pad, B7_HW * B7_HW), xj.dtype)], axis=1)
    args_k = list(args)
    args_k[1] = jnp.concatenate([args[1], jnp.zeros((B7_CMID, pad), args[1].dtype)], axis=1)
    halo = -(-(B7_HW + 1) // 128) * 128
    ker = make_fused_block_s1_kernel(B7_B, B7_CIN, B7_CMID, B7_HW, B7_ROW_BAND, interpret=True)
    got_k = np.asarray(ker(*args_k, pad_bands(x32, B7_HW, B7_ROW_BAND, halo_lo=halo, halo_hi=halo)).astype(jnp.float32))
    np.testing.assert_array_equal(got_k, ref)
    ops = [_t(prm[k]) for k in KEYS]
    got = fused_block_s1_plain_planar(x_planar, torch.tensor([[inv_se]]), *ops, hw=B7_HW)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    nhwc = fused_block_s1_plain(xb, inv_se, *ops)
    np.testing.assert_array_equal(nhwc_to_planar(nhwc).float().numpy(), ref)
    before = int8_block_s1.launches
    assert torch.equal(int8_block_s1(xb, inv_se, pack_int8_block_s1(*ops)), nhwc)
    assert int8_block_s1.launches == before


@pytest.mark.parametrize("residual", [True, False], ids=["residual", "no_residual"])
def test_b7_nhwc_on_ragged_maps_matches_conv_chain(residual):
    prm, xb, inv_se = _b7_case(False, b=2, h=11, w=23)
    chain = xla_nhwc_chain_s1(B7_CIN, B7_CMID, B7_COUT, residual=residual)
    xj = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    ref = np.asarray(chain(xj, jnp.float32(inv_se), *_chain_args(prm, B7_CIN, B7_CMID, B7_COUT)).astype(jnp.float32))
    got = fused_block_s1_plain(xb, inv_se, *[_t(prm[k]) for k in KEYS], residual=residual)
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_layout_helpers_match_jax():
    rng = np.random.RandomState(9)
    x = rng.randint(-127, 128, (2, 6, 10, 5)).astype(np.int8)
    xp = nhwc_to_parity_planar(_t(x))
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jax_parity_planar(jnp.asarray(x))))
    assert torch.equal(parity_planar_to_nhwc(xp, 3, 5), _t(x))
    y = rng.randint(-127, 128, (2, 5, 12)).astype(np.int8)
    assert torch.equal(nhwc_to_planar(planar_to_nhwc(_t(y), 3, 4)), _t(y))


def test_block_wrappers_check_their_operands():
    prm, xb, inv_se = _b7_case(False)
    ops = [_t(prm[k]) for k in KEYS]
    packed = pack_int8_block_s1(*ops)
    with pytest.raises(TypeError, match="bf16"):
        int8_block_s1(xb.float(), inv_se, packed)
    with pytest.raises(TypeError, match="int8"):
        int8_block_s2(xb, *ops)
    bad = list(ops)
    bad[1] = bad[1][:5]
    with pytest.raises(ValueError, match="e_scale"):
        fused_block_s1_plain(xb, inv_se, *bad)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        int8_block_s1(xb.to("meta"), inv_se, packed)


# --------------------------------------------------------------------------- #
# the library int8 convs
# --------------------------------------------------------------------------- #


def _ref_conv(x, w_hwio, stride, groups):
    """int64 numpy conv, padding (k-1)//2, NHWC / HWIO."""
    b, h, wd, cin = x.shape
    kh = w_hwio.shape[0]
    pad = (kh - 1) // 2
    ho, wo = (h + 2 * pad - kh) // stride + 1, (wd + 2 * pad - kh) // stride + 1
    xp = np.pad(x.astype(np.int64), ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    w = w_hwio.astype(np.int64)
    out = np.zeros((b, ho, wo, w.shape[-1] if groups == 1 else cin), np.int64)
    for dy in range(kh):
        for dx in range(kh):
            tap = xp[:, dy : dy + stride * (ho - 1) + 1 : stride, dx : dx + stride * (wo - 1) + 1 : stride, :]
            out += tap @ w[dy, dx] if groups == 1 else tap * w[dy, dx, 0]
    return out


@pytest.mark.parametrize("shape", [(2, 9, 13, 32, 24), (1, 2, 3, 160, 5), (3, 4, 4, 8, 15)],
                         ids=["32->24", "16 rows 160->5", "8->15"])
def test_conv1x1_int8_exact(shape):
    b, h, w, cin, cout = shape
    rng = np.random.RandomState(cin + cout)
    x = rng.randint(-127, 128, (b, h, w, cin)).astype(np.int8)
    k = rng.randint(-127, 128, (cin, cout)).astype(np.int8)
    got = conv1x1_int8(_t(x), _t(k))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _ref_conv(x, k[None, None], 1, 1))


@pytest.mark.parametrize("stride,cin,cout,hw", [(2, 3, 32, (17, 22)), (1, 24, 24, (10, 7)), (1, 72, 5, (5, 6))],
                         ids=["stem K=27 s2", "smooth s1", "head 72->5"])
def test_conv3x3_int8_exact(stride, cin, cout, hw):
    rng = np.random.RandomState(cin)
    x = rng.randint(-127, 128, (2, *hw, cin)).astype(np.int8)
    k = rng.randint(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    np.testing.assert_array_equal(conv3x3_int8(_t(x), _t(k), stride).numpy(), _ref_conv(x, k, stride, 1))


@pytest.mark.parametrize("stride,hw", [(1, (9, 14)), (2, (9, 14)), (2, (16, 16)), (1, (1, 1))],
                         ids=["s1", "s2 odd", "s2 even", "1x1 map"])
def test_dwconv3x3_int8_exact(stride, hw):
    rng = np.random.RandomState(stride)
    c = 40
    x = rng.randint(-127, 128, (2, *hw, c)).astype(np.int8)
    k = rng.randint(-127, 128, (3, 3, c)).astype(np.int8)
    got = dwconv3x3_int8(_t(x), _t(k), stride)
    np.testing.assert_array_equal(got.numpy(), _ref_conv(x, k[:, :, None, :], stride, c))
    # the extreme case stays exact: every product 127*127, nine taps
    full = np.full((1, 3, 3, c), 127, np.int8)
    kf = np.full((3, 3, c), -127, np.int8)
    assert int(dwconv3x3_int8(_t(full), _t(kf), 1)[0, 1, 1, 0]) == -9 * 127 * 127


def test_int_mm_padding_cases():
    """`_mm` pads rows to 17 and K, N to multiples of 8; a shorter
    K on either side is taken as zeros."""
    rng = np.random.RandomState(7)
    for m, k, n in ((1, 27, 5), (16, 8, 8), (40, 13, 3)):
        a = rng.randint(-127, 128, (m, k)).astype(np.int8)
        w = rng.randint(-127, 128, (k, n)).astype(np.int8)
        got = _mm(_t(a), _t(w))
        assert got.shape == (m, n)
        np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ w.astype(np.int64))
    a = np.pad(rng.randint(-127, 128, (20, 27)).astype(np.int8), ((0, 0), (0, 5)))
    w = rng.randint(-127, 128, (27, 4)).astype(np.int8)
    np.testing.assert_array_equal(_mm(_t(a), _t(w)).numpy(), a[:, :27].astype(np.int64) @ w.astype(np.int64))
    with pytest.raises(TypeError, match="int8"):
        conv1x1_int8(_t(a.astype(np.int32)).reshape(1, 1, 20, 32), _t(w))


def test_int_mm_takes_a_column_major_second_operand(monkeypatch):
    """cuBLASLt's int8 product on the H100 refuses many shapes with a
    row-major second operand (7400x16 @ 16x96, 400x24 @ 24x32) and takes them
    all column-major: `_mm` must hand it over column-major, without a copy
    when the weight is already a transposed view."""
    seen = []
    real = torch._int_mm

    def spy(a, b):
        seen.append((a.stride(), b.stride(), b.shape))
        return real(a, b)

    monkeypatch.setattr(torch, "_int_mm", spy)
    rng = np.random.RandomState(8)
    a = _t(rng.randint(-127, 128, (7400, 16)).astype(np.int8))
    w = _t(rng.randint(-127, 128, (96, 16)).astype(np.int8)).t()   # (16, 96), a view
    got = _mm(a, w)
    np.testing.assert_array_equal(got.numpy(), a.numpy().astype(np.int64) @ w.numpy().astype(np.int64))
    assert seen == [((16, 1), (1, 16), (16, 96))]
    _mm(a, w.contiguous())
    assert seen[1][1] == (1, 16)


# --------------------------------------------------------------------------- #
# B7's launch plan and packed operands (csrc/int8_block_s1.cu)
# --------------------------------------------------------------------------- #

# the ten stride-1 residual blocks of the default model: (map at 640, Cin,
# Cmid, Cout); at 320 every map is half as wide
FLAGSHIP_S1 = ((160, 24, 144, 24), (80, 32, 192, 32), (80, 32, 192, 32), (40, 64, 384, 64), (40, 64, 384, 64),
               (40, 64, 384, 64), (40, 96, 576, 96), (40, 96, 576, 96), (20, 160, 960, 160), (20, 160, 960, 160))
PLAN_SHAPES = ([(32, hw, hw, cin, cmid, cout) for hw, cin, cmid, cout in FLAGSHIP_S1]
               + [(32, hw // 2, hw // 2, cin, cmid, cout) for hw, cin, cmid, cout in FLAGSHIP_S1]
               + [shape for _, shape, _, _ in chip_smoke.B7_KERNEL_SHAPES])


def _check_plan(b, h, w, cin, cmid, cout, plan=None):
    """The plan (the planner's unless given) covers every output position of
    the batch exactly once, as the kernel indexes its blocks, and every (M
    tile, N tile) of a tile's project once over the warps; its shared memory
    and grid fit."""
    plan = plan or plan_int8_block_s1(b, h, w, cin, cmid, cout)
    th, tw = plan.tile_h, plan.tile_w
    ty, tx = -(-h // th), -(-w // tw)
    assert plan.grid == (b * ty * tx, 1, 1) and plan.grid[0] < 2 ** 31
    assert plan.ck == s1_chunk_width(cmid) and plan.ck in (32, 64)
    assert plan.smem_bytes == s1_smem_bytes(th, tw, S1Layout(cin, cmid, cout, plan.ck)) <= MAX_SMEM
    assert (plan.warps, plan.pm, plan.pn) in S1_VARIANTS
    # every block's tile, position p = oy * tw + ox, masked to the map
    bid = np.arange(plan.grid[0])
    img, t = bid // (ty * tx), bid % (ty * tx)
    oy0, ox0 = (t // tx) * th, (t % tx) * tw
    p = np.arange(th * tw)
    gy = oy0[:, None] + p[None, :] // tw
    gx = ox0[:, None] + p[None, :] % tw
    keep = (gy < h) & (gx < w)
    flat = (np.broadcast_to(img[:, None], gy.shape) * h + gy) * w + gx
    counts = np.bincount(flat[keep], minlength=b * h * w)
    assert counts.shape == (b * h * w,) and (counts == 1).all()
    # the project's rectangles: warp -> (mg, ng), PM x PN tiles each
    mt, nt = -(-(th * tw) // 16), cout // 8
    ngroups = -(-nt // plan.pn)
    owned = np.zeros((mt, nt), np.int64)
    for warp in range(plan.warps):
        mg, ng = divmod(warp, ngroups)
        for i in range(plan.pm):
            for j in range(plan.pn):
                m, n = mg * plan.pm + i, ng * plan.pn + j
                if m < mt and n < nt:
                    owned[m, n] += 1
    assert (owned == 1).all()
    return plan


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=[f"{b}x{h}x{w}_{ci}-{cm}-{co}" for b, h, w, ci, cm, co in PLAN_SHAPES])
def test_b7_plan_covers_the_map(shape):
    plan = _check_plan(*shape)
    b, h, w = shape[:3]
    if (h, w) == (20, 20) and b == 32:  # the 20x20 blocks: more than one tile an image
        assert plan.grid[0] >= 2 * b


@pytest.mark.parametrize("shape", PLAN_SHAPES[:10:3], ids=lambda s: "x".join(map(str, s)))
def test_b7_every_candidate_plan_covers_the_map(shape):
    """Every plan the planner weighs (and `kernels/sweep_b7.py` times) is one
    the kernel takes, and the planner's choice is among them."""
    plans = list(s1_plans(*shape))
    assert plan_int8_block_s1(*shape) in plans
    for plan in plans:
        _check_plan(*shape, plan=plan)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(h=st.integers(1, 200), w=st.integers(1, 200), cin=st.sampled_from([8, 24, 32, 64, 96, 160]),
       cmid=st.integers(8, 960), cout=st.integers(1, 40).map(lambda n: 8 * n), b=st.integers(1, 2))
def test_b7_plan_covers_the_map_on_a_grid(h, w, cin, cmid, cout, b):
    _check_plan(b, h, w, cin, cmid, cout)


def _s1_ops(cin, cmid, cout, seed):
    rng = np.random.RandomState(seed)
    prm = make_params(cin, cmid, cout, seed=seed)
    prm["wd"] = rng.randint(-127, 128, (9, cmid)).astype(np.float32)
    return [_t(prm[k]) for k in KEYS]


@pytest.mark.parametrize("cin,cmid,cout", [(24, 144, 24), (32, 136, 32), (64, 200, 64), (160, 960, 160), (8, 8, 16)],
                         ids=["24-144-24", "Cmid136", "Cmid200", "160-960-160", "8-8-16"])
def test_b7_packing_round_trip(cin, cmid, cout):
    """pack_int8_block_s1 unpacks to the JAX-layout operands, and every byte
    outside the operands' places (row padding, channels past Cmid, the tap
    words' fourth byte, the tail) is zero."""
    ops = _s1_ops(cin, cmid, cout, seed=cmid)
    packed = pack_int8_block_s1(*ops)
    lay = packed.layout
    assert packed.data.dtype == torch.uint8 and packed.data.numel() == lay.nbytes
    assert lay.chunk_bytes % 16 == 0 and lay.off_wp % 16 == 0 and lay.off_taps % 16 == 0 and lay.off_vec % 16 == 0
    back = unpack_int8_block_s1(packed)
    for k, v in zip(KEYS, ops):
        assert torch.equal(back[k], v.reshape(back[k].shape)), k
    used = np.zeros(lay.nbytes, bool)
    for k in range(lay.nchunks):
        n = min(lay.ck, cmid - k * lay.ck)
        base = k * lay.chunk_bytes
        we = used[base : base + lay.off_wp].reshape(lay.ck, lay.xs)
        we[:n, :cin] = True
        wp = used[base + lay.off_wp : base + lay.off_taps].reshape(cout, lay.dss)
        wp[:, :n] = True
        taps = used[base + lay.off_taps : base + lay.off_vec].reshape(3, lay.ck, 4)
        taps[:, :n, :3] = True
        vec = used[base + lay.off_vec : base + lay.chunk_bytes].reshape(6, lay.ck, 4)
        vec[:, :n] = True
    used[lay.nchunks * lay.chunk_bytes : lay.nchunks * lay.chunk_bytes + 8 * cout] = True
    assert not packed.data.numpy()[~used].any()


@pytest.mark.parametrize("case", ["random", "extremes"])
def test_b7_packed_taps_give_the_depthwise_sums(case):
    """Each channel's tap word (w0, w1, w2, 0) of row dy, summed as byte
    products with the four bytes of a window starting at column x - 1 (the
    fourth byte arbitrary), row by row, equals dwconv3x3_int8's sums bit for
    bit: the kernel's three __dp4a an output."""
    rng = np.random.RandomState(11)
    cin, cmid, cout = 8, 40, 8
    ops = _s1_ops(cin, cmid, cout, seed=3)
    if case == "extremes":
        ops[4] = _t(rng.choice([-127, 127], (9, cmid)).astype(np.float32))
        e = rng.choice([-127, 127], (2, 7, 9, cmid)).astype(np.int8)
    else:
        e = rng.randint(-127, 128, (2, 7, 9, cmid)).astype(np.int8)
    packed = pack_int8_block_s1(*ops)
    lay = packed.layout
    raw = packed.data.numpy()
    words = np.concatenate([raw[k * lay.chunk_bytes + lay.off_taps : k * lay.chunk_bytes + lay.off_vec]
                            .reshape(3, lay.ck, 4) for k in range(lay.nchunks)], axis=1)[:, :cmid].view(np.int8)
    assert not words[:, :, 3].any()
    b, h, w, _ = e.shape
    # the halo'd rows, one byte past the right edge of garbage
    ep = np.pad(e.astype(np.int64), ((0, 0), (1, 1), (1, 2), (0, 0)))
    ep[:, :, -1] = rng.randint(-127, 128, ep[:, :, -1].shape)
    got = np.zeros((b, h, w, cmid), np.int64)
    for dy in range(3):
        for i in range(4):
            got += ep[:, dy : dy + h, i : i + w] * words[dy, :, i].astype(np.int64)
    want = dwconv3x3_int8(_t(e), ops[4].reshape(3, 3, cmid).to(torch.int8), 1).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "extremes":
        assert np.abs(got).max() == 9 * 127 * 127


def test_b7_wrapper_contract_on_the_cpu():
    """A CPU tensor takes the plain version on the unpacked operands (equal
    to fused_block_s1_plain on the JAX ones, no launch counted); a wrong
    dtype, channel count, operand type or a non-contiguous x raises."""
    prm, xb, inv_se = _b7_case(False, b=2, h=11, w=23)
    ops = [_t(prm[k]) for k in KEYS]
    packed = pack_int8_block_s1(*ops)
    before = int8_block_s1.launches
    for residual in (True, False):
        got = int8_block_s1(xb, inv_se, packed, residual=residual)
        assert torch.equal(got, fused_block_s1_plain(xb, inv_se, *ops, residual=residual))
    assert int8_block_s1.launches == before
    with pytest.raises(TypeError, match="bf16"):
        int8_block_s1(xb.to(torch.float16), inv_se, packed)
    with pytest.raises(ValueError, match="channels"):
        int8_block_s1(xb[..., :16].contiguous(), inv_se, packed)
    with pytest.raises(ValueError, match="contiguous"):
        int8_block_s1(xb.transpose(1, 2), inv_se, packed)
    with pytest.raises(TypeError, match="pack_int8_block_s1"):
        int8_block_s1(xb, inv_se, ops)
