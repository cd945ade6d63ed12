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
- `quant.int8_ops` against int64 numpy sums, padding cases included.

All of it is integer-exact up to float32 epilogues that both sides round
alike, so every comparison is bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    nhwc_to_parity_planar,
    nhwc_to_planar,
    parity_planar_to_nhwc,
    planar_to_nhwc,
)
from tpucenterface_torch.ops.int8_conv import conv1x1_int8_plain, int8_conv1x1
from tpucenterface_torch.quant.int8_ops import _mm, conv1x1_int8, conv3x3_int8, dwconv3x3_int8

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
    assert torch.equal(int8_block_s1(xb, inv_se, *ops), nhwc)
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
    with pytest.raises(TypeError, match="bf16"):
        int8_block_s1(xb.float(), inv_se, *ops)
    with pytest.raises(TypeError, match="int8"):
        int8_block_s2(xb, *ops)
    bad = list(ops)
    bad[1] = bad[1][:5]
    with pytest.raises(ValueError, match="e_scale"):
        fused_block_s1_plain(xb, inv_se, *bad)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        int8_block_s1(xb.to("meta"), inv_se, *ops)


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
