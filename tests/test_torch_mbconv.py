"""The port's fused MBConv block against the JAX package's.

`fused_mbconv_plain` (the plain version the CUDA kernel is held against on
the card) is compared with the Pallas kernel in interpret mode, as
tests/test_fused_mbconv.py runs it; `mbconv_reference` with the JAX
`mbconv_reference` in float32. Inputs come from numpy with a seed.

Tolerance of plain against the Pallas kernel: both round at the same points
(bfloat16 operands, float32 sums, bfloat16 after the expand, after the
depthwise and at the end), so they differ only where another float32
summation order lands a value on the other side of a bfloat16 rounding
boundary: one bfloat16 step of an intermediate, carried to the output.
Measured on these four cases on the CPU: no difference at all (bit-equal,
outputs up to 4.8 in magnitude). Nothing guarantees either side's summation
order, so the bound is not 0 but one bfloat16 step, atol 0.02 + rtol 2^-7, on
at most 0.2% of the values: tighter than the JAX test's
kernel-against-float32 bound (atol 0.15, rtol 0.05) and than the atol 0.05,
rtol 0.02 to start from.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucenterface.ops.fused_mbconv import fused_mbconv as jax_fused_mbconv
from tpucenterface.ops.fused_mbconv import mbconv_reference as jax_mbconv_reference
from tpucenterface_torch.config import ModelConfig
from tpucenterface_torch.model.blocks import InvertedResidual
from tpucenterface_torch.ops.fused_mbconv import (
    fused_mbconv,
    fused_mbconv_plain,
    mbconv_reference,
)
from tpucenterface_torch.weights.convert import mbconv_args_from_block, state_dict_from_variables

ATOL, RTOL = 0.02, 2.0 ** -7


def _params(rng, cin, ce, cout, expand=True, b1_shift=0.0):
    w1 = rng.randn(cin, ce).astype(np.float32) * 0.3 if expand else None
    b1 = (rng.randn(ce) * 0.1 + b1_shift).astype(np.float32) if expand else None
    wd = rng.randn(3, 3, ce).astype(np.float32) * 0.3
    bd = rng.randn(ce).astype(np.float32) * 0.1
    w2 = rng.randn(ce, cout).astype(np.float32) * 0.3
    b2 = rng.randn(cout).astype(np.float32) * 0.1
    return w1, b1, wd, bd, w2, b2


def _t(args):
    return [None if a is None else torch.from_numpy(a) for a in args]


def _j(args):
    return [None if a is None else jnp.asarray(a) for a in args]


CASES = [
    # cin, ce, cout, expand, skip, h, w, band
    (16, 96, 24, True, False, 16, 24, 8),    # expand, no skip
    (24, 144, 24, True, True, 8, 16, 4),     # expand + skip
    (32, 32, 16, False, False, 8, 8, 4),     # t=1 (no expand)
    (16, 96, 16, True, True, 16, 10, 2),     # eight bands
]


@pytest.mark.parametrize("cin,ce,cout,expand,skip,h,w,band", CASES)
def test_plain_matches_pallas_interpret(cin, ce, cout, expand, skip, h, w, band):
    rng = np.random.RandomState(0)
    x = (rng.randn(2, h, w, cin) * 0.5).astype(np.float32)
    args = _params(rng, cin, ce, cout, expand)
    want = jax_fused_mbconv(
        jnp.asarray(x).astype(jnp.bfloat16), *_j(args), skip=skip, band=band, interpret=True
    )
    got = fused_mbconv_plain(torch.from_numpy(x).bfloat16(), *_t(args), skip=skip)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, h, w, cout)
    g, r = got.float().numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(g, r, atol=ATOL, rtol=RTOL)
    assert (g != r).mean() < 0.002


@pytest.mark.parametrize("cin,ce,cout,expand,skip,h,w,band", CASES[:3])
def test_reference_matches_jax_reference_f32(cin, ce, cout, expand, skip, h, w, band):
    """float32 in, float32 throughout: the two differ in summation order only."""
    rng = np.random.RandomState(1)
    x = (rng.randn(2, h, w, cin) * 0.5).astype(np.float32)
    args = _params(rng, cin, ce, cout, expand)
    want = jax_mbconv_reference(jnp.asarray(x), *_j(args), skip=skip)
    got = mbconv_reference(torch.from_numpy(x), *_t(args), skip=skip)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_plain_is_near_the_f32_reference():
    """The bfloat16 cast points cost what the JAX test allows its kernel
    against the float32 reference (atol 0.15, rtol 0.05)."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy((rng.randn(2, 8, 16, 24) * 0.5).astype(np.float32)).bfloat16()
    args = _t(_params(rng, 24, 144, 24))
    got = fused_mbconv_plain(x, *args, skip=True).float().numpy()
    ref = mbconv_reference(x, *args, skip=True).float().numpy()
    np.testing.assert_allclose(got, ref, atol=0.15, rtol=0.05)


@pytest.mark.parametrize("relu6", [True, False])
def test_pad_positions_are_zero_after_the_expand(relu6):
    """With a large positive b1, act(b1) at the zero-pad positions would leak
    into the border's depthwise taps. The Pallas kernel masks them; so must
    the plain version. A version that pads the input instead of the
    expanded tensor is far outside the tolerance on the border."""
    rng = np.random.RandomState(3)
    cin, ce, cout, h, w = 16, 96, 24, 8, 12
    x = (rng.randn(1, h, w, cin) * 0.5).astype(np.float32)
    args = _params(rng, cin, ce, cout, b1_shift=3.0)
    want = np.asarray(
        jax_fused_mbconv(
            jnp.asarray(x).astype(jnp.bfloat16), *_j(args), skip=False, relu6=relu6, band=4, interpret=True
        ),
        np.float32,
    )
    xb = torch.from_numpy(x).bfloat16()
    got = fused_mbconv_plain(xb, *_t(args), skip=False, relu6=relu6).float().numpy()
    np.testing.assert_allclose(got, want, atol=2 * ATOL, rtol=RTOL)
    # the wrong version: zero-pad x, run the block on the padded image, crop
    xp = torch.nn.functional.pad(xb, (0, 0, 2, 2, 2, 2))
    wrong = fused_mbconv_plain(xp, *_t(args), skip=False, relu6=relu6)[:, 2:-2, 2:-2].float().numpy()
    border = np.abs(wrong - want)[:, [0, -1]].max()
    inner = np.abs(wrong - want)[:, 2:-2, 2:-2].max()
    assert border > 1.0 and inner <= 2 * ATOL + RTOL * np.abs(want).max()


def test_wrapper_on_cpu_is_the_plain_version_and_counts_no_launch():
    rng = np.random.RandomState(4)
    x = torch.from_numpy((rng.randn(1, 6, 6, 16) * 0.5).astype(np.float32)).bfloat16()
    args = _t(_params(rng, 16, 96, 16))
    before = fused_mbconv.launches
    got = fused_mbconv(x, *args, skip=True)
    assert torch.equal(got, fused_mbconv_plain(x, *args, skip=True))
    assert fused_mbconv.launches == before
    # float32 input: rounded to bfloat16 inside, returned as float32
    got32 = fused_mbconv(x.float(), *args, skip=True)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), got.float().numpy(), atol=0.04, rtol=2.0 ** -7)


def test_wrapper_rejects_bad_shapes():
    rng = np.random.RandomState(5)
    x = torch.zeros(1, 4, 4, 16, dtype=torch.bfloat16)
    w1, b1, wd, bd, w2, b2 = _t(_params(rng, 16, 96, 24))
    with pytest.raises(ValueError, match="skip"):
        fused_mbconv(x, w1, b1, wd, bd, w2, b2, skip=True)          # Cin != Cout
    with pytest.raises(ValueError, match="Ce must equal Cin"):
        fused_mbconv(x, None, None, wd, bd, w2, b2, skip=False)      # no expand, Ce != Cin
    with pytest.raises(ValueError, match="w1 must be"):
        fused_mbconv(x, w1.t().contiguous(), b1, wd, bd, w2, b2, skip=False)
    with pytest.raises(ValueError, match="x must be"):
        fused_mbconv(x[0], w1, b1, wd, bd, w2, b2, skip=False)


def test_weights_carried_across_by_value():
    """A folded flax block -> the kernel's arguments. Cin != Ce != Cout, so a
    transposed 1x1 kernel has another shape; values are checked one by one,
    and the block run through `fused_mbconv_plain` on these arguments equals
    the port's `InvertedResidual` module holding the same weights (float32
    module against bfloat16 cast points: the JAX test's bound)."""
    rng = np.random.RandomState(6)
    cin, t, cout = 16, 6, 24
    ce = cin * t

    def scope(kh, i, o):
        return {"conv": {"kernel": (rng.randn(kh, kh, i, o) * 0.3).astype(np.float32),
                         "bias": (rng.randn(o) * 0.1).astype(np.float32)}}

    block = {"expand": scope(1, cin, ce), "depthwise": scope(3, 1, ce), "project": scope(1, ce, cout)}
    w1, b1, wd, bd, w2, b2 = mbconv_args_from_block(block)
    assert w1.shape == (cin, ce) and wd.shape == (3, 3, ce) and w2.shape == (ce, cout)
    assert b1.shape == (ce,) and bd.shape == (ce,) and b2.shape == (cout,)
    for i in range(cin):
        for o in range(0, ce, 7):
            assert w1[i, o] == block["expand"]["conv"]["kernel"][0, 0, i, o]
    for i in range(0, ce, 5):
        for o in range(cout):
            assert w2[i, o] == block["project"]["conv"]["kernel"][0, 0, i, o]
    np.testing.assert_array_equal(wd, block["depthwise"]["conv"]["kernel"][:, :, 0, :])
    np.testing.assert_array_equal(bd, block["depthwise"]["conv"]["bias"])

    cfg = ModelConfig()
    mod = InvertedResidual(cin, cout, 1, t, relu6=cfg.relu6, dtype=torch.float32, folded=True).eval()
    mod.load_state_dict(state_dict_from_variables({"params": block}), strict=True)
    x = torch.from_numpy((rng.randn(2, 10, 12, cin) * 0.5).astype(np.float32)).bfloat16()
    with torch.inference_mode():
        want = mod(x.float().permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    got = fused_mbconv_plain(x, *_t((w1, b1, wd, bd, w2, b2)), skip=False).float().numpy()
    np.testing.assert_allclose(got, want, atol=0.15, rtol=0.05)

    no_expand = {"depthwise": scope(3, 1, cin), "project": scope(1, cin, cout)}
    w1, b1, wd, *_ = mbconv_args_from_block(no_expand)
    assert w1 is None and b1 is None and wd.shape == (3, 3, cin)
    with pytest.raises(ValueError, match="fold BatchNorm"):
        mbconv_args_from_block({"depthwise": {"conv": {"kernel": np.zeros((3, 3, 1, 8), np.float32)}}})
