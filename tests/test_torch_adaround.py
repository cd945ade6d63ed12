"""The port's AdaRound (`quant.adaround`) against the JAX package, on the small
float32 model of `tests/test_adaround.py` at 64 px.

Tolerances:
- `_h`, `_h_init` and their gradients: rtol H_RTOL (float32 sigmoid, log
  and division in two libraries);
- one `ada_step` against the JAX step (`adaround.py:222-243`, written out
  here with optax, as it is a closure there): the reconstruction MSE rtol
  1e-5; the gradient within GRAD_REL of its largest element; the new
  rounding variables within 1e-3 * lr where the gradient is above
  GRAD_REL of the largest (Adam's first step is +-lr by the gradient's sign,
  and elsewhere that sign is rounding noise: within 2 * lr);
- one `ada_step`: where h(v) lies on a corner of its clip (a channel's
  largest weight starts at fraction 0), the two sigmoids may put it on
  either side, and one gradient is 0 there: at most one element an output
  channel, each 0 on one side;
- a whole W4 run of a few steps from one scales dict against the JAX run
  (`torch_ft_ref.exact_jax`): every per-layer ratio <= 1 on both sides, the
  end-to-end loss before AdaRound rtol 1e-5, the frozen weight scales
  bit-equal, and at least EQUAL_SHARE of the rounding decisions (grid
  indices) equal. The loss is piecewise constant, so the two runs part
  where a decision flips: they are not compared bit for bit.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)
from torch_ft_ref import JCFG, SIZE, calib, exact_jax, folded_small, np_tree, port_cfg, small_variables
from tpucenterface.quant.adaround import _h as j_h
from tpucenterface.quant.adaround import _h_init as j_h_init
from tpucenterface.quant.adaround import adaround as j_adaround
from tpucenterface.quant.engine import QuantEngine as JQuantEngine
from tpucenterface_torch.quant import QuantEngine, adaround
from tpucenterface_torch.quant.adaround import _h, _h_init, _kernel_paths, ada_step
from tpucenterface_torch.train.step import Optimizer

H_RTOL = 1e-6
GRAD_REL = 1e-3
EQUAL_SHARE = 0.99


@pytest.fixture(scope="module")
def folded():
    return folded_small()


def _pair(folded, cal, **kw):
    jeng = JQuantEngine(folded, JCFG, **kw)
    jeng.calibrate(cal)
    peng = QuantEngine(folded, port_cfg(folded=True), device="cpu", **kw)
    peng.set_scales(dict(jeng.act_scales, **{"cfg:int8_dw": int(jeng.int8_dw), "cfg:weight_bits": jeng.weight_bits}))
    return jeng, peng


def test_h_and_h_init_match_jax():
    frac = np.linspace(0.0, 0.999, 97).astype(np.float32)
    v0 = _h_init(torch.from_numpy(frac))
    np.testing.assert_allclose(v0.numpy(), np.asarray(j_h_init(jnp.asarray(frac))), rtol=H_RTOL, atol=1e-6)
    np.testing.assert_allclose(_h(v0).numpy()[1:-1], frac[1:-1], atol=1e-4)  # starts at nearest rounding
    v = np.concatenate([np.linspace(-12, 12, 101), [-50.0, 50.0]]).astype(np.float32)
    vt = torch.from_numpy(v).requires_grad_()
    h = _h(vt)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(j_h(jnp.asarray(v))), rtol=H_RTOL, atol=1e-7)
    assert (h >= 0).all() and (h <= 1).all()
    (g,) = torch.autograd.grad(h.sum(), vt)
    jg = jax.grad(lambda a: j_h(a).sum())(jnp.asarray(v))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)
    assert g[-1] == 0 and g[-2] == 0  # clipped: no gradient


def _jax_ada_step(lr, qmax, reg_weight):
    """The JAX package's `_ada_step` (adaround.py:222-243), as written there."""
    import optax

    tx = optax.adam(lr)

    def step(v, opt_state, beta, x_hat, y_t, floor, sw, b, stride, groups, act, pad):
        def recon(vv):
            kq = sw * jnp.clip(floor + j_h(vv), -qmax, qmax)
            y = jax.lax.conv_general_dilated(
                x_hat, kq, (stride, stride), [(pad, pad), (pad, pad)],
                dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups,
                preferred_element_type=jnp.float32) + b
            if act == "relu6":
                y = jnp.clip(y, 0.0, 6.0)
            elif act == "relu":
                y = jnp.maximum(y, 0.0)
            mse = jnp.mean((y - y_t) ** 2)
            reg = jnp.mean(1.0 - jnp.abs(2.0 * j_h(vv) - 1.0) ** beta)
            return mse + reg_weight * reg, mse

        (_, mse), grads = jax.value_and_grad(recon, has_aux=True)(v)
        updates, opt_state = tx.update(grads, opt_state, v)
        return optax.apply_updates(v, updates), opt_state, mse, grads

    return tx, jax.jit(step, static_argnames=("stride", "groups", "act", "pad"))


@pytest.mark.parametrize("kh,cin,cout,stride,groups,act", [
    (1, 16, 24, 1, 1, "relu6"), (3, 24, 24, 2, 24, "relu6"), (3, 8, 16, 1, 1, "relu"), (1, 24, 8, 1, 1, "none"),
], ids=["expand", "dw-s2", "dense3x3-relu", "project"])
def test_one_ada_step_matches_jax(kh, cin, cout, stride, groups, act):
    rng = np.random.RandomState(kh * 100 + cin + stride)
    lr, qmax, reg_weight, beta = 1e-2, 127.0, 0.01, np.float32(20.0)
    sx = np.float32(0.03)
    x_hat = (np.round(rng.randn(2, 10, 10, cin) * 20).clip(-127, 127) * sx).astype(np.float32)
    k = (rng.randn(kh, kh, cin // groups, cout) * 0.2).astype(np.float32)
    sw = (np.abs(k).max(axis=(0, 1, 2)) / qmax).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    kdiv = k / sw
    floor = np.floor(kdiv).astype(np.float32)
    v0 = np.asarray(j_h_init(jnp.asarray(kdiv - floor)))
    ho = (10 - 1) // stride + 1
    y_t = np.maximum(rng.randn(2, ho, ho, cout), 0).astype(np.float32) * 0.5
    pad = (kh - 1) // 2
    jtx, jstep = _jax_ada_step(lr, qmax, reg_weight)
    jv, jstate, jmse, jg = jstep(jnp.asarray(v0), jtx.init(jnp.asarray(v0)), beta, jnp.asarray(x_hat),
                                 jnp.asarray(y_t), jnp.asarray(floor), jnp.asarray(sw), jnp.asarray(b),
                                 stride=stride, groups=groups, act=act, pad=pad)
    tx = Optimizer(lr=lr)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    v = t(v0)
    pv, pstate, pmse = ada_step(tx, v, tx.init({"v": v}), float(beta), t(x_hat), t(y_t), t(floor), t(sw), t(b),
                                stride, groups, act, qmax, reg_weight)
    np.testing.assert_allclose(float(pmse), float(jmse), rtol=1e-5)
    jg = np.asarray(jg)
    pg = pstate["mu"]["v"].numpy() / 0.1  # Adam's first moment after one step is 0.1 * g
    gmax = np.abs(jg).max()
    # where h(v) sits on a corner of its clip (0 or 1 within float32
    # rounding: a channel's largest weight, whose fraction is 0), the two
    # sigmoids put it on either side: there one gradient may be 0 where the
    # other is not, at most once an output channel
    h0 = np.asarray(j_h(jnp.asarray(v0)))
    corner = (h0 <= 1e-6) | (h0 >= 1.0 - 1e-6)
    off = np.abs(pg - jg) > GRAD_REL * gmax
    assert not (off & ~corner).any(), np.abs(pg - jg)[~corner].max() / gmax
    assert ((pg[off] == 0) | (jg[off] == 0)).all() and off.sum() <= cout
    firm = (np.abs(jg) > GRAD_REL * gmax) & ~off
    d = np.abs(pv.numpy() - np.asarray(jv))
    assert firm.mean() > 0.5 and d[firm].max() <= 1e-3 * lr and d.max() <= 2 * lr + 1e-6, (d[firm].max(), d.max())


@pytest.fixture(scope="module")
def port_run(folded):
    """The port's AdaRound, 10 steps, on a W4 int8_dw engine (at W8 the
    learned rounding sits at the noise floor and the end-to-end guard may
    revert it)."""
    cal = calib(1)
    _, peng = _pair(folded, cal, int8_dw=True, weight_bits=4)
    return peng, adaround(peng, cal, steps=10)


@pytest.mark.slow
def test_adaround_run_agrees_with_jax(folded):
    """The whole run against the JAX run from one scales dict (slow: the JAX
    function compiles its step for every layer, ~65 s)."""
    cal = calib(1)
    jeng, peng = _pair(folded, cal, int8_dw=True, weight_bits=4)
    with exact_jax(jeng):
        jrep = j_adaround(jeng, cal, steps=10)
    prep = adaround(peng, cal, steps=10)
    assert set(prep) == set(jrep)
    ratios = {k: v for k, v in prep.items() if not k.startswith("_")}
    assert ratios and all(v <= 1.0 for v in ratios.values()), ratios
    assert all(v <= 1.0 for k, v in jrep.items() if not k.startswith("_"))
    np.testing.assert_allclose(prep["_e2e_first"], jrep["_e2e_first"], rtol=1e-5)
    assert prep["_accepted"] == jrep["_accepted"] == 1.0
    assert set(peng.weight_scales) == set(jeng.weight_scales) == set(ratios)
    for tag, sw in jeng.weight_scales.items():
        np.testing.assert_array_equal(peng.weight_scales[tag], np.asarray(sw), err_msg=tag)
    # the rounding decisions: grid indices of the on-grid kernels
    got, want = np_tree(peng.p), np_tree(jeng.p)
    equal = total = 0
    for tag, kp in _kernel_paths(peng).items():
        sw = peng.weight_scales[tag]
        g_port, g_jax = np.round(got[kp] / sw), np.round(want[kp] / sw)
        equal += int((g_port == g_jax).sum())
        total += g_port.size
    assert equal / total >= EQUAL_SHARE, equal / total


def test_adaround_report_and_persistence(port_run, folded):
    peng, rep = port_run
    ratios = {k: v for k, v in rep.items() if not k.startswith("_")}
    assert set(ratios) == {t for t in peng.convs if peng.quantizes(t)}
    assert all(v <= 1.0 for v in ratios.values()), ratios
    assert rep["_e2e_last"] <= rep["_e2e_first"] and rep["_accepted"] == 1.0
    assert set(peng.weight_scales) == set(ratios)
    x = torch.from_numpy(calib(7, n=1)[0])
    want = peng(x)
    scales = dict(peng.act_scales, **{f"w:{t}": s for t, s in peng.weight_scales.items()},
                  **{"cfg:int8_dw": 1, "cfg:weight_bits": 4})
    fresh = QuantEngine(folded, port_cfg(folded=True), int8_dw=True, weight_bits=4, device="cpu")
    fresh.set_scales(scales)
    fresh.p = np_tree_nested(peng.p)
    got = fresh(x)
    for k in ("hm", "whoff"):
        assert torch.equal(got[k], want[k]), k
    # on-grid kernels: the served quantization reproduces them exactly
    flat = np_tree(peng.p)
    for tag, kp in _kernel_paths(peng).items():
        if tag in peng.weight_scales:
            kq, sw = peng.quant_weight(tag)
            np.testing.assert_array_equal(kq.astype(np.float32) * sw, flat[kp], err_msg=tag)


def np_tree_nested(tree):
    return {k: np_tree_nested(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


def test_detector_w4_adaround_decisive_and_self_describing(tmp_path):
    """tests/test_w4.py's W4 case on the port: AdaRound beats nearest
    rounding by >= 5% end to end, and the persisted scales reinstall at W4
    without weight_bits, bit-equal."""
    import tpucenterface_torch as T
    from tpucenterface_torch.weights.io import load_quant_scales, save_quant_scales

    def det():
        return T.Detector(variables=small_variables(0), config=T.DetectorConfig(model=port_cfg(), default_size=SIZE), device="cpu")

    rng = np.random.RandomState(3)
    calib_u8 = rng.randint(0, 255, (4, SIZE, SIZE, 3), np.uint8)
    img = rng.randint(0, 255, (SIZE, SIZE, 3), np.uint8)
    d = det()
    scales = d.quantize(calib_images=calib_u8, weight_bits=4, adaround_steps=30)
    rep = d.last_adaround_report
    assert rep["_accepted"] == 1.0 and rep["_e2e_last"] <= 0.95 * rep["_e2e_first"], rep
    assert min(v for k, v in rep.items() if not k.startswith("_")) < 0.9
    assert int(scales["cfg:weight_bits"]) == 4
    got = d.detect(img, score_thresh=-1.0)
    sp = str(tmp_path / "w4.json")
    save_quant_scales(scales, sp)
    d2 = det()
    assert int(d2.quantize(scales=load_quant_scales(sp), quant_params=d.quant_variables)["cfg:weight_bits"]) == 4
    assert d2._quant.weight_bits == 4
    got2 = d2.detect(img, score_thresh=-1.0)
    np.testing.assert_array_equal(got2.scores, got.scores)
    np.testing.assert_array_equal(got2.boxes, got.boxes)


def test_adaround_guard_reverts_cleanly(folded, monkeypatch):
    """When the end-to-end loss gets worse, the engine goes back to its
    untouched params and scales, installed."""
    ada = importlib.import_module("tpucenterface_torch.quant.adaround")  # the package exports a function of that name
    cal = calib(1)
    _, peng = _pair(folded, cal, int8_dw=True)
    x = torch.from_numpy(calib(7, n=1)[0])
    before, p0 = peng(x), np_tree(peng.p)
    calls = []
    real = ada.head_map_loss

    def worse_later(out, target, keys):
        calls.append(1)
        return real(out, target, keys) * (1.0 if len(calls) <= len(cal) else 2.0)

    monkeypatch.setattr(ada, "head_map_loss", worse_later)
    rep = adaround(peng, cal, steps=2)
    assert rep["_accepted"] == 0.0 and rep["_e2e_last"] == rep["_e2e_first"]
    assert peng.weight_scales == {}
    p1 = np_tree(peng.p)
    assert all(np.array_equal(p0[k], p1[k]) for k in p0)
    after = peng(x)
    for k in ("hm", "whoff"):
        assert torch.equal(after[k], before[k]), k


def test_adaround_guards_match_jax(folded):
    eng = QuantEngine(folded, port_cfg(folded=True), device="cpu")
    with pytest.raises(ValueError, match="calibrat"):
        adaround(eng, [np.zeros((1, SIZE, SIZE, 3), np.float32)], steps=1)
    eng.calibrate([np.random.RandomState(0).rand(1, SIZE, SIZE, 3).astype(np.float32)])
    with pytest.raises(ValueError, match="batch"):
        adaround(eng, [], steps=1)
    with pytest.raises(ValueError, match="one spatial size"):
        adaround(eng, [np.zeros((1, SIZE, SIZE, 3), np.float32), np.zeros((1, 32, 32, 3), np.float32)], steps=1)
    assert eng.weight_scales == {}
