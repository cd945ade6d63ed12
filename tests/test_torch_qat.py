"""The port's QAT (`quant.qat`, the engine's 'fakequant' mode and
bias-correction collector, `Detector.quantize(qat_steps=, quant_params=)`,
`quant_variables`) against the JAX package.

The JAX references run with `torch_ft_ref.exact_jax` / `jit_exact` (jitted
with the arithmetic of the op-by-op run), on the small float32 model of
`tests/test_adaround.py` at 64 px, from one scales dict (the JAX engine's
calibration installed into the port's through `set_scales`). Tolerances:

- `fake_quant` / `fake_quant_weight`: bit-equal values, equal STE gradients,
  at the clip bounds too;
- 'fakequant' head maps: FQ_MAP_ATOL (measured max 4.8e-7 on maps up to
  4.6: float32 ulps, no grid point moves); the distillation loss rtol 1e-5
  (measured 2e-7 and 6e-7);
- its parameter gradients: the two packages' float32 sums of the cotangents
  round to different bf16 neighbours where the forward writes bf16 (the
  backward passes through the same roundings), which moves a few elements
  by up to 2.2% of the largest gradient and the whole gradient by 1.0% of
  its norm (measured, int8_dw off; 0.9% and 0.6% on): bounds GRAD_MAX_REL
  of the largest gradient element and GRAD_NORM_REL of the norm;
- the bias-correction means: MEAN_ATOL over the largest mean (measured:
  quant mode 2.1e-7, float32 reductions in two orders; float mode 1.0e-5,
  where a bf16 write upstream rounds the other way);
- `qat_finetune(steps=0)`'s loss_first and loss_bc: rtol 1e-5 (measured:
  loss_first bit-equal, loss_bc 6e-7);
- the persisted pair (scales, `quant_variables`) installed in a fresh port
  Detector: detections bit-equal; installed in a JAX engine: quant head
  maps within one float32 ulp of the port's (the jitted epilogue's fused
  multiply-add).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import tpucenterface_torch as T
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)
from torch_ft_ref import KEYS, SIZE, JCFG, calib, exact_jax, folded_small, jit_exact, np_tree, port_cfg
from torch_ft_ref import small_variables
from tpucenterface.config import DetectorConfig as JDetectorConfig
from tpucenterface.config import PreprocessConfig as JPre
from tpucenterface.detector import Detector as JDetector
from tpucenterface.quant.engine import QuantEngine as JQuantEngine
from tpucenterface.quant.engine import fake_quant as j_fake_quant
from tpucenterface.quant.engine import fake_quant_weight as j_fake_quant_weight
from tpucenterface.quant.qat import head_map_loss as j_head_map_loss
from tpucenterface.quant.qat import qat_finetune as j_qat_finetune
from tpucenterface_torch.quant import QuantEngine, qat_finetune
from tpucenterface_torch.quant.engine import fake_quant, fake_quant_weight
from tpucenterface_torch.quant.qat import head_map_loss, ste_loss_and_grads
from tpucenterface_torch.weights.io import load_quant_scales, load_safetensors, save_quant_scales, save_safetensors

FQ_MAP_ATOL = 2e-6
GRAD_MAX_REL, GRAD_NORM_REL = 0.05, 0.03
MEAN_ATOL = {"quant": 1e-6, "float": 5e-5}
# The fine-tuned flagship against JAX (`test_flagship_fine_tuned_ap_matches_jax`,
# 320 px; measured on the CPU). At this size the two packages' float teacher
# and quant forwards part in float32 and bf16 roundings (other sum orders;
# XLA contracts the epilogue's multiply-add), which moves the losses before
# any step by up to 0.68% (QAT loss_first 0.47%, loss_bc 0.68%; AdaRound
# _e2e_first 0.07%): FT_PREFIX_RTOL. QAT's loss_last within FT_GAIN_RTOL of
# JAX's (measured 0.6%; the port's own runs on one and on two threads read
# 4.1% apart). AdaRound with every earlier layer's kernel taken from the
# JAX run: each layer's rounding decisions equal JAX's on FT_FORCED_EQUAL
# (measured 99.81% at the least, 99.91% overall) and the end-to-end loss
# within FT_PREFIX_RTOL (measured 0.04%); run freely, the two part where a
# decision flips and agree on 96.9% of the decisions, as JAX's jitted run
# agrees with its op-by-op arithmetic on 96.8%. AP within FT_AP_SPREAD a
# split: two runs of one package that differ only in the order of float32
# sums read up to 0.0145 apart (the port's QAT on one thread against two,
# medium; the port's AdaRound 0.0035; JAX's jitted QAT against its op-by-op
# arithmetic 0.0125, AdaRound 0.0037).
FT_PREFIX_RTOL, FT_GAIN_RTOL, FT_FORCED_EQUAL, FT_AP_SPREAD = 1e-2, 0.1, 0.995, 0.02


@pytest.fixture(scope="module")
def folded():
    return folded_small()


def _scales(jeng):
    return dict(jeng.act_scales, **{"cfg:int8_dw": int(jeng.int8_dw), "cfg:weight_bits": jeng.weight_bits})


def _pair(folded, cal, int8_dw):
    """(JAX engine calibrated on `cal`, port engine under its scales)."""
    jeng = JQuantEngine(folded, JCFG, int8_dw=int8_dw)
    jeng.calibrate(cal)
    peng = QuantEngine(folded, port_cfg(folded=True), int8_dw=int8_dw, device="cpu")
    peng.set_scales(_scales(jeng))
    return jeng, peng


# --------------------------------------------------------------------------- #
# the STE primitives
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("qmax", [127, 7])
def test_fake_quant_matches_jax_at_the_bounds(qmax):
    s = 0.5  # exact: x = 0.5 * qmax lands on the bound
    edge = 0.5 * qmax
    x = np.array([0.0, 0.25, 0.75, -0.25, 1.3, edge, -edge, edge + 0.25, -edge - 0.25, edge - 0.25, 2.0 * edge],
                 np.float32)
    x = np.concatenate([x, np.random.RandomState(0).randn(64).astype(np.float32) * qmax * 0.4])
    got = fake_quant(torch.from_numpy(x), s, qmax)
    want = j_fake_quant(jnp.asarray(x), s, qmax)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    xt = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad((fake_quant(xt, s, qmax) * torch.arange(x.size)).sum(), xt)
    jg = jax.grad(lambda v: (j_fake_quant(v, s, qmax) * jnp.arange(x.size)).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    mask = g.numpy() != 0
    assert mask[5] and mask[6] and not mask[7] and not mask[8] and not mask[10]  # bounds in, beyond out
    # per-channel scales broadcast over the last axis
    xc = np.random.RandomState(1).randn(2, 3, 5).astype(np.float32)
    sc = np.array([0.01, 0.1, 0.02, 1.0, 0.003], np.float32)
    np.testing.assert_array_equal(fake_quant(torch.from_numpy(xc), torch.from_numpy(sc), qmax).numpy(),
                                  np.asarray(j_fake_quant(jnp.asarray(xc), jnp.asarray(sc), qmax)))


@pytest.mark.parametrize("fixed,qmax", [(False, 127), (True, 127), (False, 7)])
def test_fake_quant_weight_matches_jax(fixed, qmax):
    rng = np.random.RandomState(2)
    k = rng.randn(3, 3, 8, 16).astype(np.float32)
    sw = (np.abs(k).max(axis=(0, 1, 2)) / qmax * 0.8).astype(np.float32) if fixed else None
    got = fake_quant_weight(torch.from_numpy(k), sw, qmax)
    want = j_fake_quant_weight(jnp.asarray(k), sw, qmax)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    w = rng.randn(*k.shape).astype(np.float32)
    kt = torch.from_numpy(k).requires_grad_()
    (g,) = torch.autograd.grad((fake_quant_weight(kt, sw, qmax) * torch.from_numpy(w)).sum(), kt)
    jg = jax.grad(lambda v: (j_fake_quant_weight(v, sw, qmax) * w).sum())(jnp.asarray(k))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    if fixed:
        assert (g.numpy() == 0).any()  # the frozen scale clips the largest weights


# --------------------------------------------------------------------------- #
# the fakequant mode and the bias-correction collector
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def fq_ref(folded):
    """Per int8_dw: the engines, the batch, the float targets, and the JAX
    fakequant maps, loss and gradients."""
    cal = calib(0)
    out = {}
    for dw in (False, True):
        jeng, peng = _pair(folded, cal, dw)
        x = jnp.asarray(cal[0])
        st = {t: jeng._act_scale(t) for t in jeng.act_scales}

        def fwd(p, st, x, mode):
            jeng._act_scale = lambda tag: st[tag]
            try:
                return jeng._forward(x, mode, p)
            finally:
                del jeng._act_scale

        tgt = jit_exact(lambda p, st, x: {k: fwd(p, st, x, "float")[k].astype(jnp.float32) for k in KEYS},
                        jeng.p, st, x)
        def loss_and_maps(p, st, x, t):
            out = fwd(p, st, x, "fakequant")
            return j_head_map_loss(out, t, KEYS), out

        (loss, maps), grads = jit_exact(jax.value_and_grad(loss_and_maps, has_aux=True), jeng.p, st, x, tgt)
        out[dw] = dict(jeng=jeng, peng=peng, cal=cal, tgt=tgt, maps=maps, loss=float(loss), grads=np_tree(grads))
    return out


@pytest.mark.parametrize("int8_dw", [False, True], ids=["int8", "int8_dw"])
def test_fakequant_maps_loss_and_grads_match_jax(fq_ref, int8_dw):
    r = fq_ref[int8_dw]
    peng, x = r["peng"], torch.from_numpy(r["cal"][0])
    got = peng._forward(x, "fakequant")
    for k in ("hm", "wh", "off", "whoff"):
        g, w = got[k].detach().numpy(), np.asarray(r["maps"][k])
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=FQ_MAP_ATOL, err_msg=k)
    tgt = {k: torch.from_numpy(np.array(r["tgt"][k])) for k in KEYS}
    loss, grads = ste_loss_and_grads(peng, peng.p, x, tgt, KEYS)
    np.testing.assert_allclose(float(loss), r["loss"], rtol=1e-5)
    g, w = np_tree(grads), r["grads"]
    assert set(g) == set(w)
    gmax = max(np.abs(a).max() for a in w.values())
    worst = max(np.abs(g[p] - w[p]).max() for p in w) / gmax
    norm = np.sqrt(sum(((g[p] - w[p]) ** 2).sum() for p in w) / sum((w[p] ** 2).sum() for p in w))
    assert worst <= GRAD_MAX_REL and norm <= GRAD_NORM_REL, (worst, norm)
    # the gradient reaches every parameter tensor
    assert all(np.abs(a).max() > 0 for a in g.values())


@pytest.mark.parametrize("int8_dw", [False, True], ids=["int8", "int8_dw"])
def test_bias_correction_means_match_jax(fq_ref, int8_dw):
    r = fq_ref[int8_dw]
    jeng, peng, x = r["jeng"], r["peng"], r["cal"][0]
    st = {t: jeng._act_scale(t) for t in jeng.act_scales}
    for mode in ("float", "quant"):
        def collect(p, st, x):
            jeng._act_scale = lambda tag: st[tag]
            jeng._bc_collector = {}
            try:
                jeng._forward(x, mode, p)
                return jeng._bc_collector
            finally:
                jeng._bc_collector = None
                del jeng._act_scale

        want = jit_exact(collect, jeng.p, st, jnp.asarray(x))
        peng._bc_collector = {}
        with torch.no_grad():
            peng._forward(torch.from_numpy(x), mode, params=peng.p)
        got, peng._bc_collector = peng._bc_collector, None
        assert set(got) == set(want) == set(peng.convs)
        top = max(np.abs(np.asarray(v)).max() for v in want.values())
        for tag, v in want.items():
            np.testing.assert_allclose(got[tag].numpy(), np.asarray(v), rtol=0, atol=MEAN_ATOL[mode] * top,
                                       err_msg=f"{mode} {tag}")


def test_qat_losses_match_jax_from_one_scales_dict(folded):
    cal = calib(1)
    jeng, peng = _pair(folded, cal, True)
    with exact_jax(jeng):
        want = j_qat_finetune(jeng, cal, steps=0)
    got = qat_finetune(peng, cal, steps=0)
    for k in ("loss_first", "loss_bc", "loss_last"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert got["loss_bc"] < got["loss_first"] and got["steps"] == 0
    # the bias-corrected params the two install
    g, w = np_tree(peng.p), np_tree(jeng.p)
    for p in w:
        np.testing.assert_allclose(g[p], w[p], rtol=1e-5, atol=1e-6, err_msg=str(p))


def test_qat_is_monotone_and_installs_what_it_selected(folded):
    cal = calib(1)
    _, peng = _pair(folded, cal, True)
    before = np_tree(peng.p)
    m = qat_finetune(peng, cal, steps=12, lr=3e-4, eval_every=4)
    assert m["loss_last"] <= m["loss_bc"] <= m["loss_first"] and m["loss_last"] < m["loss_first"], m
    assert m["steps"] == 12
    after = np_tree(peng.p)
    assert any(not np.array_equal(before[p], after[p]) for p in before)
    # the installed forward (params=None) is the selected candidate's real path
    for c in cal:
        x = torch.from_numpy(c)
        with torch.no_grad():
            a, b = peng(x), peng._forward(x, "quant", params=peng.p)
        for k in KEYS:
            assert torch.equal(a[k], b[k])


def test_quant_mode_needs_scales_and_collectors_stay_off(folded):
    eng = QuantEngine(folded, port_cfg(folded=True), device="cpu")
    x = torch.zeros(1, SIZE, SIZE, 3)
    for mode in ("quant", "fakequant"):
        with pytest.raises(ValueError, match="calibrated"):
            eng._forward(x, mode)
    with pytest.raises(ValueError, match="calibrate"):
        qat_finetune(eng, [np.zeros((1, SIZE, SIZE, 3), np.float32)], steps=1)
    eng.calibrate([np.random.RandomState(2).rand(1, SIZE, SIZE, 3).astype(np.float32)])
    with pytest.raises(ValueError, match="batch"):
        qat_finetune(eng, [], steps=1)
    assert eng._bc_collector is None and eng._cap_tag is None


# --------------------------------------------------------------------------- #
# the Detector
# --------------------------------------------------------------------------- #


def _det(seed=0, **kw):
    return T.Detector(variables=small_variables(seed), config=T.DetectorConfig(model=port_cfg(**kw), default_size=SIZE), device="cpu")


@pytest.fixture(scope="module")
def det_inputs():
    rng = np.random.RandomState(3)
    return rng.randint(0, 255, (4, SIZE, SIZE, 3), np.uint8), rng.randint(0, 255, (2, SIZE, SIZE, 3), np.uint8)


def test_detector_guards_match_jax(det_inputs):
    calib_u8, _ = det_inputs
    det = _det()
    with pytest.raises(ValueError, match="qat_steps"):
        det.quantize(scales={"stem": 1.0}, qat_steps=5)
    with pytest.raises(ValueError, match="adaround_steps"):
        det.quantize(scales={"stem": 1.0}, adaround_steps=5)
    with pytest.raises(ValueError, match="quant_params requires scales"):
        det.quantize(calib_images=calib_u8, quant_params={})
    with pytest.raises(ValueError, match="quant_variables requires"):
        det.quant_variables
    assert det._quant is None and det.weights_version == 0
    assert det.last_qat_metrics is None and det.last_adaround_report is None


@pytest.fixture(scope="module")
def tuned(det_inputs, tmp_path_factory):
    """A port Detector fine-tuned (AdaRound 3 steps, then QAT 6 steps), its
    scales and quant_variables persisted, and its detections."""
    calib_u8, imgs = det_inputs
    det = _det()
    v0 = det.weights_version
    scales = det.quantize(calib_images=calib_u8, int8_dw=True, adaround_steps=3, qat_steps=6)
    assert det.weights_version == v0 + 1
    d = tmp_path_factory.mktemp("qat")
    sp, pp = str(d / "scales.json"), str(d / "qat.safetensors")
    save_quant_scales(scales, sp)
    save_safetensors(det.quant_variables, pp)
    return det, scales, sp, pp, det.detect_batch(imgs, score_thresh=-1.0)


def test_detector_fine_tunes_and_reports(tuned, det_inputs):
    det, scales, _, _, got = tuned
    m, rep = det.last_qat_metrics, det.last_adaround_report
    assert set(m) == {"loss_first", "loss_bc", "loss_last", "steps"} and m["steps"] == 6
    assert m["loss_last"] <= m["loss_bc"] <= m["loss_first"]
    assert {"_e2e_first", "_e2e_last", "_accepted"} <= set(rep)
    if rep["_accepted"]:
        assert any(k.startswith("w:") for k in scales)
    assert all(np.isfinite(r.scores).all() for r in got)
    # the float weights are untouched: dequantize goes back to the bf16 forward
    fresh = _det()
    det.dequantize()
    for a, b in zip(det.detect_batch(det_inputs[1], score_thresh=-1.0),
                    fresh.detect_batch(det_inputs[1], score_thresh=-1.0)):
        np.testing.assert_array_equal(a.scores, b.scores)


def test_quant_variables_install_bit_equal(tuned, det_inputs):
    _, _, sp, pp, want = tuned
    imgs = det_inputs[1]
    for qp in (load_safetensors(pp)["params"], load_safetensors(pp)):  # the tree, or its {"params": } wrapper
        det2 = _det(seed=1)  # other float weights on purpose
        det2.quantize(scales=load_quant_scales(sp), quant_params=qp)
        for a, b in zip(det2.detect_batch(imgs, score_thresh=-1.0), want):
            np.testing.assert_array_equal(a.scores, b.scores)
            np.testing.assert_array_equal(a.boxes, b.boxes)


def test_quant_variables_serve_in_jax(tuned, folded):
    """The JAX engine installs the port's persisted pair as the JAX
    Detector's quantize(scales=, quant_params=) does; its quant head maps
    (jitted with `jit_exact`) equal the port's to one float32 ulp, where
    XLA fuses the last epilogue's multiply-add (2 of 512 values)."""
    from tpucenterface.weights.io import load_quant_scales as jload_scales
    from tpucenterface.weights.io import load_safetensors as jload

    _, _, sp, pp, _ = tuned
    scales = jload_scales(sp)
    # the Detector's engine config: folded, fused heads, the stem-baked input
    cfg = dataclasses.replace(JCFG, folded=True, fused_heads=True, stem_preprocess=True)
    jeng = JQuantEngine(folded, cfg, int8_dw=bool(scales["cfg:int8_dw"]), pp_cfg=JPre())
    jeng.set_scales(scales)
    jeng.p = jax.tree.map(jnp.asarray, jload(pp)["params"])
    port = _det(seed=1)
    port.quantize(scales=load_quant_scales(sp), quant_params=load_safetensors(pp))
    x = calib(5, n=1)[0] * 100.0
    st = {t: jeng._act_scale(t) for t in jeng.act_scales}
    ws = {t: jnp.asarray(s) for t, s in jeng.weight_scales.items()}
    stem = jnp.float32(jeng._stem_fixed_scale())

    def fwd(p, st, ws, stem, x):
        jeng._act_scale, jeng.weight_scales = (lambda tag: st[tag]), ws
        jeng._stem_fixed_scale = lambda: stem
        try:
            return jeng._forward(x, "quant", p)
        finally:
            del jeng._act_scale, jeng._stem_fixed_scale

    want = jit_exact(fwd, jeng.p, st, ws, stem, jnp.asarray(x))
    got = port._quant(torch.from_numpy(x))
    for k in ("hm", "wh", "off"):
        # the jitted epilogue may fuse y * scale + b: one float32 ulp (or 1e-9
        # where y * scale and b cancel)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2.0 ** -22, atol=1e-9, err_msg=k)


def test_fused_blocks_serve_the_tuned_params(tuned, det_inputs, monkeypatch):
    """quantize(fused_blocks=True) fine-tunes on the per-conv route, then the
    block kernel (its plain version on the CPU) serves the tuned weights:
    bit-equal to the persisted pair installed on the fused route, and not
    the untuned weights' result."""
    import tpucenterface_torch.ops.int8_block as ib

    _, scales, sp, pp, _ = tuned
    calls = []
    wrapper = ib.int8_block_s1

    def counting(x, inv_se, packed, **kw):
        calls.append(tuple(x.shape))
        return wrapper(x, inv_se, packed, **kw)

    monkeypatch.setattr(ib, "int8_block_s1", counting)
    calib_u8, _ = det_inputs
    det = _det()
    det.quantize(calib_images=calib_u8, int8_dw=True, qat_steps=4, fused_blocks=True)
    blocks = det._quant.fused_block_indices()
    assert blocks == [4, 6]
    x = torch.from_numpy(calib(6, n=1)[0])
    calls.clear()
    got = det._quant(x)
    assert len(calls) == len(blocks)
    again = _det(seed=1)
    again.quantize(scales=dict(det._quant.act_scales, **{"cfg:int8_dw": 1}),
                   quant_params=det.quant_variables, fused_blocks=True)
    plain = _det()
    plain.quantize(scales=dict(det._quant.act_scales, **{"cfg:int8_dw": 1}), fused_blocks=True)
    want, untuned = again._quant(x), plain._quant(x)
    for k in ("hm", "wh", "off"):
        assert torch.equal(got[k], want[k]), k
    assert not torch.equal(got["hm"], untuned["hm"])


@pytest.mark.slow
@pytest.mark.parametrize("config", ["int8_dw_qat", "w4_adaround"])
def test_flagship_fine_tuned_ap_matches_jax(tmp_path, monkeypatch, config):
    """The port's fine-tuned flagship against the JAX package's
    (`cli/flagship_pins.py`'s int8_dw_qat: 60 QAT steps; w4_adaround: W4 with
    40 AdaRound steps). The JAX Detector calibrates on eight frames; each
    package fine-tunes its own engine from those scales (the JAX package
    under `exact_jax`, as every JAX reference of this file) and installs the
    result through quantize(scales=..., quant_params=...). Held:

    - what comes before the first choice on the piecewise-constant loss
      (QAT's loss_first and loss_bc, AdaRound's _e2e_first): rtol
      FT_PREFIX_RTOL; QAT's loss_last: rtol FT_GAIN_RTOL;
    - AdaRound layer by layer: with every earlier layer's kernel taken from
      the JAX run, the port's rounding decisions (grid indices) equal JAX's
      on at least FT_FORCED_EQUAL of each layer's weights, and the
      end-to-end loss of the result within FT_PREFIX_RTOL of JAX's;
    - AP on tests/test_flagship_anchor.py's 24-scene split within
      FT_AP_SPREAD per split. After tens of steps the two runs part where a
      decision flips, and so do two runs of one package whose float32 sums
      are taken in other orders: FT_AP_SPREAD is the largest such spread
      measured (see its comment), not a port tolerance.
    """
    import importlib
    import os

    from tpucenterface.config import DecodeConfig as JDecode
    from tpucenterface.data.synth import generate_dataset, render_scene
    from tpucenterface.eval.synth_eval import ap_on_records
    from tpucenterface.preprocess import letterbox_normalize_batch
    from tpucenterface.quant.adaround import adaround as j_adaround
    from tpucenterface.weights.io import load_safetensors as jax_load
    from tpucenterface_torch.quant import adaround

    pada = importlib.import_module("tpucenterface_torch.quant.adaround")  # the package exports a function of that name
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    artifact = os.path.join(root, "artifacts", "flagship.safetensors")
    recs = generate_dataset(str(tmp_path), 24, seed=7777, hw_range=(384, 512), min_face=18.0)
    rng = np.random.RandomState(0)
    frames = np.stack([render_scene(rng, hw=(320, 320))[0] for _ in range(8)])
    kw = dict(int8_dw=True) if config == "int8_dw_qat" else dict(int8_dw=True, weight_bits=4)
    jcfg = JDetectorConfig(decode=JDecode(max_dets=100), default_size=320)
    ref = JDetector(variables=jax_load(artifact), config=jcfg)
    scales = ref.quantize(calib_images=frames, **kw)
    hws = np.tile(np.array([320, 320], np.int32)[None], (8, 1))
    # the JAX Detector's calibration batch (bf16); the port takes its values
    # as float32, each exact in bf16
    x = letterbox_normalize_batch(jnp.asarray(frames), jnp.asarray(hws), 320, ref.config.preprocess,
                                  raw=ref.config.model.stem_preprocess)[0]

    def tune(eng, qat, ada, xs):
        eng.set_scales(scales)
        rep = qat(eng, xs, steps=60) if config == "int8_dw_qat" else ada(eng, xs, steps=40)
        out = dict(eng.act_scales, **{f"w:{t}": np.asarray(s) for t, s in eng.weight_scales.items()})
        out.update({"cfg:int8_dw": int(eng.int8_dw), "cfg:weight_bits": eng.weight_bits})
        return rep, out, eng.p

    port = T.Detector.from_safetensors(
        artifact, T.DetectorConfig(decode=T.DecodeConfig(max_dets=100, use_pallas=True), default_size=320),
        device="cpu")

    def port_engine():
        eng = QuantEngine(port.variables, port.config.model, pp_cfg=port.config.preprocess, device="cpu", **kw)
        eng.set_scales(scales)
        return eng

    xs = [np.asarray(x, np.float32)]
    peng = port_engine()
    prep, ps, pp = tune(peng, qat_finetune, adaround, xs)
    port.quantize(scales=ps, quant_params=pp)
    ap_port = ap_on_records(port, recs, size=320)
    jeng = JQuantEngine(ref.variables, ref.config.model, pp_cfg=ref.config.preprocess, **kw)
    with exact_jax(jeng):
        jrep, js, jp = tune(jeng, j_qat_finetune, j_adaround, [x])
    ref.quantize(scales=js, quant_params=jp)
    ap_ref = ap_on_records(ref, recs, size=320)
    print(config, "port", ap_port, prep, "jax", ap_ref, jrep)
    for k in ("loss_first", "loss_bc") if config == "int8_dw_qat" else ("_e2e_first",):
        np.testing.assert_allclose(prep[k], jrep[k], rtol=FT_PREFIX_RTOL, err_msg=k)
    if config == "int8_dw_qat":
        np.testing.assert_allclose(prep["loss_last"], jrep["loss_last"], rtol=FT_GAIN_RTOL)
    else:
        assert prep["_accepted"] == jrep["_accepted"] == 1.0
        # the port's AdaRound again, each finished layer replaced by JAX's
        # kernel before the next layer's captures: what the port decides
        # for a layer from the same upstream
        want, kpaths = np_tree(jp), pada._kernel_paths(peng)
        tags, decided = {kp: tag for tag, kp in kpaths.items()}, {}
        real_set = pada._tree_set

        def forced(tree, path, value):
            if tuple(path) in tags:
                decided[tags[tuple(path)]] = value.detach().numpy().copy()
                value = torch.from_numpy(want[tuple(path)]).to(value.dtype)
            return real_set(tree, path, value)

        monkeypatch.setattr(pada, "_tree_set", forced)
        forced_rep = adaround(port_engine(), xs, steps=40)
        monkeypatch.undo()
        np.testing.assert_allclose(forced_rep["_e2e_last"], jrep["_e2e_last"], rtol=FT_PREFIX_RTOL)
        assert set(decided) == set(jeng.weight_scales)
        shares = {}
        for tag, k in decided.items():
            sw = np.asarray(jeng.weight_scales[tag])
            shares[tag] = float((np.round(k / sw) == np.round(want[kpaths[tag]] / sw)).mean())
        print("teacher-forced decisions equal, least layers:", sorted(shares.items(), key=lambda t: t[1])[:5])
        assert min(shares.values()) >= FT_FORCED_EQUAL, shares
    for split in ap_ref:
        assert abs(ap_port[split] - ap_ref[split]) <= FT_AP_SPREAD, (split, ap_port, ap_ref)
