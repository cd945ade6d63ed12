"""The port's W8A8 quantized path against the JAX package.

- `quant.QuantEngine(fused_blocks=False)` against the JAX `QuantEngine` on the
  same folded random model at 64x64 (the JAX tests' size; BatchNorm
  statistics randomized with numpy, folded by each package's own fold):
  - calibration: bit-equal (asserted to rtol 1e-6) to the JAX engine's
    calibration run op by op (`jax.disable_jit`). The JAX engine jits its
    calibration forward, and XLA's CPU compiler then keeps some bf16
    intermediates in float32 (it drops convert pairs), so against the jitted
    calibration the per-tensor scales agree to one bf16 step (2^-7 relative,
    bound 2^-6), and the per-channel depthwise scales of near-dead channels
    can differ by far more; those are not compared;
  - quant mode, with the JAX engine's scales installed through `set_scales`:
    head maps bit-equal for int8, int8_dw and weight_bits=4 (every conv is an
    exact integer product and every epilogue rounds as the JAX engine's
    does), and within a few float32 ulps with skip_tags (`MAP_RTOL`);
  - `set_scales`'s `cfg:` guards, `percentile_linear` against jnp.percentile;
- the stem helpers against the JAX ones;
- `Detector.quantize` on the flagship weights at 320 against the JAX
  Detector's under the JAX scales: detections >= 0.1 match within 2 px and
  0.03 (the bounds of the bfloat16 port against JAX, tests/
  test_torch_detector.py; the JAX Detector's jitted program rounds the bf16
  activations at other points, as above); the scales round trip, dequantize
  and reload_weights;
- `fused_blocks=True` (the int8 block kernel's plain version on the CPU)
  against the library route: ten blocks, head maps within `FUSED_BOUND`.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucenterface_torch as T
import tpucenterface_torch.quant.engine as qe
from tpucenterface.config import DecodeConfig as JDecode
from tpucenterface.config import DetectorConfig as JDetectorConfig
from tpucenterface.config import ModelConfig as JModel
from tpucenterface.config import PreprocessConfig as JPre
from tpucenterface.data.synth import render_scene
from tpucenterface.detector import Detector as JDetector
from tpucenterface.model.centernet import init_model as jinit
from tpucenterface.quant.engine import QuantEngine as JQuantEngine
from tpucenterface.quant.engine import apply_stem_lut as jax_apply_stem_lut
from tpucenterface.quant.engine import stem_fixed_scale as jax_stem_fixed_scale
from tpucenterface.quant.engine import stem_input_lut as jax_stem_input_lut
from tpucenterface.weights.fold import fold_variables as jfold
from tpucenterface.weights.io import load_safetensors as jax_load
from tpucenterface_torch.config import ModelConfig
from tpucenterface_torch.quant.engine import QuantEngine, percentile_linear
from tpucenterface_torch.weights.fold import fold_variables
from tpucenterface_torch.weights.io import load_quant_scales, save_quant_scales
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "artifacts", "flagship.safetensors")
SIZE = 64
BF16_STEP = 2.0 ** -6   # bound on per-tensor scales against the jitted JAX calibration
BOX_ATOL, SCORE_ATOL, FIRM = 2.0, 0.03, 0.1
# fused_blocks=True against False on the CPU, both under the same scales: the
# int8 block kernel adds the residual in float32 before one bf16 rounding
# (the engine rounds the project output first), and multiplies by reciprocal
# scales where the engine divides. A bf16 step of a block's output moves the
# next block's int8 input, so the differences carry on: measured max |d| 0.043
# and mean 0.0080 over hm, wh and off (maps of std 0.2 to 0.4), twice that is
# the bound. With the library route's residual also added in float32, eight of
# the ten blocks are bit-equal to the kernel's plain version.
FUSED_BOUND = {"max": 0.09, "mean": 0.016}
# the fused route against the library route on the flagship: at most this
# share of the detections >= FIRM may lack a partner
FUSED_MATCH_SHARE = 0.95
FUSED_BLOCKS = [2, 4, 5, 7, 8, 9, 11, 12, 14, 15]
CONFIGS = {
    "int8": dict(),
    "int8_dw": dict(int8_dw=True),
    "skip_tags": dict(int8_dw=True, skip_tags=("stem", "b3.dw", "b6.project", "head.out")),
    "w4": dict(int8_dw=True, weight_bits=4),
}
# a skipped conv runs the bf16 float path, whose float32 sums XLA and torch
# take in different orders; with `head.out` skipped that shows in the maps as
# up to a few float32 ulps (measured: 1 ulp on 8 of 512 hm values, 1.5e-8 on
# wh values near 0): (rtol, atol)
MAP_TOL = {"skip_tags": (2.0 ** -21, 1e-7)}


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _randomize_bn(variables, seed=0):
    rng = np.random.RandomState(seed)
    v = _np_tree(variables)

    def rec(p, s):
        if "bn" in p:
            c = p["bn"]["scale"].shape[0]
            p["bn"]["scale"] = rng.uniform(0.7, 1.3, c).astype(np.float32)
            p["bn"]["bias"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
            s["bn"]["mean"] = rng.uniform(-0.3, 0.3, c).astype(np.float32)
            s["bn"]["var"] = rng.uniform(0.7, 1.3, c).astype(np.float32)
        for k in p:
            if isinstance(p[k], dict) and k != "bn" and k in s:
                rec(p[k], s[k])

    rec(v["params"], v["batch_stats"])
    return v


@pytest.fixture(scope="module")
def folded():
    """(JAX-folded, port-folded) variables of one random model."""
    _, v = jinit(JModel(), rng=jax.random.PRNGKey(6), input_size=SIZE)
    v = _randomize_bn(v)
    return jfold(v), fold_variables(v)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    cal = [(rng.rand(2, SIZE, SIZE, 3) * 2 - 1).astype(np.float32) for _ in range(2)]
    x = (rng.rand(2, SIZE, SIZE, 3) * 2 - 1).astype(np.float32)
    return cal, x


@pytest.fixture(scope="module")
def jax_engines(folded, data):
    """{config: JAX engine} under the JAX engine's own (jitted) calibration,
    one for each int8_dw value (skip_tags and weight_bits do not enter it)."""
    cal, _ = data
    scales = {dw: JQuantEngine(folded[0], JModel(), int8_dw=dw).calibrate(cal) for dw in (False, True)}
    out = {}
    for name, kw in CONFIGS.items():
        eng = JQuantEngine(folded[0], JModel(), **kw)
        eng.set_scales(scales[eng.int8_dw])
        out[name] = eng
    return out


def _port_engine(folded, **kw):
    return QuantEngine(folded[1], ModelConfig(folded=True), device="cpu", **kw)


# --------------------------------------------------------------------------- #
# calibration
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("int8_dw,pct", [(True, None), (True, 99.9)], ids=["amax", "p99.9"])
def test_calibration_equals_jax_op_by_op(folded, data, int8_dw, pct):
    cal, _ = data
    with jax.disable_jit():
        want = JQuantEngine(folded[0], JModel(), int8_dw=int8_dw).calibrate(cal, percentile=pct)
    got = _port_engine(folded, int8_dw=int8_dw).calibrate(cal, percentile=pct)
    assert set(got) == set(want)
    per_channel = 0
    for k in want:
        assert isinstance(got[k], np.ndarray) == isinstance(want[k], np.ndarray), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
        per_channel += isinstance(want[k], np.ndarray)
    assert per_channel == 17  # the depthwise convs; every other entry is per tensor


def test_calibration_near_jitted_jax(folded, data, jax_engines):
    got = _port_engine(folded, int8_dw=True).calibrate(data[0])
    want = jax_engines["int8_dw"].act_scales
    scalars = [k for k in want if not isinstance(want[k], np.ndarray)]
    worst = max(abs(got[k] - want[k]) / want[k] for k in scalars)
    assert worst <= BF16_STEP, worst


def test_percentile_matches_jax_and_numpy():
    """Bit-equal to jnp.percentile run op by op. The compiled jnp.percentile
    takes its position and weights in other float32 steps, and numpy takes the position in float64, where float32 rounds it
    to 2^-10 at n = 15005, times the gap of the two order statistics
    (measured 1.5e-4 on values up to 4.4)."""
    rng = np.random.RandomState(4)
    a = np.abs(rng.randn(3001, 5)).astype(np.float32)
    a[::7] = 0.25  # ties
    for q in (50.5, 99.0, 99.9, 100.0):
        for dim in (None, 0):
            got = percentile_linear(torch.from_numpy(a), q, dim=dim).numpy()
            with jax.disable_jit():
                want = np.asarray(jnp.percentile(jnp.asarray(a), q, axis=dim))
            np.testing.assert_array_equal(got, want)
            np.testing.assert_allclose(got, np.asarray(jnp.percentile(jnp.asarray(a), q, axis=dim)), rtol=0, atol=5e-4)
            np.testing.assert_allclose(got, np.percentile(a, q, axis=dim), rtol=0, atol=5e-4)


def test_calibrate_rejects_a_bad_percentile(folded):
    with pytest.raises(ValueError, match="percentile"):
        _port_engine(folded).calibrate([], percentile=40.0)


# --------------------------------------------------------------------------- #
# quant mode
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", list(CONFIGS))
def test_quant_maps_bit_equal_under_jax_scales(folded, data, jax_engines, name):
    _, x = data
    jeng = jax_engines[name]
    scales = dict(jeng.act_scales, **{"cfg:int8_dw": int(jeng.int8_dw), "cfg:weight_bits": jeng.weight_bits})
    peng = _port_engine(folded, **CONFIGS[name])
    peng.set_scales(scales)
    want = jeng(jnp.asarray(x))
    got = peng(torch.from_numpy(x))
    for k in ("hm", "wh", "off", "whoff"):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == np.float32 and g.shape == w.shape == (2, SIZE // 4, SIZE // 4, w.shape[-1])
        rtol, atol = MAP_TOL.get(name, (0.0, 0.0))
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=k)
    # and the quantized maps are not the float ones
    assert not np.array_equal(peng.float_forward(torch.from_numpy(x))["hm"].numpy(), got["hm"].numpy())


def test_set_scales_guards_and_weight_scales(folded, jax_engines):
    eng = _port_engine(folded, int8_dw=True)
    scales = dict(jax_engines["int8_dw"].act_scales)
    with pytest.raises(ValueError, match="weight_bits=4"):
        eng.set_scales({**scales, "cfg:weight_bits": 4})
    with pytest.raises(ValueError, match="int8_dw=False"):
        eng.set_scales({**scales, "cfg:int8_dw": 0})
    # "w:<tag>" fixed weight scales are installed, then dropped by a dict without them
    sw = np.full(16, 0.01, np.float32)
    eng.set_scales({**scales, "w:b0.project": sw})
    np.testing.assert_array_equal(eng.weight_scales["b0.project"], sw)
    kq, got_sw = eng.quant_weight("b0.project")
    np.testing.assert_array_equal(got_sw, sw)
    eng.set_scales({k: v.tolist() if isinstance(v, np.ndarray) else v for k, v in scales.items()})
    assert eng.weight_scales == {}
    assert isinstance(eng.act_scales["b3.dw"], np.ndarray)


def test_engine_rejects_what_it_cannot_run(folded):
    with pytest.raises(ValueError, match="weight_bits"):
        _port_engine(folded, weight_bits=9)
    with pytest.raises(ValueError, match="int8_dw"):
        _port_engine(folded, fused_blocks=True)
    _, v = jinit(JModel(head_conv=0), rng=jax.random.PRNGKey(1), input_size=SIZE)
    with pytest.raises(ValueError, match="head_conv"):
        QuantEngine(fold_variables(_np_tree(v)), ModelConfig(folded=True, head_conv=0), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            QuantEngine(folded[1], ModelConfig(folded=True))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            qe.stem_input_lut(T.PreprocessConfig())


def test_uncalibrated_engine_runs_float(folded, data):
    eng = _port_engine(folded)
    out = eng(torch.from_numpy(data[1]))
    assert torch.equal(out["hm"], eng.float_forward(torch.from_numpy(data[1]))["hm"])


# --------------------------------------------------------------------------- #
# the fused route
# --------------------------------------------------------------------------- #


def test_fused_blocks_route_on_cpu(folded, data, jax_engines, monkeypatch):
    import tpucenterface_torch.ops.int8_block as ib

    scales = jax_engines["int8_dw"].act_scales
    lib = _port_engine(folded, int8_dw=True)
    fused = _port_engine(folded, int8_dw=True, fused_blocks=True)
    lib.set_scales(scales)
    fused.set_scales(scales)
    assert fused.fused_block_indices() == FUSED_BLOCKS and lib.fused_block_indices() == []
    calls = []
    wrapper = ib.int8_block_s1

    def counting(x, inv_se, packed, **kw):
        calls.append(tuple(x.shape))
        assert isinstance(packed, ib.PackedInt8BlockS1)
        return wrapper(x, inv_se, packed, **kw)

    monkeypatch.setattr(ib, "int8_block_s1", counting)
    x = torch.from_numpy(data[1] * 40).to(torch.bfloat16)
    got, want = fused(x), lib(x)
    assert len(calls) == 10 and calls[0] == (2, 16, 16, 24) and calls[-1] == (2, 2, 2, 160)
    worst = 0.0
    for k in ("hm", "wh", "off"):
        d = (got[k] - want[k]).abs()
        assert d.max().item() <= FUSED_BOUND["max"] and d.mean().item() <= FUSED_BOUND["mean"], (k, d.max(), d.mean())
        worst = max(worst, d.max().item())
    assert worst > 0  # the blocks did take the other route
    # a skipped conv keeps its block on the library route
    part = _port_engine(folded, int8_dw=True, fused_blocks=True, skip_tags=("b4.dw",))
    assert part.fused_block_indices() == [i for i in FUSED_BLOCKS if i != 4]


# --------------------------------------------------------------------------- #
# stem helpers
# --------------------------------------------------------------------------- #


def test_stem_helpers_match_jax():
    for mean in ((0.408, 0.447, 0.470), (0.5, 0.5, 0.5), (0.1, 0.9, 0.3)):
        pp, jpp = T.PreprocessConfig(mean=mean), JPre(mean=mean)
        assert qe.stem_fixed_scale(pp) == jax_stem_fixed_scale(jpp)
        lut = qe.stem_input_lut(pp, device="cpu")
        want = jax_stem_input_lut(jpp)
        assert lut.dtype == np.int8 and lut.shape == (256, 3)
        np.testing.assert_array_equal(lut, want)
    imgs = np.random.RandomState(2).randint(0, 256, (2, 7, 9, 3)).astype(np.uint8)
    np.testing.assert_array_equal(qe.apply_stem_lut(imgs, lut), jax_apply_stem_lut(imgs, want))


# --------------------------------------------------------------------------- #
# the Detector
# --------------------------------------------------------------------------- #


def _scenes(n, seed, hw):
    rng = np.random.RandomState(seed)
    return np.stack([render_scene(rng, hw=hw)[0] for _ in range(n)])


def count_unmatched(port, ref):
    """(detections of either side scoring >= FIRM, those of them with no
    partner on the other side within BOX_ATOL px (all corners) and
    SCORE_ATOL), over lists of Detections."""
    n = bad = 0
    for x, y in zip(port, ref):
        for a, b in ((x, y), (y, x)):
            sel = a.scores >= FIRM
            n += int(sel.sum())
            if not sel.any():
                continue
            dist = np.abs(a.boxes[sel][:, None, :] - b.boxes[None, :, :]).max(axis=-1)
            close = np.abs(a.scores[sel][:, None] - b.scores[None, :]) <= SCORE_ATOL
            bad += int((~((dist <= BOX_ATOL) & close).any(axis=1)).sum())
    return n, bad


@pytest.fixture(scope="module")
def flagship_quant():
    """The JAX Detector on the flagship weights at 320, quantized (int8_dw)
    on four frames; its detections of three scenes."""
    calib = _scenes(4, 5, (320, 320))
    ref = JDetector(variables=jax_load(ARTIFACT), config=JDetectorConfig(decode=JDecode(fast_topk=False),
                                                                        default_size=320))
    scales = ref.quantize(calib_images=calib, int8_dw=True)
    scenes = _scenes(3, 11, (384, 512))
    hws = np.array([[384, 512], [300, 512], [384, 401]], np.int32)
    return calib, scales, scenes, hws, ref.detect_batch(scenes, hws=hws, score_thresh=0.05)


def _port_flagship(**kw):
    cfg = T.DetectorConfig(decode=T.DecodeConfig(use_pallas=True), default_size=320, **kw)
    return T.Detector.from_safetensors(ARTIFACT, cfg, device="cpu")


def test_flagship_quantize_matches_jax_detector(flagship_quant):
    calib, scales, scenes, hws, want = flagship_quant
    port = _port_flagship()
    own = port.quantize(calib_images=calib, int8_dw=True)
    assert set(own) == set(scales) and own["cfg:int8_dw"] == 1 and own["cfg:weight_bits"] == 8
    scalars = [k for k in scales if not k.startswith("cfg:") and not isinstance(scales[k], np.ndarray)]
    assert max(abs(own[k] - scales[k]) / scales[k] for k in scalars) <= BF16_STEP
    port.quantize(scales=scales)
    got = port.detect_batch(scenes, hws=hws, score_thresh=0.05)
    n, bad = count_unmatched(got, want)
    assert n >= 20 and bad == 0, (n, bad)
    # the fused route under the same scales finds the same faces
    port.quantize(scales=scales, fused_blocks=True)
    fused = port.detect_batch(scenes, hws=hws, score_thresh=0.05)
    n, bad = count_unmatched(fused, got)
    assert n >= 20 and bad <= (1.0 - FUSED_MATCH_SHARE) * n, (n, bad)


@pytest.fixture(scope="module")
def small_det_inputs():
    rng = np.random.RandomState(17)
    return rng.randint(0, 255, (4, SIZE, SIZE, 3), np.uint8), rng.randint(0, 255, (2, SIZE, SIZE, 3), np.uint8)


@pytest.fixture(scope="module")
def small_variables():
    """The default model's JAX init at seed 0 (one JAX run, shared by the
    Detector cases below) as a numpy tree."""
    return _np_tree(jinit(JModel(), rng=jax.random.PRNGKey(0), input_size=SIZE)[1])


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else np.array(v) for k, v in tree.items()}


def _small_det(variables):
    return T.Detector(variables=_copy(variables), config=T.DetectorConfig(default_size=SIZE), device="cpu")


def test_detector_scales_round_trip_dequantize_and_reload(small_det_inputs, small_variables, tmp_path):
    calib, imgs = small_det_inputs
    det = _small_det(small_variables)
    bf16 = det.detect_batch(imgs, score_thresh=-1.0)
    with pytest.raises(ValueError, match="quantize"):
        det.stem_input_lut()
    v0 = det.weights_version
    scales = det.quantize(calib_images=calib, int8_dw=True)
    assert det.weights_version == v0 + 1
    q = det.detect_batch(imgs, score_thresh=-1.0)
    assert any(not np.array_equal(a.scores, b.scores) for a, b in zip(q, bf16))
    path = str(tmp_path / "scales.json")
    save_quant_scales(scales, path)
    loaded = load_quant_scales(path)
    assert any(isinstance(v, np.ndarray) for v in loaded.values())
    fresh = _small_det(small_variables)
    assert fresh.quantize(scales=loaded, int8_dw=False).keys() == scales.keys()  # the dict's cfg wins
    assert fresh._quant.int8_dw
    for a, b in zip(fresh.detect_batch(imgs, score_thresh=-1.0), q):
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.boxes, b.boxes)
    lut = det.stem_input_lut()
    np.testing.assert_array_equal(lut, qe.stem_input_lut(det.config.preprocess, device="cpu"))
    det.dequantize()
    assert det.weights_version == v0 + 2
    for a, b in zip(det.detect_batch(imgs, score_thresh=-1.0), bf16):
        np.testing.assert_array_equal(a.scores, b.scores)
    fresh.reload_weights(variables=_copy(small_variables))
    assert fresh._quant is None
    for a, b in zip(fresh.detect_batch(imgs, score_thresh=-1.0), bf16):
        np.testing.assert_array_equal(a.scores, b.scores)


def test_quantize_guards(small_det_inputs, small_variables):
    calib, _ = small_det_inputs
    det = _small_det(small_variables)
    with pytest.raises(ValueError, match="calib_images"):
        det.quantize()
    # the JAX guards of the fine-tuning arguments (tests/test_torch_qat.py runs them)
    for kw in (dict(qat_steps=2), dict(adaround_steps=2)):
        with pytest.raises(ValueError, match="qat_steps/adaround_steps need calibration batches"):
            det.quantize(scales={"stem": 1.0}, **kw)
    with pytest.raises(ValueError, match="quant_params requires scales"):
        det.quantize(calib_images=calib, quant_params={})
    with pytest.raises(ValueError, match="int8_dw"):
        det.quantize(calib_images=calib, fused_blocks=True)
    assert det._quant is None and det.weights_version == 0
    s = det.quantize(calib_batches=[np.zeros((1, SIZE, SIZE, 3), np.float32) + 3.0], calib_percentile=99.0)
    assert s["cfg:int8_dw"] == 0
    nohead = T.Detector(variables=_np_tree(jinit(JModel(head_conv=0), rng=jax.random.PRNGKey(0), input_size=SIZE)[1]),
                        config=T.DetectorConfig(model=T.ModelConfig(head_conv=0), default_size=SIZE), device="cpu")
    with pytest.raises(ValueError, match="head_conv"):
        nohead.quantize(calib_images=calib)


def test_import_leaves_jax_out():
    code = (
        "import sys; import tpucenterface_torch; "
        "import tpucenterface_torch.ops.fused_mbconv, tpucenterface_torch.model.fast_forward, "
        "tpucenterface_torch.decode.fused_nms, tpucenterface_torch.kernels.build, "
        "tpucenterface_torch.ops.planar_mbconv, tpucenterface_torch.model.planar_engine, "
        "tpucenterface_torch.quant, tpucenterface_torch.quant.engine, tpucenterface_torch.quant.int8_ops, "
        "tpucenterface_torch.ops.int8_conv, tpucenterface_torch.ops.int8_block, tpucenterface_torch.weights.convert, "
        "tpucenterface_torch.weights.io, tpucenterface_torch.kernels.sweep_b7, "
        "tpucenterface_torch.quant.qat, tpucenterface_torch.quant.adaround; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'tpucenterface')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.slow
def test_flagship_int8_dw_ap_matches_jax(tmp_path):
    """AP of the port's int8_dw Detector on the 24-scene flagship split
    (tests/test_flagship_anchor.py's split) within 0.005 of the JAX
    Detector's, under the scales the JAX Detector calibrated on eight frames
    (each package calibrating on its own gave 0.9333 against 0.9408 on the
    easy split: the jitted JAX calibration keeps bf16 activations in float32,
    see the module docstring)."""
    from tpucenterface.data.synth import generate_dataset
    from tpucenterface.eval.synth_eval import ap_on_records

    recs = generate_dataset(str(tmp_path), 24, seed=7777, hw_range=(384, 512), min_face=18.0)
    calib = _scenes(8, 0, (320, 320))
    port = T.Detector.from_safetensors(
        ARTIFACT, T.DetectorConfig(decode=T.DecodeConfig(max_dets=100, use_pallas=True), default_size=320),
        device="cpu")
    ref = JDetector(variables=jax_load(ARTIFACT), config=JDetectorConfig(decode=JDecode(max_dets=100),
                                                                        default_size=320))
    port.quantize(scales=ref.quantize(calib_images=calib, int8_dw=True))
    ap_port = ap_on_records(port, recs, size=320)
    ap_ref = ap_on_records(ref, recs, size=320)
    for split in ap_ref:
        assert abs(ap_port[split] - ap_ref[split]) <= 0.005, (split, ap_port, ap_ref)
