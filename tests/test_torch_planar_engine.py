"""The port's PlanarEngine against the JAX PlanarEngine, and the port's
Detector with `inference_engine="planar"` against its module forward and the
JAX Detector.

The default model (width 1.0, all 17 blocks) at a 128 px input, where with
`max_chain_res=96` every stride-1 run is a chain: blocks 0, 2, 4-5, 7-12 and
14-16 (lengths [1, 1, 2, 6, 3]; [1, 2, 6, 3] with the algebraic fusion, which
leaves block 0 its depthwise only). The same folded variables (drawn by the
JAX package's `init_model`, BatchNorm statistics and affine randomized with
numpy, folded by each package's own fold) and the same numpy input go through
both engines; the JAX chains run in interpret mode, the port's take their
plain version on the CPU.

Tolerances on hm/wh/off:
- no chain, float32: both engines are float32 convolutions of the same
  weights and differ in summation order only: atol 1e-4 (the composed weights
  of the algebraic fusion are bit-equal, computed in numpy float32 on both
  sides; measured up to 2e-5);
- chains, bfloat16: the chains themselves are bit-equal on the CPU
  (tests/test_torch_planar_mbconv.py), but around them bfloat16 rounds at
  other places in the two frameworks (convolution epilogues), as in
  tests/test_torch_fast_engine.py, whose bound this is: atol 0.08, rtol 0.05,
  with the value reached asserted as well (`REACHED`), so a drift shows.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import tpucenterface_torch as T
import tpucenterface_torch.model.planar_engine as pe
from tpucenterface.config import ModelConfig as JModel
from tpucenterface.model.centernet import init_model as jinit
from tpucenterface.model.planar_engine import PlanarEngine as JPlanarEngine
from tpucenterface.weights.fold import fold_variables as jfold
from tpucenterface_torch.config import ModelConfig
from tpucenterface_torch.detector import PLANAR_CHAIN_RES
from tpucenterface_torch.model.centernet import load_network
from tpucenterface_torch.model.planar_engine import PlanarEngine, chain_runs
from tpucenterface_torch.ops.planar_mbconv import planar_mbconv_chain
from tpucenterface_torch.weights.convert import chain_blocks_from_run
from tpucenterface_torch.weights.fold import fold_variables

from test_torch_fast_engine import _randomize_bn
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

SIZE = 128
F32_ATOL = 1e-4
ATOL, RTOL = 0.08, 0.05
# the largest |port - JAX| over hm/wh/off with chains on, measured on the CPU
# over the four (fusion, heads) cases (0.0116), rounded up
REACHED = 0.02


@pytest.fixture(scope="module")
def unfolded():
    _, v = jinit(JModel(), rng=jax.random.PRNGKey(4), input_size=SIZE)
    return _randomize_bn(v, seed=1)


@pytest.fixture(scope="module")
def x():
    return (np.random.RandomState(0).rand(2, SIZE, SIZE, 3) * 2 - 1).astype(np.float32)


def _maps(out):
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _worst(got, ref, atol, rtol):
    worst = 0.0
    for k in ("hm", "wh", "off"):
        a, b = got[k], ref[k]
        assert a.dtype == np.float32 and a.shape == b.shape == (2, SIZE // 4, SIZE // 4, a.shape[-1])
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=k)
        worst = max(worst, float(np.abs(a - b).max()))
    return worst


def _engines(unfolded, dtype, fusion, fuse_heads, max_chain_res):
    jeng = JPlanarEngine(
        jfold(unfolded, fuse_heads=fuse_heads), JModel(compute_dtype=dtype), max_chain_res=max_chain_res,
        algebraic_fusion=fusion, interpret=True,
    )
    cfg = ModelConfig(compute_dtype=dtype, folded=True, fused_heads=fuse_heads)
    eng = PlanarEngine(
        fold_variables(unfolded, fuse_heads=fuse_heads), cfg, max_chain_res=max_chain_res, algebraic_fusion=fusion,
        device="cpu",
    )
    return eng, jeng


@pytest.mark.parametrize("fuse_heads", [False, True])
@pytest.mark.parametrize("fusion", [False, True])
def test_no_chain_float32_matches_jax_engine(unfolded, x, fusion, fuse_heads):
    eng, jeng = _engines(unfolded, "float32", fusion, fuse_heads, 0)
    assert (eng.fuse_b0_b1, eng.fuse_top_lateral) == (jeng.fuse_b0_b1, jeng.fuse_top_lateral) == (fusion, fusion)
    if fusion:  # the composed weights are bit-equal
        for blk, scope in (("block_1", "expand"), ("block_16", "project")):
            for leaf in ("kernel", "bias"):
                np.testing.assert_array_equal(
                    eng.params["backbone"][blk][scope]["conv"][leaf],
                    np.asarray(jeng.p["backbone"][blk][scope]["conv"][leaf]),
                )
    with torch.inference_mode():
        got = _maps({k: v.numpy() for k, v in eng(torch.from_numpy(x)).items()})
    _worst(got, _maps(jax.jit(jeng)(x)), F32_ATOL, 0)
    assert eng.chain_runs(SIZE) == []


@pytest.mark.parametrize("fuse_heads", [False, True])
@pytest.mark.parametrize("fusion", [False, True])
def test_chains_bfloat16_match_jax_engine(unfolded, x, fusion, fuse_heads):
    eng, jeng = _engines(unfolded, "bfloat16", fusion, fuse_heads, 96)
    with torch.inference_mode():
        got = _maps({k: v.numpy() for k, v in eng(torch.from_numpy(x)).items()})
    assert _worst(got, _maps(jeng(x)), ATOL, RTOL) <= REACHED
    if fuse_heads:
        assert np.array_equal(got["whoff"][..., :2], got["wh"])


def test_chains_match_the_ports_network(unfolded, x):
    """Chains on against the module forward on the same weights, and the
    chains did run (the maps differ somewhere)."""
    cfg = ModelConfig(folded=True)
    folded = fold_variables(unfolded)
    eng = PlanarEngine(folded, cfg, max_chain_res=96, device="cpu")
    net = load_network(folded, cfg, torch.device("cpu"))
    with torch.inference_mode():
        got = _maps({k: v.numpy() for k, v in eng(torch.from_numpy(x)).items()})
        ref = _maps({k: v.numpy() for k, v in net(torch.from_numpy(x)).items()})
    assert _worst(got, ref, ATOL, RTOL) <= REACHED
    assert any((got[k] != ref[k]).any() for k in ref)


def test_without_chains_the_engine_is_the_network(unfolded, x):
    folded = fold_variables(unfolded, fuse_heads=True)
    cfg = ModelConfig(folded=True, fused_heads=True)
    eng = PlanarEngine(folded, cfg, device="cpu")
    net = load_network(folded, cfg, torch.device("cpu"))
    with torch.inference_mode():
        got, ref = eng(torch.from_numpy(x)), net(torch.from_numpy(x))
    assert set(got) == {"hm", "wh", "off", "whoff"}
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("fusion,expected", [(True, [1, 2, 6, 3]), (False, [1, 1, 2, 6, 3])])
def test_engine_runs_the_chains(unfolded, monkeypatch, fusion, expected):
    """tests/test_planar_engine.py::test_planar_engine_uses_chains for the
    port: at 128 px every stride-1 run is at most 96 rows high."""
    calls = []

    def spy(xx, run, **kw):
        calls.append((len(run), kw["H"], kw["W"], tuple(xx.shape)))
        return planar_mbconv_chain(xx, run, **kw)

    monkeypatch.setattr(pe, "planar_mbconv_chain", spy)
    eng = PlanarEngine(fold_variables(unfolded), ModelConfig(folded=True), max_chain_res=96,
                       algebraic_fusion=fusion, device="cpu")
    with torch.inference_mode():
        eng(torch.zeros(1, SIZE, SIZE, 3))
    assert [c[0] for c in calls] == expected
    assert [n for _, n in eng.chain_runs(SIZE)] == expected
    assert calls[-1][1:] == (4, 4, (1, 160, 4 * 32))       # blocks 14-16 on a 4x4 map, Wp = 32
    assert calls[-2][1:] == (8, 8, (1, 64, 8 * 16))        # blocks 7-12 on an 8x8 map, Wp = 16


def test_which_runs_are_chains():
    """The run finder on the default model without running the network, at
    the Detector's `PLANAR_CHAIN_RES`: three chains at 640, four at 320."""
    cfg = ModelConfig(folded=True)
    assert PLANAR_CHAIN_RES == 80
    assert chain_runs(cfg, 640, PLANAR_CHAIN_RES) == [(4, 2), (7, 6), (14, 3)]
    assert chain_runs(cfg, 320, PLANAR_CHAIN_RES) == [(2, 1), (4, 2), (7, 6), (14, 3)]
    assert chain_runs(cfg, 1024, PLANAR_CHAIN_RES) == [(7, 6), (14, 3)]
    assert chain_runs(cfg, 128, 96) == [(0, 1), (2, 1), (4, 2), (7, 6), (14, 3)]
    assert chain_runs(cfg, 128, 96, fuse_b0_b1=True) == [(2, 1), (4, 2), (7, 6), (14, 3)]
    assert chain_runs(cfg, 640, 0) == []
    # a letterbox bucket that is not square: the height decides
    assert chain_runs(cfg, 352, PLANAR_CHAIN_RES) == [(4, 2), (7, 6), (14, 3)]


def test_chain_blocks_carried_across_by_value(unfolded):
    """A run of folded flax blocks -> the chain's block list: values one by
    one, `skip` where a block keeps its width (planar_engine.py:223-226)."""
    folded = fold_variables(unfolded)
    bb = folded["params"]["backbone"]
    run = chain_blocks_from_run([bb[f"block_{i}"] for i in range(7, 13)], 64)
    assert [b["skip"] for b in run] == [True, True, True, False, True, True]
    assert [b["w2"].shape for b in run] == [(384, 64)] * 3 + [(384, 96), (576, 96), (576, 96)]
    for blk, i in zip(run, range(7, 13)):
        src = bb[f"block_{i}"]
        np.testing.assert_array_equal(blk["w1"], src["expand"]["conv"]["kernel"][0, 0])
        np.testing.assert_array_equal(blk["wd"], src["depthwise"]["conv"]["kernel"][:, :, 0, :])
        np.testing.assert_array_equal(blk["b2"], src["project"]["conv"]["bias"])
    first = chain_blocks_from_run([bb["block_0"]], 32)[0]
    assert first["w1"] is None and first["b1"] is None and first["skip"] is False


def test_blocks_outside_the_chains_take_the_modules(unfolded, x, monkeypatch):
    """With `max_chain_res` below the first maps, blocks 0 and 2 stay with the
    modules (one call each, no chain of one) and the later runs are chains;
    the result is that of the engine without chains, at the bfloat16 bound."""
    chains = []

    def spy(xx, run, **kw):
        chains.append((len(run), kw["H"]))
        return planar_mbconv_chain(xx, run, **kw)

    monkeypatch.setattr(pe, "planar_mbconv_chain", spy)
    cfg = ModelConfig(folded=True)
    folded = fold_variables(unfolded)
    eng = PlanarEngine(folded, cfg, max_chain_res=16, device="cpu")
    base = PlanarEngine(folded, cfg, device="cpu")
    seen = []
    for i in range(len(eng.plan)):
        getattr(eng.net.backbone, f"block_{i}").register_forward_hook(lambda m, a, o, i=i: seen.append(i))
    with torch.inference_mode():
        got = _maps({k: v.numpy() for k, v in eng(torch.from_numpy(x)).items()})
        ref = _maps({k: v.numpy() for k, v in base(torch.from_numpy(x)).items()})
    assert chains == [(2, 16), (6, 8), (3, 4)] and base.chain_runs(SIZE) == []
    assert seen == [0, 1, 2, 3, 6, 13]
    assert _worst(got, ref, ATOL, RTOL) <= REACHED


def test_engine_rejects_what_it_cannot_run(unfolded):
    with pytest.raises(ValueError, match="folded"):
        PlanarEngine(unfolded, ModelConfig(), device="cpu")
    folded = fold_variables(unfolded)
    f32 = ModelConfig(folded=True, compute_dtype="float32")
    with pytest.raises(ValueError, match="bfloat16"):
        PlanarEngine(folded, f32, max_chain_res=80, device="cpu")
    PlanarEngine(folded, f32, device="cpu")  # no kernel on: float32 is fine
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PlanarEngine(folded, ModelConfig(folded=True))


# --------------------------------------------------------------------------- #
# (e) the Detector
# --------------------------------------------------------------------------- #


def _planar(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, inference_engine="planar"))


def test_detector_planar_matches_module_forward_and_jax():
    """tests/test_planar_engine.py::test_detector_engine_flag_matches_flax for
    the port, on the flagship weights at 320 on the CPU (the chains take their
    plain version), both bfloat16: the bound of the bfloat16 port-against-JAX
    test (tests/test_torch_detector.py). The JAX Detector's planar engine
    (which runs no chain) on the same scenes is held to the same bound."""
    from test_torch_detector import ARTIFACT, SIZE as DSIZE, THRESH, _configs, _scenes, match_detections
    from tpucenterface.detector import Detector as JDetector
    from tpucenterface.weights.io import load_safetensors as jax_load

    scenes = _scenes(2)
    port_cfg, jax_cfg = _configs("bfloat16")
    base = T.Detector.from_safetensors(ARTIFACT, port_cfg, device="cpu")
    planar = T.Detector.from_safetensors(ARTIFACT, _planar(port_cfg), device="cpu")
    assert isinstance(planar._engine, PlanarEngine) and base._engine is None
    assert planar.model is planar._engine.net
    assert planar._engine.max_chain_res == PLANAR_CHAIN_RES
    assert [n for _, n in planar._engine.chain_runs(DSIZE)] == [1, 2, 6, 3]
    jref = JDetector(variables=jax_load(ARTIFACT), config=_planar(jax_cfg))
    assert jref._engine is not None
    bd = base.detect_batch(scenes, score_thresh=THRESH)
    pd = planar.detect_batch(scenes, score_thresh=THRESH)
    jd = jref.detect_batch(scenes, score_thresh=THRESH)
    for a, b, j in zip(pd, bd, jd):
        assert (a.scores >= 0.1).sum() > 0
        match_detections(a, b, box_atol=2.0, score_atol=0.03, firm=0.1)
        match_detections(a, j, box_atol=2.0, score_atol=0.03, firm=0.1)
    assert any(len(a.scores) != len(b.scores) or (a.scores != b.scores).any() for a, b in zip(pd, bd))


def test_detector_planar_needs_bfloat16_and_a_card_or_cpu():
    cfg = T.DetectorConfig(model=T.ModelConfig(inference_engine="planar", compute_dtype="float32"), default_size=64)
    with pytest.raises(ValueError, match="bfloat16"):
        T.Detector(config=cfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.Detector(config=T.DetectorConfig(model=T.ModelConfig(inference_engine="planar")))


def test_reload_weights_rebuilds_the_planar_engine():
    """The planar engine lays the chains' weights out once: after
    `reload_weights` it must run the new ones."""
    from test_torch_detector import ARTIFACT

    cfg = T.DetectorConfig(model=T.ModelConfig(inference_engine="planar"), default_size=128)
    _, other = T.model.centernet.init_model(cfg.model, seed=5)
    det = T.Detector(variables=other, config=cfg, device="cpu")
    img = np.random.RandomState(2).randint(0, 255, (128, 128, 3), np.uint8)
    before = det.detect(img, score_thresh=0.0)
    old = det._engine
    det.reload_weights(safetensors_path=ARTIFACT)
    assert det.weights_version == 1 and det._engine is not old and det.model is det._engine.net
    after = det.detect(img, score_thresh=0.0)
    fresh = T.Detector.from_safetensors(ARTIFACT, cfg, device="cpu").detect(img, score_thresh=0.0)
    assert after.scores.tobytes() == fresh.scores.tobytes() and after.boxes.tobytes() == fresh.boxes.tobytes()
    assert not np.array_equal(after.scores, before.scores)
    run = det._engine._run_blocks(4, 2, 32)
    want = det.variables["params"]["backbone"]["block_4"]["project"]["conv"]["kernel"][0, 0]
    np.testing.assert_array_equal(run[0]["w2"].numpy(), np.asarray(want))
