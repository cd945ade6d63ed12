"""The port's network against flax `CenterFaceNet.apply`.

A narrow, shallow random model (width 0.5, one block per stage, 96 px), its
parameters drawn by the JAX package's `init_model` and its BatchNorm
statistics and affine randomized with numpy, so the running mean/var carry
across really is exercised. The same numpy input goes through both.

Forms: unfolded (eval BatchNorm), folded, folded with fused heads, and folded
with fused heads and the stem-baked raw input. Tolerances:
- float32: atol 2e-3 on the head maps (the bound of tests/test_parity.py:
  the two frameworks sum in other orders through ~20 conv layers);
- bfloat16: both sides round activations to bfloat16 after every layer but
  at other points (torch adds the conv bias before rounding, XLA after), so
  the maps differ by a few bfloat16 ulps of the activations. Measured on
  the CPU: at most 0.015 (mean 0.0024) on head maps whose logits average
  ~4 in magnitude; the bound is atol 0.05 and a mean of 0.005.
"""

import jax
import numpy as np
import pytest
import torch

from tpucenterface.config import ModelConfig as JModel
from tpucenterface.config import PreprocessConfig as JPre
from tpucenterface.model.centernet import CenterFaceNet as JNet
from tpucenterface.model.centernet import init_model as jinit
from tpucenterface.weights.fold import fold_variables as jfold
from tpucenterface_torch.config import ModelConfig, PreprocessConfig
from tpucenterface_torch.model.backbone import backbone_plan, feature_channels
from tpucenterface_torch.model.centernet import CenterFaceNet
from tpucenterface_torch.weights.convert import state_dict_from_variables
from tpucenterface_torch.weights.fold import fold_variables, raw_pixel_offset
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

SETTING = ((1, 16, 1, 1), (6, 24, 1, 2), (6, 32, 1, 2), (6, 64, 1, 2), (6, 96, 1, 1), (6, 160, 1, 2))
SIZE = 96
F32_ATOL = 2e-3
BF16_ATOL = 0.05
BF16_MEAN = 0.005


def _kw(dtype, landmarks=False):
    return dict(
        inverted_residual_setting=SETTING,
        width_mult=0.5,
        compute_dtype=dtype,
        with_landmarks=landmarks,
    )


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _randomize(variables, seed=0):
    """BatchNorm statistics and affine away from identity, head biases
    non-zero, everything as float32 numpy."""
    rng = np.random.RandomState(seed)
    v = _np_tree(variables)

    def rec(p, s):
        if isinstance(p, dict) and "bn" in p:
            c = p["bn"]["scale"].shape[0]
            p["bn"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            p["bn"]["bias"] = rng.uniform(-0.3, 0.3, c).astype(np.float32)
            s["bn"]["mean"] = rng.uniform(-0.5, 0.5, c).astype(np.float32)
            s["bn"]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        for k in p:
            if isinstance(p[k], dict) and k != "bn":
                rec(p[k], s.setdefault(k, {}) if isinstance(s, dict) else {})

    rec(v["params"], v["batch_stats"])
    for head in v["params"]["heads"].values():
        head["conv"]["bias"] = rng.uniform(-0.2, 0.2, head["conv"]["bias"].shape).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def variables():
    _, v = jinit(JModel(**_kw("float32", landmarks=True)), rng=jax.random.PRNGKey(3), input_size=SIZE)
    return _randomize(v)


def _input(raw=False):
    rng = np.random.RandomState(1)
    if raw:
        u = rng.randint(0, 256, size=(2, SIZE, SIZE, 3)).astype(np.float32)
        return u - raw_pixel_offset(PreprocessConfig()).astype(np.float32)
    return (rng.rand(2, SIZE, SIZE, 3) * 2 - 1).astype(np.float32)


def _form(variables, form):
    """(ModelConfig overrides, port variables, JAX variables) of one form."""
    if form == "unfolded":
        return {}, variables, variables
    fuse = form != "folded"
    bake = form == "fused+raw"
    port = fold_variables(variables, fuse_heads=fuse, bake_preprocess=PreprocessConfig() if bake else None)
    ref = jfold(variables, fuse_heads=fuse, bake_preprocess=JPre() if bake else None)
    return dict(folded=True, fused_heads=fuse, stem_preprocess=bake), port, ref


def _run_both(variables, form, dtype):
    over, pv, jv = _form(variables, form)
    cfg = ModelConfig(**_kw(dtype, landmarks=True), **over)
    net = CenterFaceNet(cfg).eval()
    net.load_state_dict(state_dict_from_variables(pv), strict=True)
    x = _input(raw=form == "fused+raw")
    with torch.inference_mode():
        got = net(torch.from_numpy(x))
    jnet = JNet(JModel(**_kw(dtype, landmarks=True), **over))
    ref = jax.jit(lambda v, xx: jnet.apply(v, xx, train=False))(jv, x)
    return got, ref


@pytest.mark.parametrize("form", ["unfolded", "folded", "fused", "fused+raw"])
def test_head_maps_f32(variables, form):
    got, ref = _run_both(variables, form, "float32")
    keys = {"hm", "wh", "off", "lm"} | ({"whoff"} if form.startswith("fused") else set())
    assert set(got) == set(ref) == keys
    for k in keys:
        g = got[k].numpy()
        assert g.dtype == np.float32 and g.shape == ref[k].shape == (2, SIZE // 4, SIZE // 4, g.shape[-1])
        np.testing.assert_allclose(g, np.asarray(ref[k]), atol=F32_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("form", ["unfolded", "fused"])
def test_head_maps_bf16(variables, form):
    got, ref = _run_both(variables, form, "bfloat16")
    for k in ("hm", "wh", "off", "lm"):
        g, r = got[k].numpy(), np.asarray(ref[k])
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, r, atol=BF16_ATOL, rtol=0, err_msg=k)
        assert np.abs(g - r).mean() <= BF16_MEAN, k


def test_backbone_plan_and_skip_strides():
    """The plan and the stride-4/8/16/32 skip rule equal the JAX package's
    (backbone.py:72-79), for the default model and the shortened one."""
    from tpucenterface.model.backbone import backbone_plan as jplan

    for kw in ({}, _kw("float32")):
        assert backbone_plan(ModelConfig(**kw)) == jplan(JModel(**kw))
    assert feature_channels(ModelConfig()) == {4: 24, 8: 32, 16: 96, 32: 320}
    assert feature_channels(ModelConfig(**_kw("float32"))) == {4: 16, 8: 16, 16: 48, 32: 80}


@pytest.mark.parametrize("form", ["unfolded", "fused"])
def test_cast_convs_keeps_the_forward(variables, form):
    """`cast_convs_` (done once by the Detector) stores the compute-dtype
    conv weights in bfloat16 and leaves BatchNorm and the heads' out convs
    float32; the head maps are bit-identical to casting at every use."""
    over, pv, _ = _form(variables, form)
    cfg = ModelConfig(**_kw("bfloat16", landmarks=True), **over)
    sd = state_dict_from_variables(pv)
    nets = [CenterFaceNet(cfg).eval() for _ in range(2)]
    for net in nets:
        net.load_state_dict(sd, strict=True)
    nets[1].cast_convs_()
    for name, t in nets[1].state_dict().items():
        low = ".conv." in name and ".out." not in name
        assert t.dtype == (torch.bfloat16 if low else torch.float32), name
    x = torch.from_numpy(_input())
    with torch.inference_mode():
        want, got = nets[0](x), nets[1](x)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_fused_whoff_is_a_view(variables):
    """The fused heads return hm/wh/off/whoff as slices of one map."""
    got, _ = _run_both(variables, "fused", "float32")
    base = got["hm"].untyped_storage().data_ptr()
    assert all(got[k].untyped_storage().data_ptr() == base for k in ("wh", "off", "whoff"))
    assert torch.equal(got["whoff"][..., :2], got["wh"])
    assert torch.equal(got["whoff"][..., 2:], got["off"])
