"""The port's off-by-default alternates against the JAX package, on the CPU.

- The `scale_and_translate` letterbox (`PreprocessConfig.resize_impl` other
  than "matmul") against JAX's `letterbox_normalize` /
  `letterbox_normalize_batch`, which call `jax.image.scale_and_translate`:
  bilinear, cubic, lanczos3 and lanczos5, odd content in a 128x256 pad,
  upscaling (to 160) and downscaling (to 64). Tolerances, float32: atol 1e-4
  on normalized values (measured 1.9e-6); atol 2e-4 on raw values, whose
  magnitude reaches ~280 with the lanczos overshoot: JAX's own float32
  result is up to 8.6e-5 from the exact sums of its own weights there, so
  two float32 sums in different orders part by up to twice that (measured
  1.2e-4, four float32 ulps at 256; 0 for bilinear). `nearest` and unknown
  names raise as in JAX.
- The space-to-depth stem: `s2d_remap_stem` and `fold_variables(s2d_stem=)`
  bit-equal to JAX's; the s2d network against the 3x3 one and against the
  JAX s2d network (atol 1e-5, float32: measured 4.8e-7); the Detector's
  rules (remap, prebuilt 2x2 stem, odd buckets, the engines' module
  forward) and its detections against the JAX Detector's (scores atol
  1e-5, boxes 1e-3 px, float32, as tests/test_torch_detector.py); a 2x2x12
  stem through the safetensors files.
- `ConvBN(padding=)` in NCHW and channels_last, and `ConvBN(as_matmul=True)`
  against the JAX `MatmulConv1x1` (flax `ConvBN(as_matmul=True)`) on the
  same parameters: float32 atol 1e-5; bfloat16 within one bfloat16 ulp of
  the value (relative 2^-7) plus one of the output's largest magnitude
  (2^-8 of it): the products are summed in another order and rounded to
  bfloat16 before the bias is added, so where the bias cancels the product
  the rounding step is the product's, not the result's (5 of 1440 values).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucenterface_torch as T
from tpucenterface import preprocess as jp
from tpucenterface.config import DecodeConfig as JDecode
from tpucenterface.config import DetectorConfig as JDetectorConfig
from tpucenterface.config import ModelConfig as JModel
from tpucenterface.config import PreprocessConfig as JPre
from tpucenterface.detector import Detector as JDetector
from tpucenterface.model.blocks import ConvBN as JConvBN
from tpucenterface.model.centernet import CenterFaceNet as JNet
from tpucenterface.weights.fold import fold_variables as jfold
from tpucenterface.weights.fold import s2d_remap_stem as jremap
from tpucenterface_torch import preprocess as tp
from tpucenterface_torch.config import ModelConfig, PreprocessConfig
from tpucenterface_torch.model.blocks import ConvBN
from tpucenterface_torch.model.centernet import init_model, load_network
from tpucenterface_torch.train.step import tree_paths
from tpucenterface_torch.weights.fold import fold_variables, s2d_remap_stem
from tpucenterface_torch.weights.io import load_safetensors, save_safetensors
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

HP, WP = 128, 256
SIZE = 64


def _padded(seed, hws):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (len(hws), HP, WP, 3)).astype(np.uint8)
    for i, (h, w) in enumerate(hws):  # zero beyond the content, as pad_to_bucket leaves it
        imgs[i, h:] = 0
        imgs[i, :, w:] = 0
    return imgs, np.array(hws, np.int32)


# --------------------------------------------------------------------------- #
# the scale_and_translate letterbox
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("raw", [False, True], ids=["normalized", "raw"])
@pytest.mark.parametrize("size", [64, 160], ids=["down", "up"])
@pytest.mark.parametrize("method", ["bilinear", "cubic", "lanczos3", "lanczos5"])
def test_scale_translate_letterbox_matches_jax(method, size, raw):
    imgs, hws = _padded(0, [(97, 131), (HP, WP), (50, 201)])
    cfg = PreprocessConfig(resize_impl="scale_translate", method=method)
    jcfg = JPre(resize_impl="scale_translate", method=method)
    x, s, pads = tp.letterbox_normalize_batch(torch.from_numpy(imgs), torch.from_numpy(hws), size, cfg, raw=raw)
    jx, js, jpads = jp.letterbox_normalize_batch(jnp.asarray(imgs), jnp.asarray(hws), size, jcfg, raw=raw)
    atol = 2e-4 if raw else 1e-4
    assert x.dtype == torch.float32 and x.shape == (3, size, size, 3)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=atol)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pads.numpy(), np.asarray(jpads))
    one = tp.letterbox_normalize(torch.from_numpy(imgs[0]), torch.from_numpy(hws[0]), size, cfg, raw=raw)[0]
    jone = jp.letterbox_normalize(jnp.asarray(imgs[0]), jnp.asarray(hws[0]), size, jcfg, raw=raw)[0]
    np.testing.assert_allclose(one.numpy(), np.asarray(jone), rtol=0, atol=atol)


def test_scale_translate_letterbox_near_the_matmul_one():
    """On bilinear both letterboxes sample the same points with the same
    triangle, but the matmul one does not normalize its border columns, so
    they agree in float32 away from the content's border (atol 1e-4)."""
    imgs, hws = _padded(1, [(97, 131), (HP, WP)])
    st = PreprocessConfig(resize_impl="scale_translate", resize_dtype="float32")
    mm = PreprocessConfig(resize_dtype="float32")
    a = tp.letterbox_normalize_batch(torch.from_numpy(imgs), torch.from_numpy(hws), SIZE, st)[0]
    b = tp.letterbox_normalize_batch(torch.from_numpy(imgs), torch.from_numpy(hws), SIZE, mm)[0]
    inner = (slice(None), slice(12, -12), slice(2, -2))
    np.testing.assert_allclose(a[inner].numpy(), b[inner].numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("method,match", [("nearest", "Nearest"), ("box", "Unknown resize method")])
def test_scale_translate_refuses_what_jax_refuses(method, match):
    imgs, hws = _padded(2, [(97, 131)])
    with pytest.raises(ValueError, match=match):
        jp.letterbox_normalize(jnp.asarray(imgs[0]), jnp.asarray(hws[0]), SIZE,
                               JPre(resize_impl="scale_translate", method=method))
    with pytest.raises(ValueError, match=match):
        tp.letterbox_normalize(torch.from_numpy(imgs[0]), torch.from_numpy(hws[0]), SIZE,
                               PreprocessConfig(resize_impl="scale_translate", method=method))


def test_scale_translate_detector_matches_jax():
    """A float32 Detector with the scale_and_translate letterbox, on an odd
    image, against the JAX Detector on the same variables."""
    model = dict(compute_dtype="float32")
    _, v = init_model(ModelConfig(**model), seed=3)
    port = T.Detector(variables=v, config=T.DetectorConfig(
        model=ModelConfig(**model), preprocess=PreprocessConfig(resize_impl="scale_translate", method="cubic"),
        default_size=SIZE), device="cpu")
    ref = JDetector(variables=v, config=JDetectorConfig(
        model=JModel(**model), decode=JDecode(fast_topk=False),
        preprocess=JPre(resize_impl="scale_translate", method="cubic"), default_size=SIZE))
    img = _padded(4, [(97, 131)])[0][0, :97, :131]
    a, b = port.detect(img, score_thresh=0.0), ref.detect(img, score_thresh=0.0)
    np.testing.assert_allclose(a.scores, b.scores, atol=1e-5)
    np.testing.assert_allclose(a.boxes, b.boxes, atol=1e-3)


# --------------------------------------------------------------------------- #
# the space-to-depth stem
# --------------------------------------------------------------------------- #

F32 = ModelConfig(compute_dtype="float32")


@pytest.fixture(scope="module")
def variables():
    """Unfolded variables from a seed, BatchNorm randomized around the
    identity so that the fold and the bake move every weight."""
    _, v = init_model(F32, seed=1)
    rng = np.random.RandomState(1)
    for path, x in tree_paths(v["batch_stats"]):
        node = v["batch_stats"]
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = rng.uniform(-0.5, 0.5, x.shape).astype(np.float32) if path[-1] == "mean" else \
            rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
    return v


def test_s2d_remap_stem_bit_equal_to_jax(variables):
    k = np.asarray(variables["params"]["backbone"]["stem"]["conv"]["kernel"])
    for kern in (k, np.random.RandomState(0).randn(3, 3, 5, 7).astype(np.float32)):
        got, want = s2d_remap_stem(kern), jremap(kern)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="3x3"):
        s2d_remap_stem(np.zeros((2, 2, 12, 8), np.float32))


@pytest.mark.parametrize("bake", [False, True])
def test_fold_s2d_bit_equal_to_jax(variables, bake):
    pp = PreprocessConfig() if bake else None
    got = fold_variables(variables, fuse_heads=True, s2d_stem=True, bake_preprocess=pp)
    want = jfold(variables, fuse_heads=True, s2d_stem=True, bake_preprocess=JPre() if bake else None)
    gp, wp = tree_paths(got), tree_paths(jax.tree.map(np.asarray, want))
    assert [p for p, _ in gp] == [p for p, _ in wp]
    for (path, a), (_, b) in zip(gp, wp):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    assert np.shape(got["params"]["backbone"]["stem"]["conv"]["kernel"]) == (2, 2, 12, 32)


def test_s2d_stem_matches_3x3_stem_exactly(variables):
    """The 2x2/s1 stem on the space-to-depth input with the remapped kernel
    is the 3x3/s2 stem (float32, atol 1e-5), and the s2d network is the JAX
    s2d network on the same folded tree."""
    folded = fold_variables(variables)
    folded_s2d = fold_variables(variables, s2d_stem=True)
    a = load_network(folded, dataclasses.replace(F32, folded=True), "cpu")
    b = load_network(folded_s2d, dataclasses.replace(F32, folded=True, s2d_stem=True), "cpu")
    x = np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        ya, yb = a(torch.from_numpy(x)), b(torch.from_numpy(x))
    yj = JNet(JModel(compute_dtype="float32", folded=True, s2d_stem=True)).apply(
        jfold(variables, s2d_stem=True), x, train=False)
    for k in ("hm", "wh", "off"):
        np.testing.assert_allclose(yb[k].numpy(), ya[k].numpy(), atol=1e-5, err_msg=k)
        np.testing.assert_allclose(yb[k].numpy(), np.asarray(yj[k]), atol=1e-5, err_msg=k)


def test_s2d_unfolded_network_matches_jax():
    """A network built with the s2d stem (2x2x12 kernel from the init),
    unfolded, eval BatchNorm, against the JAX module."""
    cfg = dataclasses.replace(F32, s2d_stem=True)
    net, v = init_model(cfg, seed=4)
    assert np.shape(v["params"]["backbone"]["stem"]["conv"]["kernel"]) == (2, 2, 12, 32)
    x = np.random.RandomState(5).rand(2, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        y = net.eval()(torch.from_numpy(x))
    yj = JNet(JModel(compute_dtype="float32", s2d_stem=True)).apply(v, x, train=False)
    for k in ("hm", "wh", "off"):
        np.testing.assert_allclose(y[k].numpy(), np.asarray(yj[k]), atol=1e-5, err_msg=k)


def _pair(variables, model=None, **det_kw):
    model = model or {}
    port = T.Detector(variables=variables, config=T.DetectorConfig(
        model=ModelConfig(compute_dtype="float32", **model), default_size=SIZE, **det_kw), device="cpu")
    ref = JDetector(variables=variables, config=JDetectorConfig(
        model=JModel(compute_dtype="float32", **model), decode=JDecode(fast_topk=False), default_size=SIZE,
        **det_kw))
    return port, ref


def _same_detections(port, ref, images):
    for img in images:
        a, b = port.detect(img, score_thresh=0.0), ref.detect(img, score_thresh=0.0)
        np.testing.assert_allclose(a.scores, b.scores, atol=1e-5)
        np.testing.assert_allclose(a.boxes, b.boxes, atol=1e-3)


def _images():
    rng = np.random.RandomState(6)
    return [rng.randint(0, 255, (50, 70, 3)).astype(np.uint8), rng.randint(0, 255, (64, 64, 3)).astype(np.uint8)]


@pytest.mark.parametrize("engine", ["flax", "fast", "planar"])
def test_detector_s2d_stem_opt_in(variables, engine):
    """s2d_stem is an opt-in: the Detector remaps the stem after the bake,
    says s2d_stem in its config and runs the module forward whatever the
    engine (the engines run the 3x3 stem), with JAX's detections (letterbox
    and identity paths). The default stays off."""
    port, ref = _pair(variables, dict(s2d_stem=True, inference_engine=engine))
    assert port.config.model.s2d_stem and ref.config.model.s2d_stem
    assert port.config.model.stem_preprocess == ref.config.model.stem_preprocess is True
    assert port._engine is None and ref._engine is None
    assert np.shape(port.variables["params"]["backbone"]["stem"]["conv"]["kernel"]) == (2, 2, 12, 32)
    _same_detections(port, ref, _images())
    off, _ = _pair(variables)
    assert not off.config.model.s2d_stem
    with pytest.raises(ValueError, match="s2d"):
        port.quantize(calib_images=np.zeros((1, SIZE, SIZE, 3), np.uint8))


def test_detector_s2d_needs_even_buckets(variables):
    """An odd bucket or default size keeps the 3x3 stem, as in JAX."""
    port, ref = _pair(variables, dict(s2d_stem=True), buckets=(64, 97))
    assert not port.config.model.s2d_stem and not ref.config.model.s2d_stem
    assert np.shape(port.variables["params"]["backbone"]["stem"]["conv"]["kernel"]) == (3, 3, 3, 32)


def test_detector_constructed_with_s2d_stem_from_scratch():
    """ModelConfig(s2d_stem=True) with no variables: the init builds the
    2x2 stem, the fold neither remaps nor bakes it, and the Detector detects;
    the JAX Detector on the same variables gives the same detections."""
    cfg = T.DetectorConfig(model=ModelConfig(compute_dtype="float32", s2d_stem=True), buckets=(64, 128),
                           default_size=SIZE)
    det = T.Detector(config=cfg, device="cpu", seed=0)
    assert det.config.model.s2d_stem and not det.config.model.stem_preprocess
    out = det.detect(np.zeros((64, 64, 3), np.uint8), score_thresh=-1.0)
    assert out.boxes.shape[1] == 4 and np.isfinite(out.scores).all()
    _, v = init_model(cfg.model, seed=0)
    port, ref = _pair(v, dict(s2d_stem=True), buckets=(64, 128))
    assert ref.config.model.s2d_stem and not ref.config.model.stem_preprocess
    _same_detections(port, ref, _images())


def test_s2d_stem_through_safetensors(variables, tmp_path):
    """A 2x2x12 stem saves and loads: the unfolded s2d init and the folded
    s2d tree, each read back equal and served by `from_safetensors`."""
    _, v = init_model(dataclasses.replace(F32, s2d_stem=True), seed=7)
    folded = fold_variables(variables, s2d_stem=True)
    for name, tree in (("init", v), ("folded", folded)):
        path = str(tmp_path / f"{name}.safetensors")
        save_safetensors(tree, path)
        back = load_safetensors(path, F32)
        for (p, a), (q, b) in zip(tree_paths(tree), tree_paths(back)):
            assert p == q
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(p))
    det = T.Detector.from_safetensors(str(tmp_path / "init.safetensors"), T.DetectorConfig(
        model=dataclasses.replace(F32, s2d_stem=True), default_size=SIZE), device="cpu")
    assert det.config.model.s2d_stem
    cfg = T.DetectorConfig(model=dataclasses.replace(F32, folded=True, fused_heads=False, s2d_stem=True),
                           default_size=SIZE)
    det2 = T.Detector.from_safetensors(str(tmp_path / "folded.safetensors"), cfg, device="cpu")
    ref = JDetector(variables=folded, config=JDetectorConfig(
        model=JModel(compute_dtype="float32", folded=True, s2d_stem=True), decode=JDecode(fast_topk=False),
        default_size=SIZE))
    _same_detections(det2, ref, _images())


# --------------------------------------------------------------------------- #
# ConvBN: the padding override and the matmul 1x1
# --------------------------------------------------------------------------- #


def _load_conv(m: ConvBN, params):
    with torch.no_grad():
        m.conv.weight.copy_(torch.tensor(np.transpose(np.asarray(params["conv"]["kernel"]), (3, 2, 0, 1))))
        if m.folded:
            m.conv.bias.copy_(torch.from_numpy(np.asarray(params["conv"]["bias"])))
    return m


@pytest.mark.parametrize("channels_last", [False, True])
def test_convbn_padding_override_matches_jax(channels_last):
    """((1, 0), (1, 0)) on a 2x2/s1 conv and ((0, 2), (1, 1)) on a 3x3/s2
    one, NCHW and channels_last, against flax's explicit padding."""
    rng = np.random.RandomState(8)
    x = rng.rand(2, 9, 10, 12).astype(np.float32)
    for kernel, stride, pad in ((2, 1, ((1, 0), (1, 0))), (3, 2, ((0, 2), (1, 1)))):
        jm = JConvBN(features=8, kernel=kernel, stride=stride, padding=pad, folded=True, dtype=jnp.float32)
        params = jm.init(jax.random.PRNGKey(0), x)["params"]
        params = jax.tree.map(lambda a: a + 0.1, params)  # a non-zero bias
        want = np.asarray(jm.apply({"params": params}, x))
        m = _load_conv(ConvBN(12, 8, kernel=kernel, stride=stride, padding=pad, folded=True, dtype=torch.float32),
                       params)
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        if channels_last:
            xt = xt.contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            got = m(xt)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5)


@pytest.mark.parametrize("folded", [True, False], ids=["folded", "bn"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convbn_as_matmul_matches_jax(folded, dtype):
    """`ConvBN(as_matmul=True)` against the JAX `MatmulConv1x1` (flax
    `ConvBN(as_matmul=True)`) on the same parameters, and against the
    port's own conv forward; the parameters are the conv's tree."""
    rng = np.random.RandomState(9)
    x = rng.rand(2, 6, 5, 16).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jm = JConvBN(features=24, kernel=1, folded=folded, as_matmul=True, dtype=jdt)
    variables = jm.init(jax.random.PRNGKey(1), x)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.05, variables["params"])
    assert np.shape(params["conv"]["kernel"]) == (1, 1, 16, 24)
    jv = {"params": params, **({} if folded else {"batch_stats": variables["batch_stats"]})}
    want = np.asarray(jm.apply(jv, x).astype(jnp.float32))
    ms = []
    for as_matmul in (True, False):
        m = ConvBN(16, 24, kernel=1, folded=folded, dtype=tdt, as_matmul=as_matmul)
        _load_conv(m, params)
        if not folded:
            with torch.no_grad():
                m.bn.weight.copy_(torch.from_numpy(np.asarray(params["bn"]["scale"])))
                m.bn.bias.copy_(torch.from_numpy(np.asarray(params["bn"]["bias"])))
        ms.append(m)
    assert ms[0].as_matmul and not ms[1].as_matmul
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last).to(tdt)
    with torch.no_grad():
        got, conv = (m(xt).float().permute(0, 2, 3, 1).numpy() for m in ms)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(got, conv, atol=1e-5)
    else:
        ulp = 2 ** -8 * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=ulp)
        np.testing.assert_allclose(got, conv, rtol=2 ** -7, atol=ulp)


def test_as_matmul_applies_to_1x1_stride_1_ungrouped_only():
    assert ConvBN(8, 8, kernel=1, as_matmul=True).as_matmul
    assert not ConvBN(8, 8, kernel=3, as_matmul=True).as_matmul
    assert not ConvBN(8, 8, kernel=1, stride=2, as_matmul=True).as_matmul
    assert not ConvBN(8, 8, kernel=1, groups=8, as_matmul=True).as_matmul
