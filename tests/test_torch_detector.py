"""The port's detect path end to end against the JAX Detector.

Flagship weights (artifacts/flagship.safetensors) at the flagship's own
320 input, on synthetic multi-face scenes made from a seed. The port takes
`use_pallas=True` (the fused decode; on the CPU its plain version); the JAX
Detector on the CPU runs its reference decode with `fast_topk=False`, whose
ties follow the same lowest-index rule.

Also here: the fast engine (`inference_engine="fast"`) against the module
forward, the landmark decode route with the fused dense stage, and
`reload_weights` on a fast-engine detector.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpucenterface_torch as T
from tpucenterface.config import DecodeConfig as JDecode
from tpucenterface.config import DetectorConfig as JDetectorConfig
from tpucenterface.config import ModelConfig as JModel
from tpucenterface.config import PreprocessConfig as JPre
from tpucenterface.data.synth import render_scene
from tpucenterface.detector import Detector as JDetector
from tpucenterface.weights.io import load_safetensors as jax_load
from tpucenterface_torch.ops.fused_mbconv import unpack_fused_mbconv
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "artifacts", "flagship.safetensors")
SIZE = 320
THRESH = 0.05


def _scenes(n, seed=11, hw=(384, 512)):
    rng = np.random.RandomState(seed)
    return np.stack([render_scene(rng, hw=hw)[0] for _ in range(n)])


def _configs(dtype):
    """(port config, JAX config) for one compute/resize dtype."""
    kw = dict(compute_dtype=dtype)
    pre = dict(resize_dtype=dtype)
    port = T.DetectorConfig(
        model=T.ModelConfig(**kw),
        decode=T.DecodeConfig(use_pallas=True),
        preprocess=T.PreprocessConfig(**pre),
        default_size=SIZE,
    )
    jax_cfg = JDetectorConfig(
        model=JModel(**kw),
        decode=JDecode(fast_topk=False),
        preprocess=JPre(**pre),
        default_size=SIZE,
    )
    return port, jax_cfg


def match_detections(port, ref, box_atol, score_atol, firm):
    """Every detection of either side scoring >= `firm` finds one on the
    other side whose box corners (and landmark points, where both sides
    have them) are all within `box_atol` pixels and whose score is within
    `score_atol`."""
    for a, b in ((port, ref), (ref, port)):
        sel = a.scores >= firm
        if not sel.any():
            continue
        assert len(b.scores), f"no detections to match {a.scores[sel]}"
        dist = np.abs(a.boxes[sel][:, None, :] - b.boxes[None, :, :]).max(axis=-1)
        if a.landmarks is not None and b.landmarks is not None:
            lm = np.abs(a.landmarks[sel][:, None] - b.landmarks[None]).max(axis=(-2, -1))
            dist = np.maximum(dist, lm)
        close = np.abs(a.scores[sel][:, None] - b.scores[None, :]) <= score_atol
        ok = ((dist <= box_atol) & close).any(axis=1)
        assert ok.all(), f"unmatched {a.boxes[sel][~ok]} scores {a.scores[sel][~ok]}"


@pytest.fixture(scope="module")
def flagship_vars():
    return jax_load(ARTIFACT)


@pytest.fixture(scope="module")
def scenes():
    return _scenes(3)


def test_import_leaves_jax_out():
    code = (
        "import sys; import tpucenterface_torch; "
        "import tpucenterface_torch.ops.fused_mbconv, tpucenterface_torch.model.fast_forward, "
        "tpucenterface_torch.decode.fused_nms, tpucenterface_torch.kernels.build, "
        "tpucenterface_torch.ops.planar_mbconv, tpucenterface_torch.model.planar_engine, "
        "tpucenterface_torch.kernels.sweep_b4b, tpucenterface_torch.kernels.sweep_b2, "
        "tpucenterface_torch.decode, tpucenterface_torch.data.wider, tpucenterface_torch.eval.wider_eval, "
        "tpucenterface_torch.eval.tta, tpucenterface_torch.eval.batch_runner, "
        "tpucenterface_torch.eval.synth_eval, tpucenterface_torch.runtime.sharding; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'tpucenterface')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


def test_detector_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Detector()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Detector.from_safetensors(ARTIFACT)


@pytest.fixture(scope="module")
def f32_pair(flagship_vars):
    """(port, JAX) Detectors of the flagship in float32, shared by the
    float32 cases: one JAX Detector, whose programs each compile once."""
    port_cfg, jax_cfg = _configs("float32")
    return T.Detector.from_safetensors(ARTIFACT, port_cfg, device="cpu"), JDetector(variables=flagship_vars,
                                                                                    config=jax_cfg)


def test_flagship_f32_matches_jax(f32_pair, scenes):
    """float32 compute and resize on both sides: all K scores within 1e-5
    and all K boxes within 1e-3 px, in the same order (the two differ only
    in float32 summation order: measured 3.7e-6 and 3.1e-5)."""
    port, ref = f32_pair
    hws = np.array([[384, 512], [300, 512], [384, 401]], np.int32)
    pd = port.detect_batch(scenes, hws=hws, score_thresh=0.0)
    rd = ref.detect_batch(scenes, hws=hws, score_thresh=0.0)
    for a, b in zip(pd, rd):
        assert (a.scores >= THRESH).sum() > 0
        np.testing.assert_allclose(a.scores, b.scores, atol=1e-5)
        np.testing.assert_allclose(a.boxes, b.boxes, atol=1e-3)


def test_flagship_bf16_matches_jax(flagship_vars, scenes):
    """The default bfloat16 path on both sides. bf16 rounds at other places
    in the two frameworks (conv epilogues, resize sums): head logits differ
    by up to ~0.1, as much as either side differs from float32, which moves
    scores by up to ~0.02 and shifts a weak peak to a neighbouring cell.
    So detections scoring >= 0.1 must match within 2 px and 0.03 in score;
    weaker ones near the 0.05 threshold may appear on one side only."""
    port_cfg, jax_cfg = _configs("bfloat16")
    port = T.Detector.from_safetensors(ARTIFACT, port_cfg, device="cpu")
    ref = JDetector(variables=flagship_vars, config=jax_cfg)
    pd = port.detect_batch(scenes, score_thresh=THRESH)
    rd = ref.detect_batch(scenes, score_thresh=THRESH)
    for a, b in zip(pd, rd):
        assert (a.scores >= 0.1).sum() > 0
        match_detections(a, b, box_atol=2.0, score_atol=0.03, firm=0.1)


def test_flagship_detect_single_and_identity(f32_pair):
    """`detect` on an odd size (letterbox) and on a model-size image (the
    identity preprocess), float32, against the JAX Detector."""
    port, ref = f32_pair
    odd = _scenes(1, seed=5, hw=(123, 457))[0]
    square = _scenes(1, seed=6, hw=(SIZE, SIZE))[0]
    for img in (odd, square):
        a = port.detect(img, score_thresh=0.0)
        b = ref.detect(img, score_thresh=0.0)
        np.testing.assert_allclose(a.scores, b.scores, atol=1e-5)
        np.testing.assert_allclose(a.boxes, b.boxes, atol=1e-3)
        assert (a.boxes >= 0).all()
        assert (a.boxes[:, 0::2] <= img.shape[1]).all()
        assert (a.boxes[:, 1::2] <= img.shape[0]).all()


def _fast(cfg):
    import dataclasses

    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, inference_engine="fast"))


def test_fast_engine_matches_module_forward(scenes):
    """`inference_engine="fast"` on the CPU (the fused blocks take their
    plain version) against the module forward, flagship at 320, both
    bfloat16: the bound of the bfloat16 port-against-JAX test above."""
    port_cfg, _ = _configs("bfloat16")
    base = T.Detector.from_safetensors(ARTIFACT, port_cfg, device="cpu")
    fast = T.Detector.from_safetensors(ARTIFACT, _fast(port_cfg), device="cpu")
    assert fast._engine is not None and base._engine is None
    assert fast._engine.kernel_blocks(SIZE) == [0, 2, 4, 5]
    assert fast.model is fast._engine.net
    bd = base.detect_batch(scenes, score_thresh=THRESH)
    fd = fast.detect_batch(scenes, score_thresh=THRESH)
    for a, b in zip(fd, bd):
        assert (a.scores >= 0.1).sum() > 0
        match_detections(a, b, box_atol=2.0, score_atol=0.03, firm=0.1)
    assert any(len(a.scores) != len(b.scores) or (a.scores != b.scores).any() for a, b in zip(fd, bd))


def test_unknown_engine_raises():
    cfg = T.DetectorConfig(model=T.ModelConfig(inference_engine="banded"))
    with pytest.raises(NotImplementedError, match="banded"):
        T.Detector(config=cfg, device="cpu")


@pytest.mark.parametrize("fast_topk", [True, False])
def test_landmark_route_bit_equal_with_fused_dense_stage(fast_topk):
    """A landmark model (random weights from a seed): `use_pallas=True` runs
    the dense stage through `sigmoid_pseudo_nms_fused` and returns exactly
    what `use_pallas=False` returns."""
    model = T.ModelConfig(with_landmarks=True)
    dets = [
        T.Detector(
            config=T.DetectorConfig(
                model=model, decode=T.DecodeConfig(use_pallas=flag, fast_topk=fast_topk), default_size=SIZE
            ),
            device="cpu",
            seed=3,
        )
        for flag in (True, False)
    ]
    imgs = _scenes(2, seed=9, hw=(SIZE, SIZE))
    on, off = (d.detect_batch(imgs, score_thresh=0.0) for d in dets)
    for a, b in zip(on, off):
        assert a.landmarks is not None and a.landmarks.shape == (len(a.scores), 5, 2)
        assert a.boxes.tobytes() == b.boxes.tobytes()
        assert a.scores.tobytes() == b.scores.tobytes()
        assert a.landmarks.tobytes() == b.landmarks.tobytes()


def test_landmark_route_goes_through_the_fused_dense_stage(monkeypatch):
    import tpucenterface_torch.detector as D

    calls = []
    real = D.sigmoid_pseudo_nms_fused
    monkeypatch.setattr(D, "sigmoid_pseudo_nms_fused", lambda hm: calls.append(tuple(hm.shape)) or real(hm))
    for landmarks, use_pallas, want in ((True, True, 1), (True, False, 0), (False, True, 0)):
        calls.clear()
        cfg = T.DetectorConfig(
            model=T.ModelConfig(with_landmarks=landmarks),
            decode=T.DecodeConfig(use_pallas=use_pallas),
            default_size=128,
        )
        T.Detector(config=cfg, device="cpu", seed=1).detect(np.zeros((128, 128, 3), np.uint8))
        assert len(calls) == want, (landmarks, use_pallas, calls)


def test_reload_weights_rebuilds_the_fast_engine(flagship_vars, scenes):
    """The fast engine holds its own copies of the block weights: after
    `reload_weights` it must run the new ones (a stale engine would return
    the old detections), and `weights_version` is bumped."""
    port_cfg, _ = _configs("bfloat16")
    cfg = _fast(port_cfg)
    _, other = T.model.centernet.init_model(cfg.model, seed=5)
    det = T.Detector(variables=other, config=cfg, device="cpu")
    assert det.weights_version == 0
    before = det.detect_batch(scenes, score_thresh=0.0)
    old_engine = det._engine
    det.reload_weights(safetensors_path=ARTIFACT)
    assert det.weights_version == 1
    assert det._engine is not old_engine and det.model is det._engine.net
    after = det.detect_batch(scenes, score_thresh=0.0)
    fresh = T.Detector.from_safetensors(ARTIFACT, cfg, device="cpu").detect_batch(scenes, score_thresh=0.0)
    for a, b, f in zip(after, before, fresh):
        assert a.scores.tobytes() == f.scores.tobytes() and a.boxes.tobytes() == f.boxes.tobytes()
        assert not np.array_equal(a.scores, b.scores)
        assert (a.scores >= 0.3).sum() > 0
    # the block weights the engine runs are the reloaded ones
    w2 = unpack_fused_mbconv(det._engine.packed[2])[4].float().numpy()
    want = det.variables["params"]["backbone"]["block_2"]["project"]["conv"]["kernel"][0, 0]
    np.testing.assert_array_equal(w2, torch.from_numpy(np.asarray(want)).bfloat16().float().numpy())
    det.reload_weights(variables=other)
    assert det.weights_version == 2
    again = det.detect_batch(scenes, score_thresh=0.0)
    for a, b in zip(again, before):
        assert a.scores.tobytes() == b.scores.tobytes()
    with pytest.raises(ValueError, match="pass variables"):
        det.reload_weights()


@pytest.mark.slow
def test_flagship_ap_matches_jax(flagship_vars, tmp_path):
    """AP of the port on the 24-scene flagship split (tests/
    test_flagship_anchor.py's split) within 0.005 of the JAX Detector's."""
    from tpucenterface.data.synth import generate_dataset
    from tpucenterface.eval.synth_eval import ap_on_records

    recs = generate_dataset(str(tmp_path), 24, seed=7777, hw_range=(384, 512), min_face=18.0)
    port_cfg = T.DetectorConfig(decode=T.DecodeConfig(max_dets=100, use_pallas=True), default_size=SIZE)
    jax_cfg = JDetectorConfig(decode=JDecode(max_dets=100), default_size=SIZE)
    port = T.Detector.from_safetensors(ARTIFACT, port_cfg, device="cpu")
    ref = JDetector(variables=flagship_vars, config=jax_cfg)
    ap_port = ap_on_records(port, recs, size=SIZE)
    ap_ref = ap_on_records(ref, recs, size=SIZE)
    for split in ap_ref:
        assert abs(ap_port[split] - ap_ref[split]) <= 0.005, (split, ap_port, ap_ref)


# --------------------------------------------------------------------------- #
# the programs: `_decode(max_dets=)`, `_single_fn`, `_batch_fn`,
# `_batch_flip_fn` and `results_to_detections(lo=, hi=)` against the JAX
# Detector's, at a 128 input (flagship weights; a landmark model on random
# weights); bounds as above: float32 all K within 1e-5 and 1e-3 px, bfloat16
# the detections >= 0.1 matched within 2 px and 0.03
# --------------------------------------------------------------------------- #

PSIZE = 128


@pytest.fixture(scope="module")
def program_pairs(flagship_vars):
    """{dtype: (port Detector, JAX Detector)} at the 128 input."""
    import dataclasses

    pairs = {}
    for dtype in ("float32", "bfloat16"):
        port_cfg, jax_cfg = _configs(dtype)
        port_cfg = dataclasses.replace(port_cfg, default_size=PSIZE)
        jax_cfg = dataclasses.replace(jax_cfg, default_size=PSIZE)
        pairs[dtype] = (
            T.Detector.from_safetensors(ARTIFACT, port_cfg, device="cpu"),
            JDetector(variables=flagship_vars, config=jax_cfg),
        )
    return pairs


@pytest.fixture(scope="module")
def program_batch():
    """Three scenes on one (128, 128) canvas, two of them letterboxed from odd
    content sizes."""
    imgs = _scenes(3, seed=21, hw=(PSIZE, PSIZE))
    hws = np.array([[PSIZE, PSIZE], [101, PSIZE], [PSIZE, 77]], np.int32)
    for img, (h, w) in zip(imgs, hws):
        img[h:], img[:, w:] = 0, 0
    return imgs, hws


def _as_dets(res, i=None):
    """Detections of one image of a program result (numpy or tensors)."""
    arrs = [np.asarray(r.numpy() if isinstance(r, torch.Tensor) else r) for r in res]
    if i is not None:
        arrs = [a[i] for a in arrs]
    return T.Detections(*arrs) if len(arrs) == 3 else T.Detections(arrs[0], arrs[1])


def _compare(dtype, a, b):
    if dtype == "float32":
        np.testing.assert_allclose(a.scores, b.scores, atol=1e-5)
        np.testing.assert_allclose(a.boxes, b.boxes, atol=1e-3)
        if a.landmarks is not None:
            np.testing.assert_allclose(a.landmarks, b.landmarks, atol=1e-3)
    else:
        match_detections(a, b, box_atol=2.0, score_atol=0.03, firm=0.1)


def _run_port(fn, imgs, hws):
    return fn(torch.from_numpy(np.ascontiguousarray(imgs)), torch.from_numpy(hws))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_single_fn_matches_jax(program_pairs, program_batch, dtype):
    """The one-image program on a letterboxed odd size and, pre-sized, on
    the identity path: unbatched (K, 4), (K,) results."""
    port, ref = program_pairs[dtype]
    imgs, hws = program_batch
    for img, hw, identity in ((imgs[1], hws[1], False), (imgs[0], hws[0], True)):
        assert port._identity_for((PSIZE, PSIZE), PSIZE, hw[None]) == identity
        got = _run_port(port._single_fn((PSIZE, PSIZE), PSIZE, identity=identity), img, hw)
        want = ref._single_fn((PSIZE, PSIZE), PSIZE, identity=identity)(img, hw)
        assert len(got) == 2 and tuple(got[0].shape) == (200, 4) and tuple(got[1].shape) == (200,)
        a, b = _as_dets(got), _as_dets(want)
        assert (a.scores >= 0.1).sum() > 0
        _compare(dtype, a, b)


@pytest.mark.parametrize("dtype,max_dets", [("float32", None), ("float32", 5000), ("bfloat16", 37)])
def test_batch_fn_max_dets_matches_jax(program_pairs, program_batch, dtype, max_dets):
    """The batch program with a per-call K: min(max_dets, H*W) rows (the
    32x32 map holds 1024 cells), as the JAX program gives them."""
    port, ref = program_pairs[dtype]
    imgs, hws = program_batch
    got = _run_port(port._batch_fn(3, (PSIZE, PSIZE), PSIZE, max_dets=max_dets), imgs, hws)
    want = ref._batch_fn(3, (PSIZE, PSIZE), PSIZE, max_dets=max_dets)(imgs, hws)
    k = min(max_dets or 200, (PSIZE // 4) ** 2)
    assert tuple(got[1].shape) == np.asarray(want[1]).shape == (3, k)
    for i in range(3):
        _compare(dtype, _as_dets(got, i), _as_dets(want, i))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_flip_fn_matches_jax(program_pairs, program_batch, dtype):
    """The flip program: (B, 2K) rows, the image's K then its mirror's K
    un-mirrored, against the JAX program; the first half is the batch
    program's result and the second half the batch program's on the
    host-mirrored square, un-mirrored (pre-sized images: the letterbox is
    the identity, so mirroring the square is mirroring the image)."""
    port, ref = program_pairs[dtype]
    imgs, hws = program_batch
    got = _run_port(port._batch_flip_fn(3, (PSIZE, PSIZE), PSIZE), imgs, hws)
    want = ref._batch_flip_fn(3, (PSIZE, PSIZE), PSIZE)(imgs, hws)
    assert tuple(got[0].shape) == np.asarray(want[0]).shape == (3, 400, 4)
    for i in range(3):
        _compare(dtype, _as_dets(got, i), _as_dets(want, i))
    plain = _run_port(port._batch_fn(3, (PSIZE, PSIZE), PSIZE), imgs, hws)
    assert torch.equal(got[0][:, :200], plain[0]) and torch.equal(got[1][:, :200], plain[1])
    flipped = T.Detections(got[0][0, 200:].numpy(), got[1][0, 200:].numpy())
    _compare_mirror_half(dtype, flipped, port, imgs[:1], hws[:1])


def _compare_mirror_half(dtype, flipped, port, img, hw):
    """The mirror half of a flip program's row against the batch program on
    the host-mirrored pre-sized image, un-mirrored. The batch program clips
    its boxes and points to the image before the host un-mirrors them, where
    the flip program un-mirrors first, so a box or point past the border
    lands up to 1 px apart; in float32 the bound is that pixel and 1e-5 in
    score (the two forwards run at other batch sizes, so near-tied scores
    may also swap their order), in bfloat16 the bound of the tests above."""
    mirrored = _run_port(port._batch_fn(1, (PSIZE, PSIZE), PSIZE), np.ascontiguousarray(img[:, :, ::-1]), hw)
    edge = PSIZE - 1.0
    boxes = torch.stack([edge - mirrored[0][0][:, 2], mirrored[0][0][:, 1],
                         edge - mirrored[0][0][:, 0], mirrored[0][0][:, 3]], dim=-1).clamp(0, PSIZE)
    lm = None
    if len(mirrored) == 3:
        lm = mirrored[2][0].clone()
        lm[..., 0] = edge - lm[..., 0]
        lm = lm[:, list(port.config.decode.lm_flip_perm)].clamp(0, PSIZE).numpy()
    want = T.Detections(boxes.numpy(), mirrored[1][0].numpy(), lm)
    if dtype == "float32":
        match_detections(flipped, want, box_atol=1.0 + 1e-3, score_atol=1e-5, firm=0.0)
    else:
        match_detections(flipped, want, box_atol=2.0, score_atol=0.03, firm=0.1)


@pytest.mark.parametrize("perm", [None, (4, 2, 0, 1, 3)])
def test_landmark_flip_fn_matches_jax(perm):
    """A landmark model (random weights from a seed, float32): the flip
    program carries the points, un-mirrored and pair-swapped by
    `lm_flip_perm` (the default pairs, and a permutation that is no
    involution), as the JAX program does; the fused dense stage is on."""
    model = T.ModelConfig(with_landmarks=True, compute_dtype="float32")
    _, variables = T.model.centernet.init_model(model, seed=11)
    swap = {} if perm is None else {"lm_flip_perm": perm}
    port = T.Detector(
        variables=variables,
        config=T.DetectorConfig(model=model, decode=T.DecodeConfig(use_pallas=True, **swap),
                                preprocess=T.PreprocessConfig(resize_dtype="float32"), default_size=PSIZE),
        device="cpu",
    )
    ref = JDetector(
        variables=variables,
        config=JDetectorConfig(model=JModel(with_landmarks=True, compute_dtype="float32"),
                               decode=JDecode(fast_topk=False, **swap), preprocess=JPre(resize_dtype="float32"),
                               default_size=PSIZE),
    )
    imgs = _scenes(2, seed=23, hw=(PSIZE, PSIZE))
    hws = np.array([[PSIZE, PSIZE], [PSIZE, 93]], np.int32)
    got = _run_port(port._batch_flip_fn(2, (PSIZE, PSIZE), PSIZE), imgs, hws)
    want = ref._batch_flip_fn(2, (PSIZE, PSIZE), PSIZE)(imgs, hws)
    assert len(got) == 3 and tuple(got[2].shape) == (2, 400, 5, 2)
    for i in range(2):
        _compare("float32", _as_dets(got, i), _as_dets(want, i))
    # the mirror half's points: mirrored x, left/right pairs swapped
    flipped = T.Detections(got[0][0, 200:].numpy(), got[1][0, 200:].numpy(), got[2][0, 200:].numpy())
    _compare_mirror_half("float32", flipped, port, imgs[:1], hws[:1])


@pytest.mark.parametrize("perm", [(1, 0, 2, 4, 3), (4, 2, 0, 1, 3)])
def test_landmark_flip_fn_pair_swap_is_the_list_gather(perm):
    """A guard beside `test_landmark_flip_fn_matches_jax`: the flip program's
    mirror-half landmarks, pair-swapped through the index it keeps on the
    device, equal bit for bit the gather indexed by the list `lm_flip_perm`
    over the same forward and decode (the default pairs and a permutation
    that is no involution)."""
    from tpucenterface_torch.decode.reference import landmarks_to_original
    from tpucenterface_torch.detector import _decode_with
    from tpucenterface_torch.preprocess import letterbox_normalize_batch

    model = T.ModelConfig(with_landmarks=True, compute_dtype="float32")
    _, variables = T.model.centernet.init_model(model, seed=11)
    port = T.Detector(
        variables=variables,
        config=T.DetectorConfig(model=model, decode=T.DecodeConfig(use_pallas=True, lm_flip_perm=perm),
                                preprocess=T.PreprocessConfig(resize_dtype="float32"), default_size=PSIZE),
        device="cpu",
    )
    imgs = torch.from_numpy(np.ascontiguousarray(_scenes(2, seed=29, hw=(PSIZE, PSIZE))))
    hws = torch.tensor([[PSIZE, 101], [77, PSIZE]], dtype=torch.int32)
    got = port._batch_flip_fn(2, (PSIZE, PSIZE), PSIZE)(imgs, hws)
    cfg = port.config
    with torch.inference_mode():
        x, scales, pads = letterbox_normalize_batch(imgs, hws, PSIZE, cfg.preprocess, raw=cfg.model.stem_preprocess)
        _, _, lm = _decode_with(cfg.decode, port._generation().forward(torch.cat([x, x.flip(2)])))
        mir = lm[2:]
        mir = torch.stack([(PSIZE - 1.0) - mir[..., 0], mir[..., 1]], dim=-1)[:, :, list(perm), :]
        want = landmarks_to_original(torch.cat([lm[:2], mir], dim=1), scales, pads, hws)
    assert got[2].dtype == want.dtype and tuple(got[2].shape) == (2, 400, 5, 2)
    assert torch.equal(got[2], want)


@pytest.fixture(scope="module")
def jax_plain(program_pairs):
    """A JAX Detector (reference top-K) for the methods that read only its
    config."""
    return program_pairs["float32"][1]


@pytest.mark.parametrize("max_dets", [None, 1, 249])
def test_decode_max_dets_matches_jax(jax_plain, max_dets):
    """`_decode(feats, max_dets=)` on every route of the port (the fused
    decode's plain version, the reference, the landmark route) against the
    JAX `_decode`: K = min(max_dets, H*W), the same indices."""
    rng = np.random.RandomState(4)
    h, w = 12, 20
    feats = {
        "hm": rng.randn(2, h, w, 1).astype(np.float32) * 3,
        "wh": rng.randn(2, h, w, 2).astype(np.float32),
        "off": rng.rand(2, h, w, 2).astype(np.float32),
        "lm": rng.randn(2, h, w, 10).astype(np.float32),
    }
    ports = [T.Detector(config=T.DetectorConfig(decode=T.DecodeConfig(use_pallas=flag)), device="cpu")
             for flag in (True, False)]
    for landmarks in (False, True):
        f = {k: v for k, v in feats.items() if landmarks or k != "lm"}
        want = jax_plain._decode(f, max_dets=max_dets)
        for port in ports:
            got = port._decode({k: torch.from_numpy(v) for k, v in f.items()}, max_dets=max_dets)
            assert tuple(got[1].shape) == (2, min(max_dets or 200, h * w))
            np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
            assert (got[2] is None) == (not landmarks)
            if landmarks:
                np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-4)


def test_results_to_detections_lo_hi(jax_plain):
    """`results_to_detections(res, thresh, lo, hi)` splits images lo..hi-1,
    as the JAX method does on the same arrays."""
    rng = np.random.RandomState(2)
    res = (rng.rand(5, 7, 4).astype(np.float32) * 50, rng.rand(5, 7).astype(np.float32),
           rng.rand(5, 7, 5, 2).astype(np.float32))
    port = T.Detector(device="cpu")
    ref = jax_plain
    for n in (2, 3):
        for lo, hi in ((0, None), (1, 4), (2, 2), (0, 5)):
            got = port.results_to_detections(tuple(torch.from_numpy(r) for r in res[:n]), 0.4, lo=lo, hi=hi)
            want = ref.results_to_detections(res[:n], 0.4, lo=lo, hi=hi)
            assert len(got) == len(want) == (5 if hi is None else hi) - lo
            for a, b in zip(got, want):
                for x, y in zip(a, b):
                    assert (x is None and y is None) or np.array_equal(x, y)


def test_programs_refuse_what_they_cannot_run():
    """The int8-input program needs the identity path and a quantized
    stem-baked detector (`tpucenterface/detector.py:589-596`); the flip
    program a centered letterbox."""
    det = T.Detector(config=T.DetectorConfig(default_size=PSIZE), device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        det._batch_fn(2, (PSIZE, PSIZE), PSIZE, identity=True, int8_in=True)
    with pytest.raises(ValueError, match="identity"):
        det._batch_fn(2, (PSIZE, PSIZE), PSIZE, identity=False, int8_in=True)
    uncentered = T.Detector(config=T.DetectorConfig(preprocess=T.PreprocessConfig(center=False)), device="cpu")
    with pytest.raises(ValueError, match="centered letterbox"):
        uncentered._batch_flip_fn(2, (PSIZE, PSIZE), PSIZE)


def test_decode_feats_is_exported_as_in_jax():
    """`tpucenterface_torch.decode.decode_feats` / `boxes_to_original`, the
    names `tpucenterface.decode` exports, on the same head maps."""
    from tpucenterface.decode import decode_feats as jdecode_feats
    from tpucenterface_torch.decode import boxes_to_original, decode_feats

    rng = np.random.RandomState(8)
    feats = {"hm": rng.randn(2, 10, 14, 1).astype(np.float32) * 3, "wh": rng.randn(2, 10, 14, 2).astype(np.float32),
             "off": rng.rand(2, 10, 14, 2).astype(np.float32)}
    got = decode_feats({k: torch.from_numpy(v) for k, v in feats.items()}, T.DecodeConfig(max_dets=30))
    want = jdecode_feats(feats, JDecode(max_dets=30, fast_topk=False))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    assert callable(boxes_to_original)


# --------------------------------------------------------------------------- #
# faults found against the JAX Detector (ROADMAP.md §C: C1-C4)
# --------------------------------------------------------------------------- #


def _engine(cfg, name):
    import dataclasses

    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, inference_engine=name))


@pytest.fixture(scope="module")
def unfolded_ref(flagship_vars, scenes):
    """The JAX Detector over the unfolded flagship (bfloat16): it runs its
    module forward whatever the engine name, so one serves both cases."""
    _, jax_cfg = _configs("bfloat16")
    ref = JDetector(variables=flagship_vars, config=_engine(jax_cfg, "planar"), fold_bn=False)
    assert ref._engine is None and not ref.config.model.folded
    return ref.detect_batch(scenes, score_thresh=THRESH)


@pytest.mark.parametrize("engine", ["planar", "fast"])
def test_engine_over_unfolded_weights_runs_the_module_forward(flagship_vars, scenes, unfolded_ref, engine):
    """C1: an engine over unfolded weights (`fold_bn=False`) leaves the
    module forward to run, as the JAX Detector does
    (`tpucenterface/detector.py:146-150`); the bfloat16 bounds of
    `test_flagship_bf16_matches_jax`."""
    port_cfg, _ = _configs("bfloat16")
    port = T.Detector(variables=flagship_vars, config=_engine(port_cfg, engine), fold_bn=False, device="cpu")
    assert port._engine is None and not port.config.model.folded
    for a, b in zip(port.detect_batch(scenes, score_thresh=THRESH), unfolded_ref):
        assert (a.scores >= 0.1).sum() > 0
        match_detections(a, b, box_atol=2.0, score_atol=0.03, firm=0.1)


def test_planar_float32_detector_matches_jax(flagship_vars, scenes):
    """C4: a float32 planar Detector builds the planar engine without the
    bfloat16 chain kernel (`max_chain_res=0`, the JAX Detector's setting,
    `tpucenterface/detector.py:154`) and gives JAX's detections (float32
    bounds: 1e-5 in score, 1e-3 px)."""
    port_cfg, jax_cfg = _configs("float32")
    port = T.Detector.from_safetensors(ARTIFACT, _engine(port_cfg, "planar"), device="cpu")
    ref = JDetector(variables=flagship_vars, config=_engine(jax_cfg, "planar"))
    assert port._engine is not None and port._engine.max_chain_res == 0 and ref._engine is not None
    hws = np.array([[384, 512], [300, 512], [384, 401]], np.int32)
    for a, b in zip(port.detect_batch(scenes, hws=hws, score_thresh=0.0),
                    ref.detect_batch(scenes, hws=hws, score_thresh=0.0)):
        np.testing.assert_allclose(a.scores, b.scores, atol=1e-5)
        np.testing.assert_allclose(a.boxes, b.boxes, atol=1e-3)


def test_fast_float32_detector_runs_the_module_forward(f32_pair, scenes):
    """C4, the port's own engine: the fused MBConv kernel computes in
    bfloat16, so a float32 "fast" Detector runs the module forward, as the
    JAX Detector does for every engine name but "planar"; JAX's detections
    within the float32 bounds."""
    port_cfg, _ = _configs("float32")
    fast = T.Detector.from_safetensors(ARTIFACT, _engine(port_cfg, "fast"), device="cpu")
    assert fast._engine is None
    for a, b in zip(fast.detect_batch(scenes, score_thresh=0.0), f32_pair[1].detect_batch(scenes, score_thresh=0.0)):
        np.testing.assert_allclose(a.scores, b.scores, atol=1e-5)
        np.testing.assert_allclose(a.boxes, b.boxes, atol=1e-3)


@pytest.mark.parametrize("dtype", [np.float32, np.int64])
def test_non_uint8_images_go_in_as_they_are(f32_pair, dtype):
    """C2: `detect` and `detect_batch` feed a float32 or int64 image to the
    program as it is, as the JAX Detector does (`tpucenterface/detector.py:
    771, 796`), instead of casting it to uint8 (float32 bounds)."""
    port, ref = f32_pair
    rng = np.random.RandomState(12)
    img = (rng.rand(50, 70, 3) * 255).astype(dtype)
    a, b = port.detect(img, score_thresh=0.0), ref.detect(img, score_thresh=0.0)
    np.testing.assert_allclose(a.scores, b.scores, atol=1e-5)
    np.testing.assert_allclose(a.boxes, b.boxes, atol=1e-3)
    batch = np.stack([img, img[::-1]])
    for a, b in zip(port.detect_batch(batch, score_thresh=0.0), ref.detect_batch(batch, score_thresh=0.0)):
        np.testing.assert_allclose(a.scores, b.scores, atol=1e-5)
        np.testing.assert_allclose(a.boxes, b.boxes, atol=1e-3)


def test_load_safetensors_takes_a_config_and_stage_available():
    """C3: `weights.io.load_safetensors(path, cfg)` takes JAX's second
    parameter, which decides nothing (the tree equals the one-argument
    call's), and `native.stage_available()` answers whether the staging
    library builds and loads, as the JAX function does (g++ is here)."""
    from tpucenterface import native as jnative
    from tpucenterface_torch import native
    from tpucenterface_torch.weights.io import load_safetensors

    a = load_safetensors(ARTIFACT, T.ModelConfig())
    b = load_safetensors(ARTIFACT)
    from tpucenterface_torch.train.step import tree_paths

    pa, pb = tree_paths(a), tree_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (_, x), (_, y) in zip(pa, pb):
        np.testing.assert_array_equal(x, y)
    assert native.stage_available() is True
    assert native.stage_available() == jnative.stage_available()
