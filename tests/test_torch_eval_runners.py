"""The port's batched runners and AP scorers over the Detector's programs,
against the JAX package's.

Fast tests: flagship weights in float32 at a 64/128 bucket ladder, on a
mixed-shape image list (three padded shapes) at batch 4 (the {1, 4}
ladder): `batched_detect` and `batched_detect_tta` give the JAX runners'
launch plans and detections (each detection >= 0.05 of either side matched
within 1e-3 px and 1e-5 in score, landmarks included); a landmark model
(random weights) carries its points through the TTA merge.

Slow tests (`-m slow`): the North star's AP gates on the 240-scene held-out
split of the flagship recipe, at 320, within 0.005 of the JAX package's
reports: `runs/flagship3/flagship_report.json` (no TTA) and
`runs/flagship3/flagship_tta.json` (flip at scale 0.7, flip at scales 0.7
and 1.0).
"""

import json
import os

import numpy as np
import pytest

import tpucenterface_torch as T
from tpucenterface.config import DecodeConfig as JDecode
from tpucenterface.config import DetectorConfig as JDetectorConfig
from tpucenterface.config import ModelConfig as JModel
from tpucenterface.config import PreprocessConfig as JPre
from tpucenterface.data.synth import render_scene
from tpucenterface.detector import Detector as JDetector
from tpucenterface.eval.batch_runner import batched_detect as jbatched_detect
from tpucenterface.eval.batch_runner import batched_detect_tta as jbatched_detect_tta
from tpucenterface.weights.io import load_safetensors as jax_load
from tpucenterface_torch.eval.batch_runner import batched_detect, batched_detect_tta
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "artifacts", "flagship.safetensors")
BUCKETS = (64, 128)
SHAPES = [(60, 90), (100, 70), (128, 128), (150, 100), (90, 60), (70, 140), (120, 50)]
BOX_ATOL, SCORE_ATOL, FIRM = 1e-3, 1e-5, 0.05


def _match(a, b):
    """Every detection >= FIRM of either side has a partner on the other
    within BOX_ATOL px (corners and landmark points) and SCORE_ATOL."""
    for x, y in ((a, b), (b, a)):
        sel = x.scores >= FIRM
        if not sel.any():
            continue
        dist = np.abs(x.boxes[sel][:, None] - y.boxes[None]).max(-1)
        if x.landmarks is not None:
            dist = np.maximum(dist, np.abs(x.landmarks[sel][:, None] - y.landmarks[None]).max((-2, -1)))
        close = np.abs(x.scores[sel][:, None] - y.scores[None]) <= SCORE_ATOL
        assert ((dist <= BOX_ATOL) & close).any(1).all(), (x.scores[sel], y.scores)


def _pair(variables, model_kw=None):
    model_kw = dict(compute_dtype="float32", **(model_kw or {}))
    port = T.Detector(
        variables=variables,
        config=T.DetectorConfig(model=T.ModelConfig(**model_kw), decode=T.DecodeConfig(use_pallas=True),
                                preprocess=T.PreprocessConfig(resize_dtype="float32"), buckets=BUCKETS,
                                default_size=128),
        device="cpu",
    )
    ref = JDetector(
        variables=variables,
        config=JDetectorConfig(model=JModel(**model_kw), decode=JDecode(fast_topk=False),
                               preprocess=JPre(resize_dtype="float32"), buckets=BUCKETS, default_size=128),
    )
    return port, ref


@pytest.fixture(scope="module")
def pair():
    return _pair(jax_load(ARTIFACT))


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(31)
    return [render_scene(rng, hw=s)[0] for s in SHAPES]


def test_batched_detect_matches_jax(pair, images):
    """Mixed shapes, one chunk pre-sized at the model size (the identity
    program), ragged tails on the small rung."""
    port, ref = pair
    imgs = images + [render_scene(np.random.RandomState(5), hw=(128, 128))[0]]
    got = batched_detect(port, imgs, score_thresh=0.0, batch_size=4)
    want = jbatched_detect(ref, imgs, score_thresh=0.0, batch_size=4)
    assert len(got) == len(imgs)
    for a, b in zip(got, want):
        assert a.landmarks is None and len(a.scores) == 200
        _match(a, b)
    assert sum((a.scores >= 0.3).sum() for a in got) > 0


@pytest.mark.parametrize("scales,flip", [((0.7, 1.0), True), ((1.0,), False)])
def test_batched_detect_tta_matches_jax(pair, images, scales, flip):
    port, ref = pair
    log, jlog = [], []
    got = batched_detect_tta(port, images, scales=scales, flip=flip, batch_size=4, launch_log=log)
    want = jbatched_detect_tta(ref, images, scales=scales, flip=flip, batch_size=4, launch_log=jlog)
    assert log == jlog
    assert {shape for _, shape, _, _ in log} == {(128, 128), (256, 128), (128, 256)}
    assert {bs for bs, _, _, _ in log} == {1, 4}
    for a, b in zip(got, want):
        assert a.boxes.dtype == np.float32 and (np.diff(a.scores) <= 0).all()
        _match(a, b)
    assert sum((a.scores >= 0.3).sum() for a in got) > 0


def test_batched_detect_tta_fetches_in_launch_order(pair, images):
    """The depth of the pipeline of unfetched launches changes nothing."""
    port, _ = pair
    runs = [batched_detect_tta(port, images, scales=(0.7, 1.0), batch_size=4, inflight=k) for k in (0, 5)]
    for a, b in zip(*runs):
        assert a.boxes.tobytes() == b.boxes.tobytes() and a.scores.tobytes() == b.scores.tobytes()


def test_batched_detect_tta_landmarks_match_jax(images):
    """A landmark model (random weights from a seed): each surviving
    detection keeps the points of its variant, un-mirrored and pair-swapped
    where it came from the mirror, as in the JAX runner."""
    _, variables = T.model.centernet.init_model(T.ModelConfig(with_landmarks=True), seed=7)
    port, ref = _pair(variables, dict(with_landmarks=True))
    imgs = images[:3]
    got = batched_detect_tta(port, imgs, scales=(1.0,), batch_size=4, score_thresh=0.0, max_dets=50)
    want = jbatched_detect_tta(ref, imgs, scales=(1.0,), batch_size=4, score_thresh=0.0, max_dets=50)
    for a, b in zip(got, want):
        assert a.landmarks is not None and a.landmarks.shape == (len(a.scores), 5, 2) == b.landmarks.shape
        np.testing.assert_allclose(a.scores, b.scores, atol=SCORE_ATOL)
        _match(a, b)


# --------------------------------------------------------------------------- #
# the AP gates on the 240-scene split
# --------------------------------------------------------------------------- #


def _report(name):
    with open(os.path.join(ROOT, "runs", "flagship3", name)) as f:
        return json.load(f)["ap"]


@pytest.fixture(scope="module")
def val_split(tmp_path_factory):
    """The flagship recipe's held-out split (tests/test_flagship_anchor.py)
    and the port's Detector with the report's config."""
    from tpucenterface.data.synth import generate_dataset

    recs = generate_dataset(str(tmp_path_factory.mktemp("val240")), 240, seed=7777, hw_range=(384, 512),
                            min_face=18.0)
    cfg = T.DetectorConfig(decode=T.DecodeConfig(max_dets=100, use_pallas=True), default_size=320)
    return recs, T.Detector.from_safetensors(ARTIFACT, cfg, device="cpu")


def _within(ap, ref, what):
    for split in ("easy", "medium", "hard"):
        assert abs(ap[split] - ref[split]) <= 0.005, (what, split, ap, ref)


@pytest.mark.slow
def test_flagship_ap_240_scenes(val_split):
    from tpucenterface_torch.eval.synth_eval import ap_on_records

    recs, det = val_split
    ap = ap_on_records(det, recs, size=320)
    print("single", ap)
    _within(ap, _report("flagship_report.json")["model"], "single")


@pytest.mark.slow
@pytest.mark.parametrize("row,scales", [("flip", (0.7,)), ("flip_multiscale", (0.7, 1.0))])
def test_flagship_tta_ap_240_scenes(val_split, row, scales):
    from tpucenterface_torch.eval.synth_eval import ap_on_records_tta

    recs, det = val_split
    ap = ap_on_records_tta(det, recs, scales=scales, flip=True)
    print(row, ap)
    _within(ap, _report("flagship_tta.json")[row], row)
