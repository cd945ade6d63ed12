"""The port's WIDER scorer, NMS and landmark error against the JAX package's.

- The hand-computed fixtures of tests/test_ap_protocol.py and the cases of
  tests/test_wider_eval.py (but its annotation parser round trip: the port
  has only the record type of `data/wider.py`) run on the port's functions:
  each call of a scorer function goes to the JAX function too, and the two
  results must be equal, AP floats bit for bit; the fixture's own asserts
  then hold the port's result.
- `nms` and `bbox_overlaps` take the port's C++ kernels (`native/nms_ext.cpp`)
  as the JAX package takes its own whenever it can build them, which is
  here; `nms_plain` and `bbox_overlaps_plain` are the numpy loops. The
  kernels equal the JAX package's C++ functions and the numpy loops under
  hypothesis. The C++ `nms` casts the detections to float32: on float32
  detections (what the detector returns) the four routes agree, ties and
  IoUs within 1e-6 of the threshold included; on float64 detections near
  the threshold the C++ and numpy routes disagree, the port's C++ route
  with the JAX C++ route and its numpy loop with the JAX numpy loop (the
  case is pinned below).
- `landmark_nme` and `score_detections` against the JAX functions on records
  written to disk, read from their paths or passed as decoded images.
"""

import copy
import dataclasses
import importlib.util
import inspect
import os

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import tpucenterface.eval.synth_eval as jsynth
import tpucenterface.eval.tta as jtta
import tpucenterface.eval.wider_eval as jwider
from tpucenterface import native
from tpucenterface.data.wider import WiderImage as JWiderImage
from tpucenterface_torch import native as pnative
from tpucenterface_torch.data.wider import WiderImage
from tpucenterface_torch.detector import Detections
from tpucenterface_torch.eval import synth_eval, tta, wider_eval
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(name):
    """A private copy of a JAX test module, so that patching its names
    touches nothing pytest runs."""
    spec = importlib.util.spec_from_file_location(f"_port_copy_of_{name}", os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


AP_PROTOCOL = _load("test_ap_protocol")
WIDER_EVAL = _load("test_wider_eval")
# the annotation parser and writer are not ported (only WiderImage is)
NOT_PORTED = {"test_parse_and_write_roundtrip"}


def _tests(mod):
    return sorted(n for n in vars(mod) if n.startswith("test_") and n not in NOT_PORTED)


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def _both(name, jax_fn, port_fn, calls):
    """Call the JAX function and the port's on the same arguments; assert
    equal results and return the port's."""

    def run(*args, **kw):
        want = jax_fn(*copy.deepcopy(args), **copy.deepcopy(kw))
        got = port_fn(*args, **kw)
        assert _same(got, want), (name, got, want)
        calls.append(name)
        return got

    return run


def _run_fixture(mod, name, pairs, monkeypatch, tmp_path):
    calls = []
    for attr, (jax_fn, port_fn) in pairs.items():
        if attr in vars(mod):
            monkeypatch.setattr(mod, attr, _both(attr, jax_fn, port_fn, calls))
    for attr in ("load_wider_gt", "evaluate_wider"):  # imported inside the cases
        monkeypatch.setattr(jwider, attr, _both(attr, getattr(jwider, attr), getattr(wider_eval, attr), calls))
    fn = getattr(mod, name)
    fn(**{p: tmp_path for p in inspect.signature(fn).parameters})
    return calls


SCORER = {
    n: (getattr(jwider, n), getattr(wider_eval, n))
    for n in ("bbox_overlaps", "image_eval", "img_pr_info", "voc_ap", "evaluate_detections")
}


@pytest.mark.parametrize("name", _tests(AP_PROTOCOL))
def test_ap_protocol_fixture(name, monkeypatch, tmp_path):
    calls = _run_fixture(AP_PROTOCOL, name, SCORER, monkeypatch, tmp_path)
    assert calls, f"{name} called no scorer function"


@pytest.mark.parametrize("name", _tests(WIDER_EVAL))
def test_wider_eval_case(name, monkeypatch, tmp_path):
    pairs = dict(SCORER, nms=(jtta.nms, tta.nms), pick_bucket=(jtta.pick_bucket, tta.pick_bucket))
    calls = _run_fixture(WIDER_EVAL, name, pairs, monkeypatch, tmp_path)
    assert calls, f"{name} called no scorer function"


def test_fixture_lists_are_the_jax_ones():
    assert len(_tests(AP_PROTOCOL)) == 13
    assert len(_tests(WIDER_EVAL)) == 13
    assert wider_eval.NUM_THRESH == jwider.NUM_THRESH


# --------------------------------------------------------------------------- #
# nms
# --------------------------------------------------------------------------- #


def _jax_numpy_nms(dets, thresh, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(native, "nms", lambda *a: None)
        return jtta.nms(dets, thresh)


def _jax_native_nms(dets, thresh):
    assert native.available(), "the JAX package's C++ extension did not build"
    return jtta.nms(dets, thresh)


@st.composite
def near_threshold_dets(draw, dtype):
    """N boxes around one box: each either a copy shifted in x so that its
    IoU with the first is within 1e-6 of 0.4, or a random box; scores from a
    small set, so that ties are common."""
    n = draw(st.integers(1, 10))
    rows = []
    x0 = draw(st.floats(0, 300))
    y0 = draw(st.floats(0, 300))
    w = draw(st.floats(5, 200))
    h = draw(st.floats(5, 200))
    for i in range(n):
        score = draw(st.sampled_from([0.9, 0.8, 0.5, 0.3]))
        if i == 0 or draw(st.booleans()):
            t = 0.4 + draw(st.floats(-1e-6, 1e-6))
            dx = 0.0 if i == 0 else w * (1 - t) / (1 + t)
            rows.append([x0 + dx, y0, x0 + dx + w - 1, y0 + h - 1, score])
        else:
            bx, by = draw(st.floats(0, 400)), draw(st.floats(0, 400))
            rows.append([bx, by, bx + draw(st.floats(1, 150)), by + draw(st.floats(1, 150)), score])
    return np.asarray(rows, dtype)


@settings(max_examples=200, deadline=None)
@given(dets=near_threshold_dets(np.float32))
def test_nms_matches_both_jax_routes_on_float32(dets):
    with pytest.MonkeyPatch.context() as mp:
        want_numpy = _jax_numpy_nms(dets, 0.4, mp)
    got = tta.nms(dets, 0.4)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want_numpy)
    np.testing.assert_array_equal(got, _jax_native_nms(dets, 0.4))
    np.testing.assert_array_equal(tta.nms_plain(dets, 0.4), want_numpy)


@settings(max_examples=100, deadline=None)
@given(dets=near_threshold_dets(np.float64))
def test_nms_matches_the_jax_numpy_loop_on_float64(dets):
    """The port's numpy loop is the JAX numpy loop, its C++ route the JAX
    C++ route, on float64 detections too."""
    with pytest.MonkeyPatch.context() as mp:
        np.testing.assert_array_equal(tta.nms_plain(dets, 0.4), _jax_numpy_nms(dets, 0.4, mp))
    np.testing.assert_array_equal(tta.nms(dets, 0.4), _jax_native_nms(dets, 0.4))


def test_nms_float64_case_where_the_jax_routes_disagree(monkeypatch):
    """Two boxes whose IoU is 0.39999989 in float64 and 0.40000013 in float32:
    the numpy loops keep both, the C++ routes drop the second. The port's
    eval `nms` is the C++ route, as the JAX eval's is wherever its library
    builds (a reference-side discrepancy, ROADMAP §C)."""
    dets = np.array([
        [253.92260174, 209.8437826, 301.42352011, 399.62983984, 0.9],
        [274.70871485, 209.8437826, 322.20963321, 399.62983984, 0.9],
    ])
    np.testing.assert_array_equal(tta.nms_plain(dets, 0.4), [0, 1])
    np.testing.assert_array_equal(_jax_numpy_nms(dets, 0.4, monkeypatch), [0, 1])
    np.testing.assert_array_equal(tta.nms(dets, 0.4), [0])
    np.testing.assert_array_equal(_jax_native_nms(dets, 0.4), [0])
    np.testing.assert_array_equal(tta.nms(dets.astype(np.float32), 0.4), _jax_native_nms(dets.astype(np.float32), 0.4))


@st.composite
def box_sets(draw, dtype):
    """(N, 4) xyxy boxes, some degenerate (x2 < x1) or sharing edges."""
    n = draw(st.integers(0, 12))
    rows = []
    for _ in range(n):
        x, y = draw(st.floats(0, 300)), draw(st.floats(0, 300))
        rows.append([x, y, x + draw(st.floats(-3, 120)), y + draw(st.sampled_from([0.0, 1.0, 37.5, 90.0]))])
    return np.asarray(rows, dtype).reshape(n, 4)


@settings(max_examples=100, deadline=None)
@given(boxes=box_sets(np.float64), query=box_sets(np.float64), scores=st.lists(st.sampled_from([0.9, 0.5, 0.2]),
                                                                              min_size=12, max_size=12))
def test_native_kernels_equal_jax_native_and_numpy(boxes, query, scores):
    """`native.bbox_overlaps` and `native.nms` against the JAX package's C++
    functions (bit-equal) and the numpy loops (float64 IoU, as the scorer
    passes it, within 1e-12; NMS on float32 detections equal) on boxes of
    positive area."""
    got = pnative.bbox_overlaps(boxes, query)
    if len(boxes) and len(query):
        np.testing.assert_array_equal(got, native.bbox_overlaps(boxes, query))
    else:
        assert got.shape == (len(boxes), len(query))
    dets = np.concatenate([boxes, np.asarray(scores[: len(boxes)]).reshape(-1, 1)], axis=1).astype(np.float32)
    order = np.argsort(-dets[:, 4], kind="stable")
    np.testing.assert_array_equal(pnative.nms(dets[order], 0.4), native.nms(dets[order], 0.4))
    # against the numpy loops on boxes of positive area, as detections have:
    # on a box of negative area the loops divide by a union <= 0 (NaN or a
    # clamped 1e-10), where the C++ kernels skip the pair (in both packages)
    if (boxes[:, 2] >= boxes[:, 0]).all() and (query[:, 2] >= query[:, 0]).all():
        np.testing.assert_allclose(wider_eval.bbox_overlaps(boxes, query),
                                   wider_eval.bbox_overlaps_plain(boxes, query), rtol=0, atol=1e-12)
        np.testing.assert_array_equal(tta.nms(dets, 0.4), tta.nms_plain(dets, 0.4))


def test_native_library_is_per_host_and_a_failed_build_raises(tmp_path, monkeypatch):
    """The eval library is named by a hash of source, flags, compiler and
    host, as the staging library is; a build that fails raises (nothing
    falls back to the numpy loops), and a malformed array is refused."""
    here = pnative._library_path(pnative.NMS_SOURCE)
    assert here.name.startswith("nms_ext-") and pnative.available()
    bad = tmp_path / "nms_ext.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pnative, "NMS_SOURCE", bad)
    monkeypatch.setattr(pnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(pnative, "_nms_lib", None)
    assert not pnative.available()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tta.nms(np.ones((2, 5)), 0.4)
    assert not any((tmp_path / "build").glob("*.so"))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="rows of 5"):
        pnative.nms(np.ones((2, 4)), 0.4)


def test_nms_empty_and_pick_bucket():
    assert tta.nms(np.zeros((0, 5)), 0.4).dtype == np.int64 and len(tta.nms(np.zeros((0, 5)), 0.4)) == 0
    for target in (1, 320, 321, 700, 5000):
        assert tta.pick_bucket((320, 640, 1024), target) == jtta.pick_bucket((320, 640, 1024), target)


# --------------------------------------------------------------------------- #
# records: score_detections and landmark_nme
# --------------------------------------------------------------------------- #


def _records(tmp_path, n=7, seed=3):
    """(JAX records, port records, images): small random images written as
    PNG (read back bit-exact), each with boxes, an invalid flag, and
    landmarks (some unknown). Pixel (0, 0) holds 10 * (index + 1)."""
    rng = np.random.RandomState(seed)
    jrecs, precs, imgs = [], [], []
    for i in range(n):
        h, w = rng.randint(60, 140), rng.randint(60, 140)
        img = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
        img[0, 0] = 10 * (i + 1)
        path = str(tmp_path / f"img{i}.png")
        assert cv2.imwrite(path, img)
        m = rng.randint(0, 5)
        xy = rng.uniform(0, 40, (m, 2))
        boxes = np.concatenate([xy, rng.uniform(8, 60, (m, 2))], 1).astype(np.float32)
        invalid = rng.rand(m) < 0.2
        lm = (np.repeat(xy, 5, 0).reshape(m, 10) + rng.uniform(0, 20, (m, 10))).astype(np.float32)
        lm[rng.rand(m) < 0.2] = np.nan
        lm = lm if i % 3 else None
        jrecs.append(JWiderImage(path, f"e/img{i}.png", boxes, invalid, lm))
        precs.append(WiderImage(path, f"e/img{i}.png", boxes.copy(), invalid.copy(), None if lm is None else lm.copy()))
        imgs.append(img)
    return jrecs, precs, imgs


class _FakeDetector:
    """`detect_batch` answers each image by the record index painted into
    its pixel (0, 0): that record's boxes moved by a seeded offset, with
    landmarks; pad rows (pixel 0) get none."""

    def __init__(self, records, seed=0):
        rng = np.random.RandomState(seed)
        self.answers = []
        for rec in records:
            m = len(rec.boxes)
            boxes = rec.xyxy + rng.uniform(-4, 4, (m, 4)).astype(np.float32)
            extra = rng.uniform(0, 100, (2, 4)).astype(np.float32)
            extra[:, 2:] += extra[:, :2]
            boxes = np.concatenate([boxes, extra]).astype(np.float32)
            scores = np.sort(rng.rand(m + 2).astype(np.float32))[::-1].copy()
            lms = rng.uniform(0, 100, (m + 2, 5, 2)).astype(np.float32)
            if rec.landmarks is not None:
                lms[:m] = np.nan_to_num(rec.landmarks.reshape(m, 5, 2)) + rng.normal(0, 2, (m, 5, 2))
            self.answers.append((boxes, scores, lms))

    def detect_batch(self, images, hws=None, score_thresh=0.0, size=None):
        out = []
        for img in images:
            i = int(img[0, 0, 0]) // 10 - 1
            if i < 0:
                out.append(Detections(np.zeros((0, 4), np.float32), np.zeros(0, np.float32), None))
                continue
            boxes, scores, lms = self.answers[i]
            keep = scores >= score_thresh
            out.append(Detections(boxes[keep], scores[keep], lms[keep]))
        return out


@pytest.mark.parametrize("min_side", [0.0, 20.0])
@pytest.mark.parametrize("batch", [1, 4])
def test_landmark_nme_matches_jax(tmp_path, min_side, batch):
    jrecs, precs, imgs = _records(tmp_path)
    fake = _FakeDetector(precs)
    kw = dict(score_thresh=0.2, min_side=min_side, batch=batch)
    want = jsynth.landmark_nme(fake, jrecs, **kw)
    assert want["faces"] > 0 and 0 < want["match_rate"] <= 1
    for images in (None, imgs):
        got = synth_eval.landmark_nme(fake, precs, images=images, **kw)
        assert _same(got, want), (got, want)


def test_score_detections_and_ap_on_records_match_jax(tmp_path):
    """`ap_on_records` (paths and decoded images) and `score_detections`
    against the JAX functions, through one detector answering by record."""
    jrecs, precs, imgs = _records(tmp_path)
    fake = _FakeDetector(precs)
    want = jsynth.ap_on_records(fake, jrecs, batch=3)
    for images in (None, imgs):
        assert _same(synth_eval.ap_on_records(fake, precs, batch=3, images=images), want)
    dets = [np.concatenate([d.boxes, d.scores[:, None]], 1) for d in fake.detect_batch(imgs)]
    splits = (("all", 0.0), ("big", 30.0))
    assert _same(synth_eval.score_detections(dets, precs, splits), jsynth.score_detections(dets, jrecs, splits))
    assert synth_eval.DEFAULT_SPLITS == jsynth.DEFAULT_SPLITS
    with pytest.raises(ValueError, match="images for"):
        synth_eval.ap_on_records(fake, precs, images=imgs[:-1])


def test_wider_image_is_the_jax_record():
    rng = np.random.RandomState(0)
    boxes = rng.uniform(0, 50, (3, 4)).astype(np.float32)
    a = WiderImage("p", "r", boxes, np.zeros(3, bool))
    b = JWiderImage("p", "r", boxes, np.zeros(3, bool))
    np.testing.assert_array_equal(a.xyxy, b.xyxy)
    assert a.landmarks is None
    assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
