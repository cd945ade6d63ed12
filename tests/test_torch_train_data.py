"""The port's data pipeline against the JAX package's (`tpucenterface/data/`).

Targets, the augment stream, loader batches (sequential and thread-pooled,
boxes-only and landmark) and synth scenes are held bit-equal to the JAX
package's for the same seeds and inputs; the WIDER parsers and the
submission writer give equal records and files. The cases are those of
tests/test_targets.py, tests/test_train.py, tests/test_synth.py and
tests/test_landmarks.py. All of it is numpy and OpenCV on both sides.
"""

import os

import cv2
import numpy as np
import pytest

from tpucenterface.data import augment as jaug
from tpucenterface.data import loader as jloader
from tpucenterface.data import synth as jsynth
from tpucenterface.data import targets as jtargets
from tpucenterface.data import wider as jwider
from tpucenterface.config import TrainConfig as JTrain
from tpucenterface_torch.config import TrainConfig
from tpucenterface_torch.data import augment, loader, synth, targets, wider
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)


def _equal(a, b, what=""):
    """Bit-equal nested outputs (dicts, tuples, arrays, scalars)."""
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _equal(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif a is None:
        assert b is None, what
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=what)


def _records(mod, root, n=10, landmarks=False):
    rng = np.random.RandomState(0)
    out = []
    for i in range(n):
        path = os.path.join(root, f"im{i}.jpg")
        if not os.path.exists(path):
            img = rng.randint(0, 255, (80, 100, 3), np.uint8)
            img[20:50, 30:70] = 255
            cv2.imwrite(path, img)
        boxes = np.array([[30.0, 20.0, 40.0, 30.0], [5.0, 50.0, 20.0, 25.0], [60, 5, 1, 1]], np.float32)
        lms = None
        if landmarks:
            lms = np.random.RandomState(i).uniform(10, 70, (3, 10)).astype(np.float32)
            lms[1] = np.nan
        out.append(mod.WiderImage(path=path, rel_path=f"ev/im{i}.jpg", boxes=boxes,
                                  invalid=np.array([False, False, i % 2 == 1]), landmarks=lms))
    return out


@pytest.mark.parametrize("case", ["layout", "subpixel", "wh_log", "degenerate", "crowd", "landmarks"])
def test_targets_bit_equal(case):
    rng = np.random.RandomState(len(case))
    kw = dict(input_size=160, stride=4, max_objs=8)
    lms = None
    if case == "layout":
        boxes = np.array([[8, 16, 40, 56], [100, 100, 140, 130]], np.float32)
    elif case == "subpixel":
        boxes, kw = np.array([[10, 10, 21, 23]], np.float32), dict(input_size=64, stride=4, max_objs=4)
    elif case == "wh_log":
        boxes, kw = np.array([[0, 0, 40, 80], [3, 7, 4, 9]], np.float32), dict(input_size=160, wh_log=True)
    elif case == "degenerate":
        boxes = np.array([[5, 5, 5, 5], [200, 200, 300, 300], [120, 120, 220, 220], [-9, -9, 3, 4]], np.float32)
    else:
        xy = rng.uniform(-20, 150, (12, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(1, 60, (12, 2))], axis=1).astype(np.float32)
        if case == "landmarks":
            lms = rng.uniform(0, 160, (12, 10)).astype(np.float32)
            lms[[2, 5]] = np.nan
    got = targets.make_targets(boxes, landmarks=lms, **kw)
    want = jtargets.make_targets(boxes, landmarks=lms, **kw)
    _equal(got, want)
    if case == "layout":
        assert got["ind"][0] == 9 * 40 + 6 and got["hm"][9, 6, 0] == 1.0
    if case == "landmarks":
        assert got["lm_mask"].sum() < got["mask"].sum()


def test_gaussian_helpers_bit_equal():
    for h, w in ((10, 10), (40, 40), (4, 4), (3.0, 57.0), (0.5, 0.5)):
        assert targets.gaussian_radius(h, w) == jtargets.gaussian_radius(h, w)
    for center, radius in (((8, 8), 3), ((0, 0), 3), ((15, 2), 5), ((3, 15), 0)):
        a, b = np.zeros((16, 16), np.float32), np.zeros((16, 16), np.float32)
        targets.draw_gaussian(a, center, radius)
        jtargets.draw_gaussian(b, center, radius)
        _equal(a, b)


@pytest.mark.parametrize("landmarks", [False, True], ids=["boxes", "landmarks"])
def test_augment_stream_bit_equal(landmarks):
    """augment_train draws the same numbers in the same order: ten images in
    a row from one RandomState give the JAX canvases, boxes and landmark
    rows bit for bit."""
    cfg, jcfg = TrainConfig(input_size=96), JTrain(input_size=96)
    src = np.random.RandomState(1)
    r1, r2 = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(10):
        img = src.randint(0, 255, (120, 90, 3), np.uint8)
        xy = src.uniform(0, 70, (4, 2))
        boxes = np.concatenate([xy, xy + src.uniform(2, 40, (4, 2))], axis=1).astype(np.float32)
        lms = src.uniform(0, 90, (4, 10)).astype(np.float32) if landmarks else None
        _equal(augment.augment_train(img, boxes, cfg, r1, landmarks=lms),
               jaug.augment_train(img, boxes, jcfg, r2, landmarks=lms))
    assert r1.rand() == r2.rand()


def test_augment_pieces_bit_equal():
    """random_affine, hflip, color_jitter, filter_boxes and _clip_and_keep
    on the JAX tests' cases and on empty box sets."""
    img = np.zeros((100, 200, 3), np.uint8)
    img[20:40, 50:90] = 255
    boxes = np.array([[50.0, 20.0, 90.0, 40.0]], np.float32)
    lms = np.arange(10, dtype=np.float32).reshape(1, 10) * 9
    for b, lm in ((boxes, None), (boxes, lms), (np.zeros((0, 4), np.float32), None)):
        _equal(augment.random_affine(img, b, 128, np.random.RandomState(0), landmarks=lm),
               jaug.random_affine(img, b, 128, np.random.RandomState(0), landmarks=lm))
        _equal(augment.hflip(img, b, landmarks=lm), jaug.hflip(img, b, landmarks=lm))
    _equal(augment.color_jitter(img, np.random.RandomState(3)), jaug.color_jitter(img, np.random.RandomState(3)))
    many = np.array([[-5, -5, 10, 10], [0, 0, 1, 1], [120, 3, 200, 90], [10, 10, 12.5, 30]], np.float32)
    for b in (many, np.zeros((0, 4), np.float32)):
        _equal(augment.filter_boxes(b, 128), jaug.filter_boxes(b, 128))
        _equal(augment._clip_and_keep(b, 128, 2.0), jaug._clip_and_keep(b, 128, 2.0))
    _, b2 = augment.hflip(np.zeros((10, 20, 3), np.uint8), np.array([[2.0, 1.0, 8.0, 5.0]]))
    np.testing.assert_allclose(b2, [[12.0, 1.0, 18.0, 5.0]])


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("landmarks", [False, True], ids=["boxes", "landmarks"])
def test_loader_batches_bit_equal(tmp_path, workers, landmarks):
    """batch_iterator over two epochs: the sequential stream (workers=0) and
    the bounded thread-pool window with per-sample RandomState(seed, epoch,
    idx) streams (workers=2) give the JAX package's batches bit for bit,
    on boxes-only records and on landmark records with NaN rows; an
    unreadable record is skipped on both sides."""
    root = str(tmp_path)
    recs, jrecs = _records(wider, root, landmarks=landmarks), _records(jwider, root, landmarks=landmarks)
    recs[4].path = jrecs[4].path = os.path.join(root, "missing.jpg")
    kw = dict(input_size=64, batch_size=4, max_objs=8, with_landmarks=landmarks)
    got = list(loader.batch_iterator(recs, TrainConfig(**kw), seed=3, epochs=2, workers=workers, wh_log=True))
    want = list(jloader.batch_iterator(jrecs, JTrain(**kw), seed=3, epochs=2, workers=workers, wh_log=True))
    assert len(got) == len(want) == 4
    _equal(got, want)
    assert got[0]["image"].shape == (4, 64, 64, 3) and got[0]["image"].dtype == np.uint8
    assert got[0]["hm"].shape == (4, 16, 16, 1) and got[0]["ind"].shape == (4, 8)
    assert ("lm" in got[0]) == landmarks


def test_build_sample_bit_equal(tmp_path):
    rec, jrec = _records(wider, str(tmp_path), 1, True)[0], _records(jwider, str(tmp_path), 1, True)[0]
    img = np.random.RandomState(2).randint(0, 255, (70, 90, 3), np.uint8)
    for wl in (False, True):
        cfg, jcfg = TrainConfig(input_size=64, max_objs=4, with_landmarks=wl), JTrain(input_size=64, max_objs=4,
                                                                                      with_landmarks=wl)
        for given in (None, img):
            _equal(loader.build_sample(rec, cfg, np.random.RandomState(1), img=given),
                   jloader.build_sample(jrec, jcfg, np.random.RandomState(1), img=given))
    rec.path = os.path.join(str(tmp_path), "missing.jpg")
    assert loader.build_sample(rec, TrainConfig(), np.random.RandomState(0)) is None


@pytest.mark.parametrize("hw", [(240, 320), (200, 280), (97, 131)])
def test_render_scene_bit_equal(hw):
    for seed in range(3):
        for lm in (False, True):
            _equal(synth.render_scene(np.random.RandomState(seed), hw, return_landmarks=lm),
                   jsynth.render_scene(np.random.RandomState(seed), hw, return_landmarks=lm))


def _rec_fields(recs, root):
    return [(os.path.relpath(r.path, root), r.rel_path, r.boxes, r.invalid, r.landmarks) for r in recs]


def test_generate_dataset_bit_equal_and_cached(tmp_path, monkeypatch):
    """The same records and the same jpg bytes as the JAX package's; a second
    call reads the meta sidecar and renders nothing; files that exist are
    reused, not rewritten; a changed scene parameter renders new files."""
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    kw = dict(seed=11, hw_range=(96, 128), min_face=12.0)
    got = synth.generate_dataset(a, 6, **kw)
    want = jsynth.generate_dataset(b, 6, **kw)
    _equal(_rec_fields(got, a), _rec_fields(want, b))
    for r, s in zip(got, want):
        with open(r.path, "rb") as f, open(s.path, "rb") as g:
            assert f.read() == g.read(), r.rel_path
    meta = [n for n in os.listdir(os.path.join(a, "synth")) if n.startswith(".meta_")]
    assert meta == [n for n in os.listdir(os.path.join(b, "synth")) if n.startswith(".meta_")]
    mtimes = [os.path.getmtime(r.path) for r in got]

    def boom(*a, **k):
        raise AssertionError("the cached path rendered a scene")

    monkeypatch.setattr(synth, "render_scene", boom)
    again = synth.generate_dataset(a, 6, **kw)
    _equal(_rec_fields(again, a), _rec_fields(got, a))
    assert [os.path.getmtime(r.path) for r in again] == mtimes
    monkeypatch.undo()
    os.remove(os.path.join(a, "synth", meta[0]))
    rerun = synth.generate_dataset(a, 6, **kw)  # no sidecar: renders, reuses the jpgs
    assert [os.path.getmtime(r.path) for r in rerun] == mtimes
    other = synth.generate_dataset(a, 3, seed=11, hw_range=(160, 200), min_face=18.0)
    for r, s in zip(got, other):
        assert r.rel_path != s.rel_path and os.path.exists(r.path)
        h, w = cv2.imread(s.path).shape[:2]
        assert 160 <= h <= 200 and 160 <= w <= 200


def test_parsers_and_writer_match_jax(tmp_path):
    """parse_bbx_gt (the official file's n == 0 quirk line, invalid flags,
    min_size), parse_retinaface_gt (landmark triplets, -1 rows, box-only
    lines and files), iter_event_images and write_wider_detections."""
    gt = tmp_path / "bbx_gt.txt"
    gt.write_text(
        "0--Parade/0_Parade_1.jpg\n2\n449 330 122 149 0 0 0 0 0 0\n10 20 3 4 2 0 0 1 0 0\n"
        "0--Parade/0_Parade_2.jpg\n0\n0 0 0 0 0 0 0 0 0 0\n"
        "1--Handshaking/1_Handshaking_3.jpg\n1\n5 6 7 8\n"
    )
    label = tmp_path / "label.txt"
    label.write_text(
        "# 0--Parade/0_Parade_1.jpg\n"
        "449 330 122 149 488.9 373.6 0.0 542.0 376.4 0.0 515.0 412.8 0.0 "
        "485.3 423.0 0.0 538.3 431.4 0.0 0.82\n"
        "10 20 30 40 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1\n"
        "5 5 0 0 1 1 1 1 1 1 1 1 1 1 1 1 1 1 1 1\n"
        "# 1--Handshaking/1_Handshaking_2.jpg\n"
        "1 2 3 4\n"
    )

    def fields(recs):
        return [(r.path, r.rel_path, r.boxes, r.invalid, r.landmarks) for r in recs]

    for min_size in (0.0, 5.0):
        _equal(fields(wider.parse_bbx_gt(str(gt), "/imgs", min_size)),
               fields(jwider.parse_bbx_gt(str(gt), "/imgs", min_size)))
        _equal(fields(wider.parse_retinaface_gt(str(label), "/imgs", min_size)),
               fields(jwider.parse_retinaface_gt(str(label), "/imgs", min_size)))
    recs = wider.parse_retinaface_gt(str(label), "/imgs")
    assert np.isnan(recs[0].landmarks[1]).all() and recs[1].landmarks is None
    root = tmp_path / "val"
    for ev, names in (("1--b", ["x.jpg", "y.PNG", "notes.txt"]), ("0--a", ["z.jpeg"])):
        (root / ev).mkdir(parents=True)
        for n in names:
            (root / ev / n).write_bytes(b"")
    (root / "stray.jpg").write_bytes(b"")
    assert list(wider.iter_event_images(str(root))) == list(jwider.iter_event_images(str(root)))
    boxes = np.array([[1.25, 2.5, 30.75, 44.0], [0, 0, 9.96, 9.94]], np.float32)
    scores = np.array([0.91234, 0.0004], np.float32)
    wider.write_wider_detections(str(tmp_path / "p"), "0--a/z.jpeg", boxes, scores)
    jwider.write_wider_detections(str(tmp_path / "j"), "0--a/z.jpeg", boxes, scores)
    assert (tmp_path / "p" / "0--a" / "z.txt").read_text() == (tmp_path / "j" / "0--a" / "z.txt").read_text()
