"""The port's `tcf.<layer>` spans (`runtime.profiling.annotate`) on the CPU:
the layer boundaries of `Detector.detect_batch`, `eval.batch_runner`'s
`batched_detect_tta` and `batched_detect`, and the program cache's
`tcf.build`, read from torch.profiler's events, on a small random detector.
Names and counts are what the benchmark's span readers (`perfbench/spans.py`)
group by: fixed names, none inside a per-image or per-block loop."""

import collections
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpucenterface_torch as T
from tpucenterface_torch.eval.batch_runner import batched_detect, batched_detect_tta
from tpucenterface_torch.preprocess import pad_to_bucket
from tpucenterface_torch.runtime.profiling import WORK_RANGE_PREFIX, annotate
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

LAYERS = ["tcf.stage", "tcf.preprocess", "tcf.forward", "tcf.decode", "tcf.results"]
# padded to (128, 128) (five: two chunks of 4) and (256, 128) (two: one chunk); at scales 0.5 and 1
# a frame runs at bucket 32, 64 or both
SHAPES = [(60, 90), (100, 70), (150, 100), (90, 60), (200, 120), (120, 40), (30, 50)]


def _detector(**model):
    cfg = T.DetectorConfig(model=T.ModelConfig(width_mult=0.35, compute_dtype="float32", **model),
                           decode=T.DecodeConfig(max_dets=20), buckets=(32, 64), default_size=64)
    return T.Detector(config=cfg, device="cpu", seed=3)


@pytest.fixture(scope="module")
def det():
    return _detector(with_landmarks=True)


def _frames(shapes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, hw + (3,)).astype(np.uint8) for hw in shapes]


def _spans(fn):
    """fn()'s result and the `tcf.` spans it opened, in order of start:
    (name, start, end) in microseconds; work ranges (`tcf::`) left out."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.name.startswith("tcf.") and not e.name.startswith(WORK_RANGE_PREFIX))
    return out, [(n, s, e) for s, e, n in spans]


def _names(spans):
    return [n for n, _, _ in spans]


def _disjoint(spans):
    return all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("batch", [1, 3])
def test_detect_batch_opens_each_layer_once_in_order(det, batch):
    """Five spans a call whatever the batch: none sits in a per-image loop;
    no two overlap, so a stretch of the timeline is put down to one layer."""
    imgs = np.stack(_frames([(64, 64)] * batch))
    det.detect_batch(imgs, score_thresh=0.0)  # the program of this signature built
    _, spans = _spans(lambda: det.detect_batch(imgs, score_thresh=0.0))
    assert _names(spans) == LAYERS
    assert _disjoint(spans)


def test_first_call_of_a_signature_opens_build(det):
    imgs = np.stack(_frames([(96, 80)] * 2))
    _, first = _spans(lambda: det.detect_batch(imgs, score_thresh=0.0))
    _, second = _spans(lambda: det.detect_batch(imgs, score_thresh=0.0))
    assert _names(first) == ["tcf.build"] + LAYERS
    assert _names(second) == LAYERS


def _chunks(images, batch_size):
    """The runners' launches of inputs: each padded shape's frames in chunks."""
    by_shape = collections.Counter(pad_to_bucket(img).shape[:2] for img in images)
    return sum(-(-n // batch_size) for n in by_shape.values())


def test_tta_spans_follow_chunks_and_launches(det):
    """Pad first, merge last; one assemble and one stage a chunk, one
    preprocess, forward, decode and results a launch (`launch_log`)."""
    images = _frames(SHAPES)
    batched_detect_tta(det, images, scales=(0.5, 1.0), flip=True, batch_size=4)  # every program built
    log = []
    _, spans = _spans(lambda: batched_detect_tta(det, images, scales=(0.5, 1.0), flip=True, batch_size=4,
                                                 launch_log=log))
    names = _names(spans)
    chunks = _chunks(images, 4)
    assert chunks == 3 and {shape for _, shape, _, _ in log} == {(128, 128), (256, 128)}
    assert names[0] == "tcf.tta.pad" and names[-1] == "tcf.tta.merge"
    assert names.count("tcf.tta.pad") == names.count("tcf.tta.merge") == 1
    assert names.count("tcf.tta.assemble") == names.count("tcf.stage") == chunks
    for layer in LAYERS[1:]:
        assert names.count(layer) == len(log), layer
    # each chunk: assemble, then its copy, then its launches
    starts = [k for k, n in enumerate(names) if n == "tcf.tta.assemble"]
    assert all(names[k + 1] == "tcf.stage" for k in starts)
    assert "tcf.build" not in names and _disjoint(spans)
    assert len(spans) == 2 + 2 * chunks + 4 * len(log)


def test_batched_detect_stages_through_stage_inputs(det):
    """`batched_detect`'s copies go through `stage_inputs`: one `tcf.stage`
    and one `tcf.results` a launch, with the answers of a call untraced."""
    images = _frames(SHAPES, seed=1)
    want = batched_detect(det, images, score_thresh=0.0, batch_size=4)
    got, spans = _spans(lambda: batched_detect(det, images, score_thresh=0.0, batch_size=4))
    names = _names(spans)
    chunks = _chunks(images, 4)
    for layer in LAYERS:
        assert names.count(layer) == chunks, layer
    for a, b in zip(got, want):
        assert a.boxes.tobytes() == b.boxes.tobytes() and a.scores.tobytes() == b.scores.tobytes()
        assert a.landmarks.tobytes() == b.landmarks.tobytes()


def test_annotate_is_a_null_context_without_a_profiler(det):
    """No profiler: `annotate` hands back one shared null context and the
    answers are bit-equal to a traced call's; under one, a profiler range."""
    assert not torch.autograd._profiler_enabled()
    assert annotate("tcf.x") is annotate("tcf.y")
    assert isinstance(annotate("tcf.x"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(annotate("tcf.x"), torch.profiler.record_function)
    imgs = np.stack(_frames([(80, 64)] * 2))
    hws = np.array([[80, 64], [64, 48]], np.int32)  # the second frame's content a corner of its array
    plain = det.detect_batch(imgs, hws, score_thresh=0.0)
    traced, spans = _spans(lambda: det.detect_batch(imgs, hws, score_thresh=0.0))
    assert _names(spans)[-len(LAYERS):] == LAYERS
    for a, b in zip(plain, traced):
        for x, y in zip((a.boxes, a.scores, a.landmarks), (b.boxes, b.scores, b.landmarks)):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_tta_without_landmarks_and_flip_keeps_the_spans():
    """A model without landmarks, TTA without flip (the plain batch program
    at each bucket): the same spans a chunk and a launch."""
    det = _detector()
    images = _frames(SHAPES[:3], seed=2)
    batched_detect_tta(det, images, scales=(1.0,), flip=False, batch_size=4)
    log = []
    out, spans = _spans(lambda: batched_detect_tta(det, images, scales=(1.0,), flip=False, batch_size=4,
                                                   launch_log=log))
    names = _names(spans)
    assert len(out) == 3 and all(d.landmarks is None for d in out)
    assert names.count("tcf.stage") == names.count("tcf.tta.assemble") == _chunks(images, 4)
    assert names.count("tcf.forward") == names.count("tcf.results") == len(log) > 0
    assert names[0] == "tcf.tta.pad" and names[-1] == "tcf.tta.merge"
