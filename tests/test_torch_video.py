"""The port's pipelined video detection (`tpucenterface_torch/runtime/
video.py`) on the CPU: the counterparts of tests/test_video.py (model input
64, float32 compute, random weights from a seed; a pipelined or coalesced
frame against a direct `detect` within 1e-5 in score and 1e-3 px, as the JAX
file states), and the JAX `MultiStreamPipeline` against the port's on the
same streams and the flagship weights carried across: every detection >=
0.05 of either side matched within 1e-4 in score, as in
tests/test_torch_serving.py's engine comparisons, and within 1e-3 px, the
float32 box bound of tests/test_torch_detector.py (the 90x120 frames are
letterboxed to 64, so the inverse letterbox multiplies the heads' float32
differences by 120/64: measured up to 1.4e-4 px, against 1.3e-5 px on the
pre-sized requests of the engine comparisons)."""

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
from tpucenterface.runtime.video import MultiStreamPipeline as JMultiStreamPipeline
from tpucenterface.weights.io import load_safetensors as jax_load
from tpucenterface_torch.runtime.video import MultiStreamPipeline, VideoPipeline, draw_detections

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "artifacts", "flagship.safetensors")


def _det(seed):
    cfg = T.DetectorConfig(model=T.ModelConfig(compute_dtype="float32"), default_size=64)
    return T.Detector(config=cfg, device="cpu", seed=seed)


def _frames(n, h=96, w=128):
    rng = np.random.RandomState(0)
    for _ in range(n):
        yield rng.randint(0, 255, (h, w, 3), np.uint8)


def test_video_pipeline_yields_all_frames():
    det = _det(0)
    pipe = VideoPipeline(det, size=64, depth=2)
    results = list(pipe.run(_frames(6), score_thresh=0.0))
    assert len(results) == 6
    for (frame, boxes, scores), src in zip(results, _frames(6)):
        assert frame.shape == (96, 128, 3) and np.array_equal(frame, src)
        assert boxes.shape[1] == 4 and len(boxes) == len(scores)
        if len(boxes):  # boxes within the original frame
            assert boxes[:, 2].max() <= 128 + 1e-3
            assert boxes[:, 3].max() <= 96 + 1e-3
        ref = det.detect(src, score_thresh=0.0)
        np.testing.assert_allclose(scores, ref.scores, atol=1e-5)
        np.testing.assert_allclose(boxes, ref.boxes, atol=1e-3)
    assert pipe.last_fps > 0 and len(pipe.steady_latencies_ms) == 6


def test_draw_detections_shapes():
    frame = np.zeros((96, 128, 3), np.uint8)
    out = draw_detections(frame, np.array([[10, 10, 50, 60]], np.float32), np.array([0.9]),
                          landmarks=np.array([[[20, 30], [40, 30], [30, 40], [22, 50], [38, 50]]], np.float32))
    assert out.shape == frame.shape
    assert out.sum() > 0 and frame.sum() == 0  # drawn on a copy


def test_multi_stream_pipeline_matches_direct():
    """Three streams coalesce through one engine; per-stream order and
    per-frame results match a direct detect()."""
    det = _det(2)
    rng = np.random.RandomState(6)
    streams = [[rng.randint(0, 255, (50, 60, 3), np.uint8) for _ in range(4)] for _ in range(3)]
    pipe = MultiStreamPipeline(det, n_streams=3, score_thresh=-1.0)
    per_stream = {0: [], 1: [], 2: []}
    for si, frame, dets in pipe.run(streams):
        per_stream[si].append((frame, dets))
    for si, items in per_stream.items():
        assert len(items) == 4
        for (frame, dets), orig in zip(items, streams[si]):
            assert frame is orig  # order kept
            ref = det.detect(orig, score_thresh=-1.0)
            np.testing.assert_allclose(dets.scores, ref.scores, atol=1e-5)
            np.testing.assert_allclose(dets.boxes, ref.boxes, atol=1e-3)
    assert pipe._engine is None  # closed at the end of the run


def test_multi_stream_rejects_mixed_buckets():
    streams = [[np.zeros((50, 60, 3), np.uint8)], [np.zeros((200, 60, 3), np.uint8)]]  # two pad buckets
    pipe = MultiStreamPipeline(_det(2), n_streams=2, score_thresh=-1.0)
    with pytest.raises(ValueError):
        list(pipe.run(streams))


def test_video_pipeline_mid_stream_resolution_change():
    """A stream whose frames change resolution mid-flight re-dispatches to
    the new bucket's program."""
    det64 = _det(7)
    rng = np.random.RandomState(5)
    frames = [rng.randint(0, 255, (64, 64, 3), np.uint8) for _ in range(3)]
    frames += [rng.randint(0, 255, (96, 64, 3), np.uint8) for _ in range(3)]
    out = list(VideoPipeline(det64, size=64).run(iter(frames), score_thresh=-1.0))
    assert len(out) == 6
    for (frame, boxes, scores), src in zip(out, frames):
        assert frame is src
        ref = det64.detect(src, score_thresh=-1.0)
        np.testing.assert_allclose(scores, ref.scores, atol=1e-5)


def test_multi_stream_pipeline_matches_jax():
    """The JAX pipeline and the port's on the same four streams of painted
    frames (one 128x128 bucket), flagship weights: the same per-stream
    order, each frame's detections matched."""
    variables = jax_load(ARTIFACT)
    port = T.Detector(
        variables=variables,
        config=T.DetectorConfig(model=T.ModelConfig(compute_dtype="float32"), decode=T.DecodeConfig(max_dets=50),
                                preprocess=T.PreprocessConfig(resize_dtype="float32"), default_size=64),
        device="cpu",
    )
    ref = JDetector(
        variables=variables,
        config=JDetectorConfig(model=JModel(compute_dtype="float32"), decode=JDecode(fast_topk=False, max_dets=50),
                               preprocess=JPre(resize_dtype="float32"), default_size=64),
    )
    rng = np.random.RandomState(8)
    streams = [[render_scene(rng, hw=(90, 120))[0] for _ in range(3)] for _ in range(4)]
    runs = {}
    for name, cls, d in (("port", MultiStreamPipeline, port), ("jax", JMultiStreamPipeline, ref)):
        runs[name] = {si: [] for si in range(4)}
        for si, frame, dets in cls(d, n_streams=4, score_thresh=0.0).run(streams):
            runs[name][si].append((frame, dets))
    for si in range(4):
        assert [f for f, _ in runs["port"][si]] == [f for f, _ in runs["jax"][si]] == streams[si]
        for (_, a), (_, b) in zip(runs["port"][si], runs["jax"][si]):
            for x, y in ((a, b), (b, a)):
                sel = x.scores >= 0.05
                if not sel.any():
                    continue
                dist = np.abs(x.boxes[sel][:, None] - y.boxes[None]).max(-1)
                close = np.abs(x.scores[sel][:, None] - y.scores[None]) <= 1e-4
                assert ((dist <= 1e-3) & close).any(1).all(), (x.scores[sel], y.scores)
    assert sum((d.scores >= 0.3).sum() for items in runs["port"].values() for _, d in items) > 0
