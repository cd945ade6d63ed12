"""The port's serving runtime (`tpucenterface_torch/runtime/serving.py`) and
the Detector's atomic swaps, on the CPU.

- The port's counterpart of every case of tests/test_serving.py but those of
  `mesh=` (in tests/test_torch_sharding.py) and of `bench/slo_sweep.py`
  (not ported). As in the JAX file: model input 64, float32 compute, one
  module-scoped Detector (random weights from a seed); a coalesced launch
  against a direct `detect_batch` of the same images within 1e-5 in score
  and 1e-3 px, as the JAX file states.
- The same requests through the JAX `ServingEngine` / `ServingRouter` and
  the port's, on the flagship weights carried across, float32 compute and
  resize, input 64: per request and image, every detection >= 0.05 of either
  side has a partner on the other within 1e-4 px (box corners) and 1e-4 in
  score (the packages differ in float32 summation order only; the
  port-against-JAX float32 programs agree within 1e-5 and 1e-3 px at 320,
  tests/test_torch_detector.py, and closer at 64).
- The Detector's swaps (`reload_weights`, `quantize`, `dequantize`) against
  programs running in another thread: every result is one generation's
  output, bit for bit, and a program keeps the generation it was built on.
- The int8-input engine is bit-identical to the uint8 engine on the same
  quantized detector; the native table staging equals the numpy one.

Every `result()` and `join()` takes a timeout: a deadlock fails the test.
"""

import os
import subprocess
import sys
import threading

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
from tpucenterface.runtime.serving import ServingEngine as JServingEngine
from tpucenterface.runtime.serving import ServingRouter as JServingRouter
from tpucenterface.weights.io import load_safetensors as jax_load
from tpucenterface_torch.model.centernet import init_model
from tpucenterface_torch.runtime.serving import ServingEngine, ServingRouter
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "artifacts", "flagship.safetensors")
HW = (64, 64)
T_OUT = 120  # seconds any one future or join may take


def _cfg(**model_kw):
    return T.DetectorConfig(model=T.ModelConfig(compute_dtype="float32", **model_kw), default_size=64)


@pytest.fixture(scope="module")
def det():
    return T.Detector(config=_cfg(), device="cpu", seed=0)


def _requests(n_req, bs, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, (bs, *HW, 3), np.uint8) for _ in range(n_req)]


def _close(a, b, score_atol=1e-5, box_atol=1e-3):
    np.testing.assert_allclose(a.scores, b.scores, atol=score_atol)
    np.testing.assert_allclose(a.boxes, b.boxes, atol=box_atol)


def _same(a, b):
    assert a.boxes.tobytes() == b.boxes.tobytes() and a.scores.tobytes() == b.scores.tobytes()


def _spy(eng):
    """Record the launch size of every `_fn` call of `eng`."""
    launches = []
    orig = eng._fn

    def spy(batch, **kw):
        launches.append(batch)
        return orig(batch, **kw)

    eng._fn = spy
    return launches


# --------------------------------------------------------------------------- #
# the port's counterparts of tests/test_serving.py
# --------------------------------------------------------------------------- #


def test_map_stream_matches_direct(det):
    reqs = _requests(6, 4)
    eng = ServingEngine(det, HW, device_batch=16, score_thresh=-1.0)
    got = list(eng.map_stream((r, None) for r in reqs))
    assert len(got) == 6
    for req_imgs, dets in zip(reqs, got):
        direct = det.detect_batch(req_imgs, score_thresh=-1.0)
        assert len(dets) == len(direct) == 4
        for a, b in zip(dets, direct):
            _close(a, b)


def test_map_stream_coalesces_launches(det):
    eng = ServingEngine(det, HW, device_batch=16, score_thresh=-1.0)
    launches = _spy(eng)
    out = list(eng.map_stream((r, None) for r in _requests(8, 4)))  # 32 images -> 2 launches of 16
    assert len(out) == 8
    assert launches == [16, 16], launches


def test_map_stream_ragged_tail_pads_to_device_batch(det):
    eng = ServingEngine(det, HW, device_batch=16, score_thresh=-1.0)
    launches = _spy(eng)
    out = list(eng.map_stream((r, None) for r in _requests(3, 6)))  # 18 images -> 12 + 6
    assert len(out) == 3
    assert launches == [16, 16], launches
    # the tail's results are real detections, not the zero-pad rows'
    assert all(len(d.scores) > 0 for d in out[-1])


def test_submit_async_roundtrip_and_order(det):
    reqs = _requests(5, 3, seed=2)
    with ServingEngine(det, HW, device_batch=8, score_thresh=-1.0) as eng:
        futures = [eng.submit(r) for r in reqs]
        results = [f.result(timeout=T_OUT) for f in futures]
    for req_imgs, dets in zip(reqs, results):
        for a, b in zip(dets, det.detect_batch(req_imgs, score_thresh=-1.0)):
            _close(a, b)


def test_submit_single_image_and_shape_check(det):
    with ServingEngine(det, HW, device_batch=4, score_thresh=-1.0) as eng:
        dets = eng.submit(np.zeros((*HW, 3), np.uint8)).result(timeout=T_OUT)  # 3-D: one image
        assert len(dets) == 1
        with pytest.raises(ValueError):
            eng.submit(np.zeros((2, 32, 32, 3), np.uint8))
    with pytest.raises(RuntimeError):
        eng.submit(np.zeros((1, *HW, 3), np.uint8))


def test_oversize_request_runs_in_one_launch(det):
    eng = ServingEngine(det, HW, device_batch=4, score_thresh=-1.0)
    launches = _spy(eng)
    out = list(eng.map_stream([(_requests(1, 6)[0], None)]))  # bigger than device_batch
    assert len(out) == 1 and len(out[0]) == 6
    assert launches == [6]


def test_detector_quantize_serving_mode(det):
    """The W8A8 forward: detect still runs and tracks the float path."""
    rng = np.random.RandomState(3)
    calib = rng.randint(0, 255, (4, *HW, 3), np.uint8)
    img = rng.randint(0, 255, (*HW, 3), np.uint8)
    ref = det.detect(img, score_thresh=-1.0)
    scales = det.quantize(calib_images=calib)
    try:
        assert scales and all(np.all(np.asarray(v) > 0) for k, v in scales.items() if not k.startswith("cfg:"))
        assert det._quant is not None
        q = det.detect(img, score_thresh=-1.0)
        assert q.boxes.shape == ref.boxes.shape
        assert np.isfinite(q.scores).all()
        np.testing.assert_allclose(np.sort(q.scores), np.sort(ref.scores), atol=0.05)
    finally:
        det.dequantize()
    back = det.detect(img, score_thresh=-1.0)
    np.testing.assert_allclose(back.scores, ref.scores, atol=1e-6)


def test_router_mixed_sizes_match_direct(det):
    rng = np.random.RandomState(11)
    sizes = [(64, 64), (40, 60), (64, 64), (100, 30), (60, 40)]
    imgs = [rng.randint(0, 255, s + (3,), np.uint8) for s in sizes]
    with ServingRouter(det, device_batch=4, score_thresh=-1.0) as router:
        futs = [router.submit(im) for im in imgs]
        got = [f.result(timeout=T_OUT) for f in futs]
        assert len(router._engines) >= 1
    for im, d in zip(imgs, got):
        _close(d, det.detect(im, score_thresh=-1.0))


def test_router_rejects_bad_shape(det):
    with ServingRouter(det) as router:
        with pytest.raises(ValueError):
            router.submit(np.zeros((64, 64), np.uint8))


def test_detector_quantize_int8_dw_variant(det):
    """int8_dw=True (the depthwise convs in int8 too): runs, loosely tracks
    the float path."""
    rng = np.random.RandomState(4)
    calib = rng.randint(0, 255, (4, *HW, 3), np.uint8)
    img = rng.randint(0, 255, (*HW, 3), np.uint8)
    ref = det.detect(img, score_thresh=-1.0)
    det.quantize(calib_images=calib, int8_dw=True)
    try:
        assert det._quant.int8_dw
        q = det.detect(img, score_thresh=-1.0)
        assert np.isfinite(q.scores).all()
        np.testing.assert_allclose(np.sort(q.scores), np.sort(ref.scores), atol=0.1)
    finally:
        det.dequantize()


def test_async_coalesce_never_exceeds_device_batch(det):
    """Overshooting requests are carried to the next group, so every launch
    is of the device_batch program."""
    eng = ServingEngine(det, HW, device_batch=8, score_thresh=-1.0)
    launches = _spy(eng)
    with eng:
        futs = [eng.submit(r) for r in _requests(5, 3, seed=9)]  # 3+3 carry 3+3 carry 3
        for f in futs:
            f.result(timeout=T_OUT)
    assert set(launches) == {8}, launches


def test_submit_after_close_raises_router(det):
    router = ServingRouter(det, device_batch=4, score_thresh=-1.0)
    router.close()
    with pytest.raises(RuntimeError):
        router.submit(np.zeros((*HW, 3), np.uint8))
    router.close()  # idempotent


def test_submit_rejects_non_uint8(det):
    with ServingEngine(det, HW, device_batch=4) as eng:
        with pytest.raises(ValueError):
            eng.submit(np.zeros((1, *HW, 3), np.float32))


def test_engine_stats_populated(det):
    eng = ServingEngine(det, HW, device_batch=8, score_thresh=-1.0)
    with eng:
        for f in [eng.submit(r) for r in _requests(4, 4, seed=12)]:
            f.result(timeout=T_OUT)
    s = eng.stats()
    assert s["requests"] == 4 and s["images"] == 16
    assert s["launches"] >= 2  # 16 images / device_batch 8
    assert s["latency_ms_p50"] is not None and s["latency_ms_p50"] > 0
    assert s["latency_ms_max"] >= s["latency_ms_p50"]
    assert s["pinned_launches"] == 0  # the CPU has no transfer to stage


def test_concurrent_submitters(det):
    """Several client threads submitting at once: every future resolves
    with its own request's result (no cross-request mix-ups)."""
    payloads, results = {}, {}
    with ServingEngine(det, HW, device_batch=8, score_thresh=-1.0) as eng:

        def client(tid):
            imgs = np.random.RandomState(100 + tid).randint(0, 255, (2, *HW, 3), np.uint8)
            payloads[tid] = imgs
            results[tid] = eng.submit(imgs).result(timeout=T_OUT)

        threads = [threading.Thread(target=client, args=(t,)) for t in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=T_OUT)
        assert not any(t.is_alive() for t in threads)
    assert sorted(results) == list(range(6))
    for tid, dets in results.items():
        for a, b in zip(dets, det.detect_batch(payloads[tid], score_thresh=-1.0)):
            _close(a, b)


def test_submit_validates_in_caller_thread(det):
    """Malformed requests raise in the caller (a failure in the worker
    would strand futures)."""
    with ServingEngine(det, HW, device_batch=4) as eng:
        with pytest.raises(ValueError):  # wrong channel count
            eng.submit(np.zeros((1, *HW, 4), np.uint8))
        with pytest.raises(ValueError):  # hws row count mismatch
            eng.submit(np.zeros((2, *HW, 3), np.uint8), hws=np.zeros((3, 2), np.int32))
        with pytest.raises(ValueError):  # hws wrong width
            eng.submit(np.zeros((1, *HW, 3), np.uint8), hws=np.zeros((1, 3)))


def test_reload_weights_under_serving(det):
    """Hot weight reload: later launches run the new weights, programs
    rebuild, and the engine keeps serving."""
    img = np.random.RandomState(30).randint(0, 255, (1, *HW, 3), np.uint8)
    with ServingEngine(det, HW, device_batch=2, score_thresh=-1.0) as eng:
        before = eng.submit(img).result(timeout=T_OUT)[0]
        # raw (unfolded) variables from another seed exercise the fold path
        _, raw = init_model(det._init_config.model, seed=99)
        det.reload_weights(variables=raw)
        assert det.config.model.folded and det._quant is None
        after = eng.submit(img).result(timeout=T_OUT)[0]
    assert not np.allclose(before.scores, after.scores)
    assert np.isfinite(after.scores).all() and after.boxes.shape[1] == 4
    with pytest.raises(ValueError):
        det.reload_weights()


def test_serving_landmark_model():
    """The engine carries the optional landmarks through coalescing."""
    lm_det = T.Detector(config=_cfg(with_landmarks=True), device="cpu", seed=3)
    imgs = np.random.RandomState(31).randint(0, 255, (3, *HW, 3), np.uint8)
    with ServingEngine(lm_det, HW, device_batch=4, score_thresh=-1.0) as eng:
        dets = eng.submit(imgs).result(timeout=T_OUT)
    for a, b in zip(dets, lm_det.detect_batch(imgs, score_thresh=-1.0)):
        assert a.landmarks is not None and a.landmarks.shape[1:] == (5, 2)
        np.testing.assert_allclose(a.landmarks, b.landmarks, atol=1e-3)
        np.testing.assert_allclose(a.scores, b.scores, atol=1e-5)


def test_batch_ladder_small_launch(det):
    """A lone small request on an idle engine rides the small ladder rung,
    not the full device_batch program."""
    eng = ServingEngine(det, HW, device_batch=16, score_thresh=-1.0)
    assert eng.batch_ladder == (4, 16)
    launches = _spy(eng)
    with eng:
        dets = eng.submit(np.zeros((*HW, 3), np.uint8)).result(timeout=T_OUT)
    assert len(dets) == 1
    assert launches == [4], launches  # the smallest rung >= 1


def test_batch_ladder_explicit_and_validation(det):
    eng = ServingEngine(det, HW, device_batch=16, batch_ladder=(16,), score_thresh=-1.0)
    launches = _spy(eng)
    with eng:
        eng.submit(np.zeros((*HW, 3), np.uint8)).result(timeout=T_OUT)
    assert launches == [16]  # a one-rung ladder: one launch size
    with pytest.raises(ValueError):
        ServingEngine(det, HW, device_batch=16, batch_ladder=(4, 8))
    with pytest.raises(ValueError):
        ServingEngine(det, HW, device_batch=16, batch_ladder=(0, 16))
    with pytest.raises(ValueError):
        ServingEngine(det, HW, device_batch=0)


def test_stats_concurrent_hammering(det):
    """stats() polled from a monitoring thread while requests complete never
    raises."""
    stop = threading.Event()
    errors = []

    def monitor(eng):
        while not stop.is_set():
            try:
                eng.stats()
            except Exception as e:  # pragma: no cover
                errors.append(e)
                return

    # a short switch interval: the polling thread hands the interpreter back
    # to the worker (whose eager torch ops each take it) within 0.1 ms, and
    # the two interleave more often than at the default 5 ms
    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        with ServingEngine(det, HW, device_batch=4, score_thresh=-1.0) as eng:
            mon = threading.Thread(target=monitor, args=(eng,))
            mon.start()
            try:
                futs = [eng.submit(np.zeros((1, *HW, 3), np.uint8)) for _ in range(64)]
                for f in futs:
                    f.result(timeout=T_OUT)
            finally:
                stop.set()
                mon.join(timeout=T_OUT)
            assert not mon.is_alive()
    finally:
        sys.setswitchinterval(old_interval)
    assert not errors
    s = eng.stats()
    assert s["requests"] == 64
    assert s["pad_images"] >= 0 and s["mean_fill"] is not None


def test_map_stream_exclusive_with_submit(det):
    with ServingEngine(det, HW, device_batch=4, score_thresh=-1.0) as eng:
        eng.submit(np.zeros((1, *HW, 3), np.uint8)).result(timeout=T_OUT)
        with pytest.raises(RuntimeError):
            list(eng.map_stream([(np.zeros((1, *HW, 3), np.uint8), None)]))


def test_router_stats_aggregation(det):
    rng = np.random.RandomState(60)
    with ServingRouter(det, device_batch=4, score_thresh=-1.0) as router:
        futs = [router.submit(rng.randint(0, 255, (64, 64, 3), np.uint8)) for _ in range(5)]
        for f in futs:
            f.result(timeout=T_OUT)
        s = router.stats()
    assert s["requests"] == 5 and s["images"] == 5
    assert s["launches"] >= 1 and "buckets" in s and s["pinned_launches"] == 0
    for bs in s["buckets"].values():
        assert bs["latency_ms_p50"] is not None


def test_serving_soak_reload_quantize_stats():
    """Concurrent submitters while weights hot-reload, int8 flips on and
    off, and a monitor hammers stats(): every future resolves with valid
    results; no deadlock, no stranded future, no exception."""
    sdet = T.Detector(config=_cfg(), device="cpu", seed=1)
    calib = np.random.RandomState(70).randint(0, 255, (2, *HW, 3), np.uint8)
    stop = threading.Event()
    errors: list = []
    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        with ServingEngine(sdet, HW, device_batch=8, score_thresh=-1.0) as eng:

            def monitor():
                while not stop.is_set():
                    try:
                        assert eng.stats()["requests"] >= 0
                    except Exception as e:  # pragma: no cover
                        errors.append(("monitor", e))
                        return

            def churn():
                try:
                    for i in range(3):
                        _, raw = init_model(sdet._init_config.model, seed=80 + i)
                        sdet.reload_weights(variables=raw)
                        sdet.quantize(calib_images=calib)
                        sdet.dequantize()
                except Exception as e:  # pragma: no cover
                    errors.append(("churn", e))

            def client(tid):
                rng = np.random.RandomState(90 + tid)
                try:
                    for _ in range(6):
                        dets = eng.submit(rng.randint(0, 255, (2, *HW, 3), np.uint8)).result(timeout=T_OUT)
                        assert len(dets) == 2
                        for d in dets:
                            assert d.boxes.shape[1] == 4 and np.isfinite(d.scores).all()
                except Exception as e:  # pragma: no cover
                    errors.append((f"client{tid}", e))

            threads = [threading.Thread(target=churn)] + [threading.Thread(target=client, args=(t,)) for t in range(3)]
            mon = threading.Thread(target=monitor)
            for t in threads:
                t.start()
            mon.start()
            for t in threads:
                t.join(timeout=2 * T_OUT)
            stop.set()
            mon.join(timeout=T_OUT)
            assert not any(t.is_alive() for t in threads + [mon])
    finally:
        sys.setswitchinterval(old_interval)
    assert not errors, errors
    assert eng.stats()["requests"] == 18  # 3 clients x 6 requests


def test_int8_input_engine_matches_uint8(det):
    """int8_input (host table staging + the int8-input program) returns
    detections bit-identical to the uint8 engine's on the identity path,
    the ragged tail's pad rows included (LUT(0) is the uint8 zero fill)."""
    rng = np.random.RandomState(41)
    det.quantize(calib_images=rng.randint(0, 255, (4, *HW, 3), np.uint8), int8_dw=True)
    try:
        reqs = _requests(5, 3, seed=42)  # 15 images: a ragged 16-batch
        ref = list(ServingEngine(det, HW, device_batch=16, score_thresh=-1.0).map_stream((r, None) for r in reqs))
        eng = ServingEngine(det, HW, device_batch=16, score_thresh=-1.0, int8_input=True)
        programs = []
        orig = eng._fn
        eng._fn = lambda b, **kw: (programs.append(kw["int8_in"]), orig(b, **kw))[1]
        got = list(eng.map_stream((r, None) for r in reqs))
        assert programs == [True]  # the int8-input program ran
        assert len(got) == len(ref)
        for rs, gs in zip(ref, got):
            for rd, gd in zip(rs, gs):
                _same(rd, gd)
    finally:
        det.dequantize()


def test_int8_input_letterbox_falls_back_to_uint8(det):
    """Letterbox launches (a float resize cannot take quantized pixels) fall
    back to the uint8 program and still match the plain engine."""
    rng = np.random.RandomState(43)
    det.quantize(calib_images=rng.randint(0, 255, (4, *HW, 3), np.uint8))
    try:
        imgs = np.zeros((2, *HW, 3), np.uint8)
        imgs[:, :48, :40] = rng.randint(0, 255, (2, 48, 40, 3), np.uint8)
        hws = np.array([[48, 40], [48, 40]], np.int32)
        ref = list(ServingEngine(det, HW, device_batch=4, score_thresh=-1.0).map_stream([(imgs, hws)]))
        got = list(
            ServingEngine(det, HW, device_batch=4, score_thresh=-1.0, int8_input=True).map_stream([(imgs, hws)])
        )
        for rd, gd in zip(ref[0], got[0]):
            _same(rd, gd)
    finally:
        det.dequantize()


def test_int8_input_requires_quantized_detector(det):
    """An int8_input engine on an unquantized detector fails the launch
    loudly (the future carries the ValueError) instead of hanging."""
    eng = ServingEngine(det, HW, device_batch=4, int8_input=True)
    fut = eng.submit(np.random.RandomState(44).randint(0, 255, (1, *HW, 3), np.uint8))
    with pytest.raises(ValueError, match="quantize"):
        fut.result(timeout=T_OUT)
    eng.close()


def test_int8_input_requires_stem_bake_at_construction():
    """A model without the stem-baked preprocess can never take the int8
    staging path: the engine refuses at construction."""
    cfg = T.DetectorConfig(model=T.ModelConfig(compute_dtype="float32"),
                           preprocess=T.PreprocessConfig(stem_bake=False), default_size=64)
    d = T.Detector(config=cfg, device="cpu", seed=0)
    with pytest.raises(ValueError, match="stem"):
        ServingEngine(d, HW, device_batch=8, int8_input=True)


def test_cancelled_future_does_not_block_group(det):
    """A client cancel() racing the worker's set_result does not abort
    resolving the rest of the coalesced group."""
    with ServingEngine(det, HW, device_batch=8, score_thresh=-1.0) as eng:
        f1 = eng.submit(np.zeros((4, *HW, 3), np.uint8))
        f2 = eng.submit(np.zeros((4, *HW, 3), np.uint8))
        f1.cancel()  # may or may not win the race: both must be harmless
        assert len(f2.result(timeout=T_OUT)) == 4
        # the worker survived: the engine still serves
        assert len(eng.submit(np.zeros((1, *HW, 3), np.uint8)).result(timeout=T_OUT)) == 1


def test_submit_rejected_during_map_stream(det):
    """The exclusivity is bidirectional: submit() while a map_stream sweep
    is mid-flight raises."""
    eng = ServingEngine(det, HW, device_batch=8, score_thresh=-1.0)

    def gen():
        yield (np.zeros((4, *HW, 3), np.uint8), None)
        with pytest.raises(RuntimeError, match="map_stream"):
            eng.submit(np.zeros((1, *HW, 3), np.uint8))
        yield (np.zeros((4, *HW, 3), np.uint8), None)

    assert len(list(eng.map_stream(gen()))) == 2
    # the sweep released the engine: submit works again
    assert len(eng.submit(np.zeros((1, *HW, 3), np.uint8)).result(timeout=T_OUT)) == 1
    eng.close()


def test_int8_input_requires_identity_fast_path():
    """int8_input with identity_fast_path=False could never take the int8
    staging branch: construction refuses."""
    cfg = T.DetectorConfig(model=T.ModelConfig(compute_dtype="float32"),
                           preprocess=T.PreprocessConfig(identity_fast_path=False), default_size=64)
    d = T.Detector(config=cfg, device="cpu", seed=0)
    with pytest.raises(ValueError, match="identity_fast_path"):
        ServingEngine(d, HW, device_batch=8, int8_input=True)


def test_launch_fault_isolates_group_and_worker_survives(det):
    """An error raised by the program at launch fails only that coalesced
    group's futures; the worker survives, later submits serve, and the
    launch counters count only what ran."""
    with ServingEngine(det, HW, device_batch=8, score_thresh=-1.0) as eng:
        orig = eng._fn
        boom = RuntimeError("injected device failure")

        def faulty_fn(batch, **kw):
            fn, fmt = orig(batch, **kw)

            def exploding(*a, **k):
                raise boom

            return exploding, fmt

        eng._fn = faulty_fn
        bad = [eng.submit(np.zeros((4, *HW, 3), np.uint8)) for _ in range(2)]  # one failing launch
        for f in bad:
            with pytest.raises(RuntimeError, match="injected device failure"):
                f.result(timeout=T_OUT)
        eng._fn = orig
        dets = eng.submit(np.zeros((4, *HW, 3), np.uint8)).result(timeout=T_OUT)
        assert len(dets) == 4 and all(d.boxes.shape[1] == 4 for d in dets)
        s = eng.stats()
        assert s["launches"] == 1
        assert s["requests"] == 1 and s["images"] == 4


def test_fetch_fault_isolates_group_and_worker_survives(det, monkeypatch):
    """The same for a failure on the result side (the fetch to the host or
    the split into detections): the group gets the exception, the worker
    lives."""
    with ServingEngine(det, HW, device_batch=8, score_thresh=-1.0) as eng:
        orig = det.results_to_detections
        calls = {"n": 0}

        def flaky(res, thresh, lo=0, hi=None):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected fetch failure")
            return orig(res, thresh, lo=lo, hi=hi)

        monkeypatch.setattr(det, "results_to_detections", flaky)
        bad = eng.submit(np.zeros((2, *HW, 3), np.uint8))
        with pytest.raises(RuntimeError, match="injected fetch failure"):
            bad.result(timeout=T_OUT)
        assert len(eng.submit(np.zeros((2, *HW, 3), np.uint8)).result(timeout=T_OUT)) == 2
        s = eng.stats()
        # the failed group's launch ran (its fetch failed): launches == 2,
        # but its request never completed
        assert s["launches"] == 2
        assert s["requests"] == 1 and s["images"] == 2


def test_stats_p99_field(det):
    with ServingEngine(det, HW, device_batch=4, score_thresh=-1.0) as eng:
        for f in [eng.submit(np.zeros((1, *HW, 3), np.uint8)) for _ in range(8)]:
            f.result(timeout=T_OUT)
        s = eng.stats()
    for k in ("latency_ms_p50", "latency_ms_p95", "latency_ms_p99"):
        assert s[k] is not None and s[k] > 0
    assert s["latency_ms_p50"] <= s["latency_ms_p95"] <= s["latency_ms_p99"]


def test_staging_plain_matches_formatted(det):
    """staging="plain" gives the detections of the default "formatted"
    staging, and unknown modes are refused. On the CPU neither stages
    through pinned buffers (`_batch_fn_auto` gives no format)."""
    reqs = _requests(3, 4, seed=7)
    out = {}
    for mode in ("plain", "formatted"):
        with ServingEngine(det, HW, device_batch=8, score_thresh=-1.0, staging=mode) as eng:
            out[mode] = [f.result(timeout=T_OUT) for f in [eng.submit(r) for r in reqs]]
            assert eng.stats()["pinned_launches"] == 0
    for a_req, b_req in zip(out["plain"], out["formatted"]):
        for a, b in zip(a_req, b_req):
            _same(a, b)
    with pytest.raises(ValueError, match="staging"):
        ServingEngine(det, HW, staging="warp")


# --------------------------------------------------------------------------- #
# what the port adds or leaves out
# --------------------------------------------------------------------------- #


def test_mesh_is_not_ported(det):
    """`mesh=` is ported (tests/test_torch_sharding.py); what is not a
    `runtime.sharding.Mesh` is refused at construction."""
    with pytest.raises(TypeError, match="Mesh"):
        ServingEngine(det, HW, device_batch=8, mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        ServingRouter(det, device_batch=8, mesh=object())


def test_batch_fn_auto_formats(det):
    """On the CPU there is no transfer to stage: `_batch_fn_auto` gives the
    cached `_batch_fn` program and no format, as it does for the int8-input
    program on any device; a pinned ring is for a CUDA device only."""
    fn, fmt = det._batch_fn_auto(4, HW, 64, identity=True, max_dets=50)
    assert fmt is None and fn is det._batch_fn(4, HW, 64, identity=True, max_dets=50)
    with pytest.raises(ValueError, match="CUDA"):
        T.detector.PinnedStaging(4, HW, "cpu")
    x = np.zeros((4, *HW, 3), np.uint8)
    im, hw = T.detector.stage_inputs(None, x, np.full((4, 2), 64), "cpu")
    assert im.dtype == torch.uint8 and tuple(im.shape) == x.shape and hw.dtype == torch.int32


def test_int8_input_program_feeds_the_table(det):
    """`_batch_fn(int8_in=True)` on the host-quantized batch equals the
    uint8 identity program on the raw batch, bit for bit, and the native
    staging equals the numpy table apply byte for byte."""
    from tpucenterface_torch import native
    from tpucenterface_torch.quant.engine import apply_stem_lut_plain

    rng = np.random.RandomState(45)
    det.quantize(calib_images=rng.randint(0, 255, (4, *HW, 3), np.uint8), int8_dw=True)
    try:
        imgs = rng.randint(0, 255, (3, *HW, 3), np.uint8)
        hws = torch.full((3, 2), 64, dtype=torch.int32)
        lut = det.stem_input_lut()
        staged = native.stem_lut_apply(imgs, lut)
        assert staged.tobytes() == apply_stem_lut_plain(imgs, lut).tobytes()
        want = det._batch_fn(3, HW, 64, identity=True)(torch.from_numpy(imgs), hws)
        got = det._batch_fn(3, HW, 64, identity=True, int8_in=True)(torch.from_numpy(staged), hws)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    finally:
        det.dequantize()


def test_import_leaves_jax_out():
    code = (
        "import sys; import tpucenterface_torch.runtime, tpucenterface_torch.runtime.serving, "
        "tpucenterface_torch.runtime.video, tpucenterface_torch.runtime.prefetch, "
        "tpucenterface_torch.runtime.profiling, tpucenterface_torch.native; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'tpucenterface')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


# --------------------------------------------------------------------------- #
# atomic swaps: programs against reload_weights / quantize / dequantize
# --------------------------------------------------------------------------- #


def _swap_cycle(sdet, raws, scales):
    """Six swaps that bring `sdet` back to where it started (float A):
    quantize A, dequantize, reload B, quantize B, dequantize, reload A."""
    return [
        lambda: sdet.quantize(scales=scales[0]),
        sdet.dequantize,
        lambda: sdet.reload_weights(variables=raws[1]),
        lambda: sdet.quantize(scales=scales[1]),
        sdet.dequantize,
        lambda: sdet.reload_weights(variables=raws[0]),
    ]


def _outputs(res):
    return tuple(t.numpy().tobytes() for t in res)


def test_programs_run_on_one_generation_across_swaps():
    """A thread runs `_batch_fn` programs while another swaps the weights
    and the forward (`reload_weights`, `quantize`, `dequantize`). Each swap
    happens under `_fn_lock` (tpucenterface/detector.py:362-365, 444-451,
    463-468), and a program is built from one snapshot: it runs wholly on
    the generation it was built for.
    - Handshake: the runner takes a program, the swapper swaps (and is
      joined), then the runner calls the program: the result is the
      generation's at the time the program was taken, bit for bit.
    - Free-running, with a short switch interval: every result is one of the
      generations' outputs, bit for bit, never a mix."""
    sdet = T.Detector(config=_cfg(), device="cpu", seed=5)
    raws = [init_model(sdet._init_config.model, seed=s)[1] for s in (5, 6)]
    calib = np.random.RandomState(46).randint(0, 255, (2, *HW, 3), np.uint8)
    scales = [sdet.quantize(calib_images=calib)]
    sdet.dequantize()
    sdet.reload_weights(variables=raws[1])
    scales.append(sdet.quantize(calib_images=calib))
    sdet.dequantize()
    sdet.reload_weights(variables=raws[0])
    cycle = _swap_cycle(sdet, raws, scales)
    x = torch.from_numpy(np.random.RandomState(47).randint(0, 255, (2, *HW, 3), np.uint8))
    hws = torch.full((2, 2), 64, dtype=torch.int32)

    def program():
        return sdet._batch_fn(2, HW, 64, identity=True)

    # each state's output, the swaps run one after another
    v0 = sdet.weights_version
    want = []
    for swap in cycle:
        want.append(_outputs(program()(x, hws)))
        swap()
    assert sdet.weights_version == v0 + len(cycle)
    assert _outputs(program()(x, hws)) == want[0]
    assert all(want[i] != want[(i + 1) % len(want)] for i in range(len(want)))

    # handshake: a program taken before a swap and called after it
    for i, swap in enumerate(cycle):
        state = (sdet.weights_version - v0) % len(cycle)
        fn = program()
        t = threading.Thread(target=swap)
        t.start()
        t.join(timeout=T_OUT)
        assert not t.is_alive()
        assert _outputs(fn(x, hws)) == want[state], f"the program taken in state {state} ran another generation"
        assert _outputs(program()(x, hws)) == want[(state + 1) % len(cycle)]

    # free-running
    stop = threading.Event()
    seen, errors = [], []

    def runner():
        try:
            while not stop.is_set():
                seen.append(_outputs(program()(x, hws)))
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def swapper():
        try:
            for _ in range(2):
                for swap in cycle:
                    swap()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        threads = [threading.Thread(target=runner), threading.Thread(target=swapper)]
        for t in threads:
            t.start()
        threads[1].join(timeout=4 * T_OUT)
        stop.set()
        threads[0].join(timeout=T_OUT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old_interval)
    assert not errors, errors
    assert seen and all(s in want for s in seen), "a result matched no generation"


def test_program_cache_keys_on_the_weights_version(det):
    """A program is built once a signature and generation (the cache), and
    a swap clears the cache: the next call builds the new generation's."""
    a = det._batch_fn(2, HW, 64, identity=True)
    assert det._batch_fn(2, HW, 64, identity=True) is a
    assert det._single_fn(HW, 64) is det._single_fn(HW, 64)
    assert det._batch_flip_fn(2, HW, 64) is det._batch_flip_fn(2, HW, 64)
    v = det.weights_version
    det.quantize(calib_images=np.zeros((1, *HW, 3), np.uint8))
    try:
        assert det.weights_version == v + 1
        assert not det._fn_cache
        assert det._batch_fn(2, HW, 64, identity=True) is not a
        assert set(det._fn_cache) == {("batch", 2, HW, 64, True, None, False, v + 1)}
    finally:
        det.dequantize()
    assert not det._fn_cache


# --------------------------------------------------------------------------- #
# the JAX engine and router against the port's, weights carried across
# --------------------------------------------------------------------------- #

CROSS_ATOL, CROSS_FIRM = 1e-4, 0.05


@pytest.fixture(scope="module")
def cross_pair():
    """(port Detector, JAX Detector) on the flagship weights, float32
    compute and resize, input 64, K = 50."""
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
    return port, ref


def _cross_match(a, b):
    """Every detection >= CROSS_FIRM of either side has a partner on the
    other within CROSS_ATOL px (box corners) and CROSS_ATOL in score."""
    for x, y in ((a, b), (b, a)):
        sel = x.scores >= CROSS_FIRM
        if not sel.any():
            continue
        assert len(y.scores), x.scores[sel]
        dist = np.abs(x.boxes[sel][:, None] - y.boxes[None]).max(-1)
        close = np.abs(x.scores[sel][:, None] - y.scores[None]) <= CROSS_ATOL
        assert ((dist <= CROSS_ATOL) & close).any(1).all(), (x.scores[sel], y.scores)


def _scenes(n, seed, hw=HW):
    rng = np.random.RandomState(seed)
    return np.stack([render_scene(rng, hw=hw)[0] for _ in range(n)])


@pytest.mark.parametrize("mode", ["map_stream", "submit"])
def test_engine_matches_jax_engine(cross_pair, mode):
    """Requests of 1-4 painted scenes at the 64 bucket (a ragged tail on the
    {2, 8} ladder), coalesced by each package's engine."""
    port, ref = cross_pair
    imgs = _scenes(11, seed=48)
    reqs = [imgs[:3], imgs[3:4], imgs[4:8], imgs[8:11]]
    out = {}
    for name, cls, d in (("port", ServingEngine, port), ("jax", JServingEngine, ref)):
        eng = cls(d, HW, device_batch=8, score_thresh=0.0)
        if mode == "map_stream":
            out[name] = list(eng.map_stream((r, None) for r in reqs))
        else:
            with eng:
                out[name] = [f.result(timeout=T_OUT) for f in [eng.submit(r) for r in reqs]]
    assert [len(r) for r in out["port"]] == [len(r) for r in out["jax"]] == [3, 1, 4, 3]
    for a_req, b_req in zip(out["port"], out["jax"]):
        for a, b in zip(a_req, b_req):
            _cross_match(a, b)
    assert sum((d.scores >= 0.3).sum() for r in out["port"] for d in r) > 0


def test_router_matches_jax_router(cross_pair):
    """Mixed sizes (three padded buckets, letterboxed and pre-sized) through
    each package's router."""
    port, ref = cross_pair
    rng = np.random.RandomState(49)
    imgs = [render_scene(rng, hw=s)[0] for s in ((64, 64), (50, 60), (100, 70), (64, 64), (60, 130))]
    out = {}
    for name, cls, d in (("port", ServingRouter, port), ("jax", JServingRouter, ref)):
        with cls(d, device_batch=4, score_thresh=0.0) as router:
            out[name] = [f.result(timeout=T_OUT) for f in [router.submit(im) for im in imgs]]
            assert sorted(router._engines) == [(128, 128), (128, 256)]
    for a, b in zip(out["port"], out["jax"]):
        _cross_match(a, b)
