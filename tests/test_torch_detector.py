"""The port's detect path end to end against the JAX Detector.

Flagship weights (artifacts/flagship.safetensors) at the flagship's own
320 input, on synthetic multi-face scenes made from a seed. The port takes
`use_pallas=True` (the fused decode; on the CPU its plain version); the JAX
Detector on the CPU runs its reference decode with `fast_topk=False`, whose
ties follow the same lowest-index rule.
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
    other side whose box corners are all within `box_atol` pixels and whose
    score is within `score_atol`."""
    for a, b in ((port, ref), (ref, port)):
        sel = a.scores >= firm
        if not sel.any():
            continue
        assert len(b.scores), f"no detections to match {a.scores[sel]}"
        dist = np.abs(a.boxes[sel][:, None, :] - b.boxes[None, :, :]).max(axis=-1)
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


def test_flagship_f32_matches_jax(flagship_vars, scenes):
    """float32 compute and resize on both sides: all K scores within 1e-5
    and all K boxes within 1e-3 px, in the same order (the two differ only
    in float32 summation order: measured 3.7e-6 and 3.1e-5)."""
    port_cfg, jax_cfg = _configs("float32")
    port = T.Detector.from_safetensors(ARTIFACT, port_cfg, device="cpu")
    ref = JDetector(variables=flagship_vars, config=jax_cfg)
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


def test_flagship_detect_single_and_identity(flagship_vars):
    """`detect` on an odd size (letterbox) and on a model-size image (the
    identity preprocess), float32, against the JAX Detector."""
    port_cfg, jax_cfg = _configs("float32")
    port = T.Detector.from_safetensors(ARTIFACT, port_cfg, device="cpu")
    ref = JDetector(variables=flagship_vars, config=jax_cfg)
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
