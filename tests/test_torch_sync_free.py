"""The port's programs launch without a host synchronisation, and the TTA
runner fetches a launch's outputs without waiting for later launches.

On the card, one warmed launch of a program, its inputs already on the
device, runs under `torch.cuda.set_sync_debug_mode("error")`, which raises on
any call that waits for the device: the flip program of a landmark model
(`Detector._batch_flip_fn`: letterbox and mirror, the fast engine's forward,
B1 and the decode, the mirror half's un-mirroring and pair swap) and, as a
guard, the batch program with and without landmarks (B1, B2). Each is the
counter that zero synchronising calls a launch holds: a launch that waits
for the stream blocks the host until the forward has run, and the TTA
runner's `inflight` then overlaps nothing. So does a fetch that queues
behind the launches issued after its own: both runners fetch through
`eval.batch_runner._fetch_behind`.

Marked `card`: skips without a CUDA device. The file imports no JAX, so it
runs on a machine without it, with the tests' conftest (which imports JAX)
left out:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_sync_free.py
"""

import numpy as np
import pytest
import torch

import tpucenterface_torch as T
from tpucenterface_torch.detector import stage_inputs
from tpucenterface_torch.eval import batch_runner
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

SIZE = 320
PADDED = (256, 384)
BATCH = 4


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a synchronising call waits for the card's stream")
    return torch.device("cuda", torch.cuda.current_device())


def _detector(device, landmarks: bool):
    """The benchmark's program route at a small size: folded bfloat16 weights
    from a seed, the stem-baked preprocess, the fast engine, the fused decode."""
    model = T.ModelConfig(with_landmarks=landmarks, inference_engine="fast")
    return T.Detector(config=T.DetectorConfig(model=model, decode=T.DecodeConfig(use_pallas=True), default_size=SIZE),
                      device=device, seed=11)


def _frames(padded, seed: int):
    """BATCH uint8 frames of a padded shape and content sizes within it."""
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (BATCH,) + tuple(padded) + (3,)).astype(np.uint8)
    hws = np.stack([rng.randint(padded[0] // 2, padded[0] + 1, BATCH),
                    rng.randint(padded[1] // 2, padded[1] + 1, BATCH)], axis=1).astype(np.int32)
    hws[0] = padded
    return imgs, hws


def _launch_without_sync(fn, imgs, hws):
    """Warm `fn` (kernel builds, plans, cuDNN's picks), then launch it once
    more under the sync debug mode "error"; its outputs on the host."""
    fn(imgs, hws)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(imgs, hws)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return [o.cpu() for o in out]


@pytest.mark.card
def test_flip_launch_makes_no_host_sync(card):
    det = _detector(card, landmarks=True)
    imgs, hws = stage_inputs(None, *_frames(PADDED, seed=3), card)
    boxes, scores, lm = _launch_without_sync(det._batch_flip_fn(BATCH, PADDED, SIZE), imgs, hws)
    k = det.config.decode.max_dets
    assert tuple(boxes.shape) == (BATCH, 2 * k, 4) and tuple(scores.shape) == (BATCH, 2 * k)
    assert tuple(lm.shape) == (BATCH, 2 * k, 5, 2)
    assert all(bool(torch.isfinite(t).all()) for t in (boxes, scores, lm))


@pytest.mark.card
@pytest.mark.parametrize("landmarks", [True, False])
@pytest.mark.parametrize("identity", [True, False])
def test_batch_launch_makes_no_host_sync(card, landmarks, identity):
    det = _detector(card, landmarks=landmarks)
    padded = (SIZE, SIZE) if identity else PADDED
    imgs, hws = _frames(padded, seed=4)
    if identity:
        hws[:] = SIZE
    assert det._identity_for(padded, SIZE, hws) == identity
    out = _launch_without_sync(det._batch_fn(BATCH, padded, SIZE, identity=identity),
                               *stage_inputs(None, imgs, hws, card))
    k = det.config.decode.max_dets
    assert len(out) == (3 if landmarks else 2) and tuple(out[1].shape) == (BATCH, k)
    assert all(bool(torch.isfinite(t).all()) for t in out)


@pytest.mark.card
def test_fetch_behind_waits_for_its_own_launch_only(card):
    """A launch's fetch completes while the work issued after it still runs,
    into pinned host memory, with the launch's values; on every card present,
    with the process's current device left at the first, the copy and its
    event go to the card that holds the outputs."""
    for index in range(torch.cuda.device_count()):
        dev = torch.device("cuda", index)
        out = torch.randn(BATCH, 400, 5, 2, device=dev) * 2
        host, done = batch_runner._fetch_behind((out,))
        assert done.device == dev
        x = torch.randn(4096, 4096, device=dev)
        for _ in range(100):
            x = x @ x
        later = torch.cuda.Event()
        later.record(torch.cuda.current_stream(dev))
        done.synchronize()
        assert not later.query(), "the fetch waited for the work issued after its launch"
        torch.cuda.synchronize(dev)
        assert host[0].is_pinned() and torch.equal(host[0], out.cpu())


@pytest.mark.card
@pytest.mark.parametrize("tta", [True, False])
def test_runner_matches_a_blocking_fetch(card, monkeypatch, tta):
    """`batched_detect_tta` and `batched_detect`, with each launch's outputs
    fetched behind it, return bit for bit what a blocking `.cpu()` at drain
    time returns."""
    det = _detector(card, landmarks=True)
    rng = np.random.RandomState(5)
    images = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
              for h, w in ((200, 300), (240, 320), (130, 300), (300, 200), (250, 250), (120, 90))]

    def run():
        if tta:
            return batch_runner.batched_detect_tta(det, images, scales=(0.5, 1.0), flip=True, score_thresh=0.0,
                                                   batch_size=4, inflight=2)
        return batch_runner.batched_detect(det, images, score_thresh=0.0, size=SIZE, batch_size=4, inflight=2)

    got = run()
    monkeypatch.setattr(batch_runner, "_fetch_behind", lambda out: (tuple(t.cpu() for t in out), None))
    want = run()
    for g, w in zip(got, want):
        assert len(g.scores) > 0
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
