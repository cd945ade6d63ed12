"""Training batch pipeline: augment + render targets + stack.

Mirrors `tpucenterface/data/loader.py` (`build_sample`, `batch_iterator`):
the same draws in the same order, so a seed gives the JAX package's batches
bit for bit, sequential (workers=0) or from the bounded thread-pool window
(workers>0, one RandomState(seed, epoch, idx) stream a sample). Batches flow
through `runtime.prefetch.prefetch_to_device`, which overlaps this host work
with the device's. `cv2` is imported inside `build_sample`, where it decodes.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from tpucenterface_torch.config import TrainConfig
from tpucenterface_torch.data.augment import augment_train
from tpucenterface_torch.data.targets import make_targets
from tpucenterface_torch.data.wider import WiderImage


def build_sample(
    rec: WiderImage,
    cfg: TrainConfig,
    rng: np.random.RandomState,
    wh_log: bool = False,
    img: Optional[np.ndarray] = None,
) -> Optional[Dict[str, np.ndarray]]:
    """Load + augment one record into a training sample (None if unreadable)."""
    if img is None:
        import cv2

        img = cv2.imread(rec.path)
        if img is None:
            return None
    boxes = rec.xyxy[~rec.invalid] if len(rec.boxes) else rec.xyxy
    if not cfg.with_landmarks:
        canvas, boxes = augment_train(img, boxes, cfg, rng)
        t = make_targets(
            boxes, cfg.input_size, stride=4, max_objs=cfg.max_objs,
            wh_log=wh_log,
        )
    else:
        # records without landmark GT still train boxes: NaN rows render
        # as lm_mask=0 in make_targets, so the lm head just gets no signal
        lms = rec.landmarks
        if lms is None:
            lms = np.full((len(rec.boxes), 10), np.nan, np.float32)
        if len(rec.boxes):
            lms = lms[~rec.invalid]
        canvas, boxes, lms = augment_train(
            img, boxes, cfg, rng, landmarks=lms
        )
        t = make_targets(
            boxes, cfg.input_size, stride=4, max_objs=cfg.max_objs,
            wh_log=wh_log, landmarks=lms,
        )
    t["image"] = canvas  # uint8; normalization is device-side in train.step
    return t


def batch_iterator(
    records: Sequence[WiderImage],
    cfg: TrainConfig,
    seed: int = 0,
    epochs: Optional[int] = None,
    drop_last: bool = True,
    wh_log: bool = False,
    workers: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled epoch iterator yielding stacked numpy batches.

    workers > 0 decodes/augments samples on a thread pool. cv2's decode and
    warp release the GIL, so threads parallelize the host work without the
    fork hazards of processes under a live CUDA context. Submission is bounded
    (a ~2-batch window) so decoded canvases never pile up ahead of the
    consumer, and results are collected in submission order with per-sample
    RandomState(seed, epoch, idx) streams — the stream is deterministic for
    a given (seed, workers>0) regardless of thread timing.
    """
    rng = np.random.RandomState(seed)
    pool = None
    if workers > 0:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=workers)

    def samples_sequential(order):
        for idx in order:
            yield build_sample(records[idx], cfg, rng, wh_log=wh_log)

    def samples_pooled(order, epoch):
        window = max(2 * cfg.batch_size, 2 * workers)

        def submit(idx):
            sseed = (seed * 1_000_003 + epoch * 19_997 + int(idx)) % (
                2**31 - 1
            )
            return pool.submit(
                build_sample,
                records[idx],
                cfg,
                np.random.RandomState(sseed),
                wh_log=wh_log,
            )

        pending: "collections.deque" = collections.deque()
        it = iter(order)
        for idx in it:
            pending.append(submit(idx))
            if len(pending) >= window:
                break
        while pending:
            s = pending.popleft().result()
            nxt = next(it, None)
            if nxt is not None:
                pending.append(submit(nxt))
            yield s

    try:
        epoch = 0
        while epochs is None or epoch < epochs:
            order = rng.permutation(len(records))
            samples = (
                samples_pooled(order, epoch)
                if pool is not None
                else samples_sequential(order)
            )
            buf: List[Dict[str, np.ndarray]] = []
            for s in samples:
                if s is None:
                    continue
                buf.append(s)
                if len(buf) == cfg.batch_size:
                    yield _stack(buf)
                    buf = []
            if buf and not drop_last:
                yield _stack(buf)
            epoch += 1
    finally:
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)


def _stack(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
