"""Pipelined video-stream detection.

Mirrors `tpucenterface/runtime/video.py` (`VideoPipeline`, `draw_detections`,
`MultiStreamPipeline`). A synchronous camera loop pays capture, preprocess,
forward, decode and draw one after the other for each frame. Here the host
stages frame N+1 (pad, then a non-blocking copy from a pinned buffer on the
device's copy stream) while the device runs frame N, and fetches frame N-1's
small (K, 5) result: a two-deep software pipeline whose steady-state cost is
max(host, device) instead of their sum. 720p frames land in one (768, 1408)
padded bucket, so one program serves the whole stream.
"""

from __future__ import annotations

import collections
import time
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

from tpucenterface_torch.detector import stage_inputs
from tpucenterface_torch.preprocess import pad_to_bucket


class VideoPipeline:
    """Software-pipelined single-stream detector."""

    def __init__(self, detector, size: Optional[int] = None, depth: int = 2):
        self.detector = detector
        self.size = size or detector.config.default_size
        self.depth = depth
        self.last_fps: float = 0.0
        # bounded (an indefinite camera stream must not keep one float per
        # frame forever); reset at the start of each run()
        self.steady_latencies_ms: collections.deque = collections.deque(maxlen=1024)

    def run(
        self, frames: Iterable[np.ndarray], score_thresh: Optional[float] = None
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (frame, boxes, scores) per input frame, pipelined."""
        det = self.detector
        thresh = det.config.decode.score_thresh if score_thresh is None else score_thresh
        inflight: collections.deque = collections.deque()
        self.steady_latencies_ms.clear()
        fn = fmt = fn_hw = None
        n = 0
        t0 = time.perf_counter()
        for frame in frames:
            h, w = frame.shape[:2]
            padded = pad_to_bucket(frame)
            if fn is None or fn_hw != padded.shape[:2]:
                # a mid-stream resolution change (rotation, camera switch)
                # re-dispatches to the program and staging ring of the new
                # padded bucket
                fn_hw = padded.shape[:2]
                fn = det._single_fn(fn_hw, self.size)
                fmt = det._staging_for(1, fn_hw, slots=self.depth + 1)
            t_submit = time.perf_counter()
            dev_img, dev_hw = stage_inputs(fmt, padded[None], np.array([[h, w]], np.int32), det.device)
            out = fn(dev_img[0], dev_hw[0])
            inflight.append((frame, out[0], out[1], t_submit))
            if len(inflight) >= self.depth:
                yield self._drain_one(inflight, thresh)
                n += 1
        while inflight:
            yield self._drain_one(inflight, thresh)
            n += 1
        dt = time.perf_counter() - t0
        self.last_fps = n / dt if dt > 0 else 0.0

    def _drain_one(self, inflight, thresh):
        frame, boxes, scores, t_submit = inflight.popleft()
        boxes = boxes.cpu().numpy()
        scores = scores.cpu().numpy()
        self.steady_latencies_ms.append((time.perf_counter() - t_submit) * 1e3)
        keep = scores >= thresh
        return frame, boxes[keep], scores[keep]


def draw_detections(
    frame: np.ndarray,
    boxes: np.ndarray,
    scores: np.ndarray,
    landmarks: Optional[np.ndarray] = None,
) -> np.ndarray:
    """OpenCV box/score overlay (the reference demo's drawing surface).

    landmarks: optional (N, 5, 2) facial points drawn as dots when the model
    carries the landmark head."""
    import cv2

    out = frame.copy()
    for i, ((x1, y1, x2, y2), s) in enumerate(zip(boxes.astype(int), scores)):
        cv2.rectangle(out, (x1, y1), (x2, y2), (0, 255, 0), 2)
        cv2.putText(out, f"{s:.2f}", (x1, max(0, y1 - 4)), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1)
        if landmarks is not None:
            for px, py in landmarks[i].astype(int):
                cv2.circle(out, (int(px), int(py)), 2, (0, 0, 255), -1)
    return out


class MultiStreamPipeline:
    """N concurrent video streams on one device via coalesced batched
    launches.

    Instead of each stream paying for a one-image program per frame
    (VideoPipeline), frames from N streams are submitted to a shared
    ServingEngine and coalesce into N-frame launches, so the device cost of a
    frame falls toward that of one image of a batch.

    `run(streams)` round-robins: pull one frame per live stream, submit all
    (they coalesce), yield (stream_idx, frame, Detections) in completion
    order with per-stream frame order preserved.
    """

    def __init__(
        self,
        detector,
        n_streams: int,
        size: Optional[int] = None,
        score_thresh: Optional[float] = None,
    ):
        from tpucenterface_torch.runtime.serving import ServingEngine

        self.detector = detector
        self.n_streams = n_streams
        self.size = size or detector.config.default_size
        self.thresh = score_thresh
        self._engine_cls = ServingEngine
        self._engine = None

    def _get_engine(self, padded_hw):
        if self._engine is None:
            self._engine = self._engine_cls(
                self.detector,
                padded_hw,
                device_batch=self.n_streams,
                size=self.size,
                score_thresh=self.thresh,
            )
        elif self._engine.padded_hw != tuple(padded_hw):
            raise ValueError(
                f"all streams must share one padded bucket; got {tuple(padded_hw)} after {self._engine.padded_hw}"
            )
        return self._engine

    def run(self, streams):
        """streams: sequence of frame iterables (HxWx3 uint8, same bucket).

        Yields (stream_idx, frame, Detections) as results complete; frames
        within one stream come back in order.
        """
        its = [iter(s) for s in streams]
        live = list(range(len(its)))
        pending = collections.deque()  # (stream_idx, frame, Future)
        # bound on buffered frames: past this, block on the oldest result so
        # that a fast frame source cannot stage a whole video in host memory
        max_pending = max(2 * len(its), 4)
        try:
            while live or pending:
                for si in list(live):
                    frame = next(its[si], None)
                    if frame is None:
                        live.remove(si)
                        continue
                    h, w = frame.shape[:2]
                    padded = pad_to_bucket(frame)
                    eng = self._get_engine(padded.shape[:2])
                    fut = eng.submit(padded[None], np.array([[h, w]], np.int32))
                    pending.append((si, frame, fut))
                while pending and (pending[0][2].done() or not live or len(pending) >= max_pending):
                    si, frame, fut = pending.popleft()
                    dets = fut.result()[0]  # blocking when over the bound
                    yield si, frame, dets
        finally:
            if self._engine is not None:
                self._engine.close()
                self._engine = None
