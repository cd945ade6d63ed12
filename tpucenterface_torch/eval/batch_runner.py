"""Bucketed batched inference over image sets of mixed shapes.

Mirrors `tpucenterface/eval/batch_runner.py` (`batched_detect`,
`batched_detect_tta`). Images are grouped by their padded input shape and
sent as fixed-size batches on a {batch_size // 4, batch_size} ladder (a
ragged tail pads to the smaller rung), so the programs run at few
signatures. Up to `inflight` launches are left unfetched while the next one
is enqueued; results are fetched in launch order and come back in the
caller's order. Each launch's inputs reach the device through
`detector.stage_inputs`; the TTA runner adds the spans `tcf.tta.pad`,
`tcf.tta.assemble` (once a chunk) and `tcf.tta.merge` to the detector's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpucenterface_torch.detector import Detections, stage_inputs
from tpucenterface_torch.eval.tta import merge_detections, pick_bucket
from tpucenterface_torch.preprocess import pad_to_bucket
from tpucenterface_torch.runtime.profiling import annotate


def _ladder(batch_size: int) -> List[int]:
    return sorted({max(1, batch_size // 4), batch_size})


def _groups(padded: Sequence[np.ndarray]) -> Dict[Tuple[int, int], List[int]]:
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, p in enumerate(padded):
        groups.setdefault(p.shape[:2], []).append(i)
    return groups


def batched_detect(
    detector,
    images: Sequence[np.ndarray],
    score_thresh: Optional[float] = None,
    size: Optional[int] = None,
    batch_size: int = 64,
    inflight: int = 2,
) -> List[Detections]:
    """Detect over a mixed-shape image list; one `Detections` per image."""
    thresh = detector.config.decode.score_thresh if score_thresh is None else score_thresh
    size = size or detector.config.default_size
    dev = detector.device
    padded = [pad_to_bucket(img) for img in images]
    results: List[Optional[Detections]] = [None] * len(images)
    ladder = _ladder(batch_size)
    launched: List = []  # (chunk, result) of launches not fetched yet

    def drain_one():
        chunk, out = launched.pop(0)
        for i, d in zip(chunk, detector.results_to_detections(out, thresh, hi=len(chunk))):
            results[i] = d

    for shape, idxs in _groups(padded).items():
        for c0 in range(0, len(idxs), batch_size):
            chunk = idxs[c0 : c0 + batch_size]
            bs = min(r for r in ladder if r >= len(chunk))
            real_hws = np.asarray([images[i].shape[:2] for i in chunk], np.int32)
            # a pre-sized chunk takes the identity program; its pad rows then
            # carry hw = size so that the whole batch fits that program
            identity = detector._identity_for(shape, size, real_hws)
            batch = np.zeros((bs,) + shape + (3,), np.uint8)
            hws = np.full((bs, 2), size if identity else 1, np.int32)
            for j, i in enumerate(chunk):
                batch[j] = padded[i]
            hws[: len(chunk)] = real_hws
            fn = detector._batch_fn(bs, shape, size, identity=identity)
            launched.append((chunk, fn(*stage_inputs(None, batch, hws, dev))))
            while len(launched) > inflight:
                drain_one()
    while launched:
        drain_one()
    return results


def batched_detect_tta(
    detector,
    images: Sequence[np.ndarray],
    scales: Sequence[float] = (1.0,),
    flip: bool = True,
    score_thresh: float = 0.01,
    nms_thresh: float = 0.4,
    max_dets: Optional[int] = 750,
    batch_size: int = 64,
    inflight: int = 2,
    launch_log: Optional[List[Tuple[int, Tuple[int, int], int, bool]]] = None,
) -> List[Detections]:
    """Flip and multi-scale TTA over a mixed-shape image list; one merged
    `Detections` per image, scores descending (landmark models keep each
    surviving detection's points).

    Each scale times an image's longer side picks its model-input bucket.
    Work is grouped by padded shape; each chunk is copied to the device once
    and run at every bucket its images need, the flip inside the same
    program (`Detector._batch_flip_fn`: one forward of 2B images). The host
    merges each image's variants with NMS. `launch_log`, if given, gets one
    (batch, padded_shape, size, flip) tuple per program launch."""
    buckets = detector.config.buckets
    dev = detector.device
    with annotate("tcf.tta.pad"):
        padded = [pad_to_bucket(img) for img in images]
        sizes_per_img = [
            tuple(pick_bucket(buckets, max(img.shape[:2]) * s) for s in scales) for img in images
        ]
    parts: List[List[np.ndarray]] = [[] for _ in images]
    lm_parts: List[List] = [[] for _ in images]
    launched: List = []  # (chunk, size, result) of launches not fetched yet

    def drain_one():
        chunk, size, out = launched.pop(0)
        with annotate("tcf.results"):
            boxes, scores = out[0].cpu().numpy(), out[1].cpu().numpy()
            lms = out[2].cpu().numpy() if len(out) == 3 else None
            for j, i in enumerate(chunk):
                if size not in sizes_per_img[i]:
                    continue
                keep = scores[j] >= score_thresh
                if keep.any():
                    parts[i].append(np.concatenate([boxes[j][keep], scores[j][keep, None]], axis=1))
                    lm_parts[i].append(lms[j][keep] if lms is not None else None)

    ladder = _ladder(batch_size)
    for shape, idxs in _groups(padded).items():
        for c0 in range(0, len(idxs), batch_size):
            chunk = idxs[c0 : c0 + batch_size]
            bs = min(r for r in ladder if r >= len(chunk))
            with annotate("tcf.tta.assemble"):
                batch = np.zeros((bs,) + shape + (3,), np.uint8)
                hws = np.ones((bs, 2), np.int32)
                for j, i in enumerate(chunk):
                    batch[j] = padded[i]
                    hws[j] = images[i].shape[:2]
            dev_batch, dev_hws = stage_inputs(None, batch, hws, dev)  # one copy a chunk
            for size in sorted({s for i in chunk for s in sizes_per_img[i]}):
                if flip:
                    fn = detector._batch_flip_fn(bs, shape, size)
                else:
                    fn = detector._batch_fn(bs, shape, size)
                if launch_log is not None:
                    launch_log.append((bs, shape, size, flip))
                launched.append((chunk, size, fn(dev_batch, dev_hws)))
                while len(launched) > inflight:
                    drain_one()
    while launched:
        drain_one()
    with annotate("tcf.tta.merge"):
        return [merge_detections(p, lp, nms_thresh, max_dets) for p, lp in zip(parts, lm_parts)]
