"""The one general load generator's common part: it reads a traffic file's
parameters and makes the calls' inputs from the seed.

A traffic file (`traffic/<mix>.json`) is data: the entry point it drives
(`entry`), the loop that sends the calls (`loop`, `clients`), the frames'
sizes and face counts, the thresholds and counts of calls. The harness finds
the entry's driver in `entries/<entry>.py` (a class `Driver` built on
`Driver` below) and the loop in `loops/<loop>.py` (a function `window`), by
those names, so that a mix over a new entry point or a new kind of loop is
added with new files alone.

An entry's driver says what one call is (`_run`), the operations that the
call's inputs ask of the model (`flops`, from the shapes alone: padding
rows count none), and what the reference answers for frames of a call
(`answers`), against which `compare` holds what the program returned.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from perfbench import frames
from perfbench.check import compare_frame


class Call(NamedTuple):
    index: int        # into the inputs' pool, cycled
    start: float      # perf_counter seconds
    end: float
    images: int
    out: list         # what the program returned, one entry a frame


class Detections(NamedTuple):
    """One frame's answer as the program's `Detections` holds it."""

    boxes: np.ndarray
    scores: np.ndarray
    landmarks: Optional[np.ndarray]


def pick_bucket(buckets, target: float) -> int:
    """The smallest of the configuration's model-input sizes that holds
    `target`, the largest beyond them."""
    for b in sorted(buckets):
        if b >= target:
            return b
    return max(buckets)


class Driver:
    """The inputs of `distinct_calls` calls of `images_per_call` painted
    frames each, made from the seed (`frames.py`) and cycled; an entry's
    driver sends one of them to the program per `call`."""

    def __init__(self, det, cfg: dict, traffic: dict, seed: int, device):
        self.det, self.cfg, self.traffic = det, cfg, traffic
        gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
        n = traffic["images_per_call"] * traffic["distinct_calls"]
        hw = frames.sizes(n, tuple(traffic["heights"]), tuple(traffic["widths"]), gen)
        counts = frames.face_counts(n, tuple(traffic["faces"]), gen)
        imgs = frames.paint(hw, counts, gen)
        k = traffic["images_per_call"]
        self.pool = [imgs[i:i + k] for i in range(0, n, k)]
        self.thresh = float(traffic["score_thresh"])

    def call(self, i: int) -> Call:
        t0 = time.perf_counter()
        out = self._run(self.pool[i % len(self.pool)])
        return Call(i % len(self.pool), t0, time.perf_counter(), self.traffic["images_per_call"], out)

    def warmup(self) -> None:
        """Every distinct input once (so every shape the traffic uses), and
        at least `warmup_calls` calls."""
        for i in range(max(self.traffic["warmup_calls"], len(self.pool))):
            self.call(i)

    def _run(self, inputs) -> list:
        raise NotImplementedError

    def flops(self, call: Call) -> int:
        raise NotImplementedError

    def answers(self, ref, index: int, picks: Sequence[int], device) -> List[Tuple[list, object]]:
        """For frames `picks` of pool entry `index`: the reference `ref`'s
        variants of each (`reference.detect.Variant`) and its own answer
        (`reference.detect.answer`), as the entry's settings ask."""
        raise NotImplementedError

    def compare(self, ref, call: Call, picks: Sequence[int], device) -> List[Dict[str, np.ndarray]]:
        """The numbers of `check.compare_frame` for frames `picks` of a
        call, what the program returned held to the reference `ref`."""
        out = []
        for j, (variants, mine) in zip(picks, self.answers(ref, call.index, picks, device)):
            d = call.out[j]
            out.append(compare_frame(d.boxes, d.scores, d.landmarks, variants, mine))
        return out
