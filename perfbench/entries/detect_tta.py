"""Entry `detect_tta`: `eval.batch_runner.batched_detect_tta` on calls of
`images_per_call` frames of mixed sizes, with the traffic's scales, flip,
batch, `inflight`, thresholds and `max_dets`."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from perfbench import drivers
from perfbench.reference.detect import answer
from perfbench.work import forward_flops


class Driver(drivers.Driver):
    def _run(self, imgs):
        from tpucenterface_torch.eval.batch_runner import batched_detect_tta

        t = self.traffic
        return batched_detect_tta(self.det, imgs, scales=tuple(t["scales"]), flip=t["flip"],
                                  score_thresh=self.thresh, nms_thresh=t["nms_thresh"], max_dets=t["max_dets"],
                                  batch_size=t["batch_size"], inflight=t["inflight"])

    def sizes_of(self, img: np.ndarray) -> List[int]:
        """The model-input sizes a frame runs at: each scale times its
        longer side, to the smallest bucket that holds it (the largest
        beyond), each once."""
        return sorted({drivers.pick_bucket(self.cfg["buckets"], max(img.shape[:2]) * s)
                       for s in self.traffic["scales"]})

    def flops(self, call: drivers.Call) -> int:
        per = 2 if self.traffic["flip"] else 1
        return sum(per * forward_flops(self.cfg, s) for img in self.pool[call.index] for s in self.sizes_of(img))

    def answers(self, ref, index, picks, device):
        t = self.traffic
        imgs = self.pool[index]
        out = []
        for j in picks:
            f = torch.from_numpy(imgs[j]).to(device)
            variants = [v for s in self.sizes_of(imgs[j])
                        for v in ref.variants([f], s, t["flip"], int(self.cfg["max_dets"]))[0]]
            out.append((variants, answer(variants, self.thresh, t["nms_thresh"], t["max_dets"])))
        return out
