"""Entry `detect_batch`: `Detector.detect_batch` on batches of
`images_per_call` frames of one size, handed over as one (B, H, W, 3) uint8
array in ordinary (pageable) host memory, as a decoder's frames are; frames
pre-sized to a bucket take the identity letterbox."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import drivers
from perfbench.reference.detect import answer
from perfbench.work import forward_flops


class Driver(drivers.Driver):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.pool = [np.stack(p) for p in self.pool]
        h, w = self.pool[0].shape[1:3]
        self.size = drivers.pick_bucket(self.cfg["buckets"], max(h, w))

    def _run(self, batch):
        return self.det.detect_batch(batch, score_thresh=self.thresh, size=self.size)

    def flops(self, call: drivers.Call) -> int:
        return call.images * forward_flops(self.cfg, self.size)

    def answers(self, ref, index, picks, device):
        batch = self.pool[index]
        out = []
        for c0 in range(0, len(picks), 16):
            sel = picks[c0:c0 + 16]
            var = ref.variants([torch.from_numpy(batch[j]).to(device) for j in sel], self.size, False,
                               int(self.cfg["max_dets"]))
            out += [(vs, answer(vs, self.thresh, None, None)) for vs in var]
        return out
