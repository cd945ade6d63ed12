"""`correct` comes out false when the timed path is wrong underneath.

Whole runs of each cell on the CPU at a small size (the harness's look for
a card skipped), with a fault planted where the answers are produced:
- stale: each call returns the previous call's answers (a step that leaves
  its state unchanged);
- half: the second half of a call's frames get the first half's answers
  (half of the batch left out);
- moved: every box moved by 8 pixels;
- scores: every score raised by 0.3 logits (a fault of the sigmoid);
- landmarks: every landmark moved by 2 pixels (landmark models);
- flip_pairs: the mirrored variant's landmark pairs left unswapped (the
  flip's `lm_flip_perm` the identity; the TTA cell, the one that mirrors).
Each is held both to the cell's own limits and, with the program computing
in float32, to limits a thousand times tighter that a sound float32 run
meets. The control, the reference computed in float8, fails every cell's
limits too.
"""

import dataclasses
import json

import numpy as np
import pytest

from perfbench import calibrate, registry, run
from perfbench.tests.pb_helpers import cpu, tiny_copy
from perfbench.tests.test_perfbench_reference import TIGHT, compute_float32
from tpucenterface_torch.detector import Detections

CELLS = ["centerface-mbv2.batch32-640", "mbv2x1.4-fpn48.batch32-640", "centerface-mbv2.wider-tta"]
LANDMARKS = {"centerface-mbv2.batch32-640", "centerface-mbv2.wider-tta"}


def stale(outs, prev):
    return prev if prev is not None else outs


def half(outs, prev):
    n = len(outs) // 2
    return outs[:n] + outs[:len(outs) - n]


def moved(outs, prev):
    return [Detections(d.boxes + 8.0, d.scores, d.landmarks) for d in outs]


def scores(outs, prev):
    def up(p):
        z = np.log(p) - np.log1p(-p) + 0.3
        return (1.0 / (1.0 + np.exp(-z))).astype(p.dtype)

    return [Detections(d.boxes, up(d.scores), d.landmarks) for d in outs]


def landmarks(outs, prev):
    return [Detections(d.boxes, d.scores, d.landmarks + 2.0) for d in outs]


OUTPUT_FAULTS = {"stale": stale, "half": half, "moved": moved, "scores": scores, "landmarks": landmarks}
CASES = ([(c, f) for c in CELLS for f in sorted(OUTPUT_FAULTS) if f != "landmarks" or c in LANDMARKS]
         + [("centerface-mbv2.wider-tta", "flip_pairs")])


def plant(monkeypatch, root, cell, fault):
    if fault == "flip_pairs":
        prog = registry.program(registry.cell(cell, root).config)
        sound = prog.detector_config

        def unswapped(cfg, _sound=sound):
            dc = _sound(cfg)
            return dataclasses.replace(dc, decode=dataclasses.replace(dc.decode, lm_flip_perm=(0, 1, 2, 3, 4)))

        monkeypatch.setattr(prog, "detector_config", unswapped)
        return
    for entry in ("detect_batch", "detect_tta"):
        cls = registry.driver(entry, root)
        sound = cls._run
        last = {}

        def broken(self, inputs, _sound=sound, _last=last):
            outs = _sound(self, inputs)
            prev = _last.get("outs")
            _last["outs"] = outs
            return OUTPUT_FAULTS[fault](outs, prev)

        monkeypatch.setattr(cls, "_run", broken)


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_makes_the_run_incorrect(cell, fault, tmp_path, monkeypatch):
    root = tiny_copy(tmp_path)
    plant(monkeypatch, root, cell, fault)
    r = run.run(cell, 2**31 + 101, 0.3, False, cpu(), root=root)
    assert not r["correct"], r["check"]
    (root / "perfbench" / "limits" / f"{cell}.json").write_text(
        json.dumps({"limits": {k: {"limit": v} for k, v in TIGHT.items()}}))
    compute_float32(monkeypatch, cell, root)
    r = run.run(cell, 2**31 + 101, 0.3, False, cpu(), root=root)
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_float8_control_fails_the_cells_limits(cell, tmp_path):
    root = tiny_copy(tmp_path)
    for seed in (2**31 + 103, 2**31 + 104):
        r = calibrate.control(cell, seed, cpu(), root=root)
        assert r["checked_frames"] > 0 and not r["correct"], r["check"]
