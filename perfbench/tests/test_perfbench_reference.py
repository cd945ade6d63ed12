"""The plain reference against the port on the CPU at a small size: the
network's maps, and whole runs of both entries through the harness with
the program computing in float32, held to limits a thousand times tighter
than the cells'."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from perfbench import program, run
from perfbench.reference.detect import letterbox, normalise
from perfbench.reference.model import Network, to_device
from perfbench.tests.pb_helpers import ROOT, cpu, tiny_copy
from perfbench.weights import make_variables


# limits a thousand times tighter than the cells', which a sound float32
# program meets
TIGHT = {"score_gap.max": 1e-3, "box_px.max": 1e-3, "peak_gap.max": 1e-3, "count_gap.max": 0.0, "missed.sum": 0.0,
         "sure_score_gap.max": 1e-3, "sure_box_px.max": 1e-3, "sure_lm_px.max": 1e-3}


def float32_program(cfg, base=program.detector_config):
    """The program's configuration of `cfg` (by `base`), computing in float32."""
    dc = base(cfg)
    return dataclasses.replace(dc, model=dataclasses.replace(dc.model, compute_dtype="float32"),
                               preprocess=dataclasses.replace(dc.preprocess, resize_dtype="float32"))


@pytest.mark.parametrize("name", ["centerface-mbv2", "mbv2x1.4-fpn48"])
def test_network_maps_equal_the_port_module_forward(name):
    from tpucenterface_torch.detector import Detector

    cfg = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())
    variables = make_variables(cfg, 2**31 + 5, cpu())
    det = Detector(variables=variables, config=float32_program(cfg), device="cpu", fold_bn=False)
    frame = np.random.default_rng(0).integers(0, 256, (96, 96, 3), dtype=np.uint8)
    x, *_ = letterbox(torch.from_numpy(frame), 96)
    x = normalise(x[None], cfg["preprocess"]["mean"], cfg["preprocess"]["std"])
    ours = Network(cfg, to_device(variables, "cpu"))(x)
    with torch.no_grad():
        theirs = det.model(x.permute(0, 2, 3, 1).contiguous())
    for k, v in ours.items():
        torch.testing.assert_close(theirs[k], v, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cell", ["centerface-mbv2.batch32-640", "mbv2x1.4-fpn48.batch32-640",
                                  "centerface-mbv2.wider-tta"])
def test_float32_program_agrees_with_the_reference(cell, tmp_path, monkeypatch):
    root = tiny_copy(tmp_path)
    (root / "perfbench" / "limits" / f"{cell}.json").write_text(
        json.dumps({"limits": {k: {"limit": v} for k, v in TIGHT.items()}}))
    monkeypatch.setattr(program, "detector_config", float32_program)
    r = run.run(cell, 2**31 + 17, 0.2, False, cpu(), root=root)
    assert r["checked_frames"] > 0
    assert r["correct"], r["check"]
