"""The plain reference against the port on the CPU at a small size: the
network's maps, and whole runs of both entries through the harness with
the program computing in float32, held to limits a thousand times tighter
than the cells'. Each architecture's reference against its own program,
`mobilenetv2-relu` (a copy's architecture of new files alone) too."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from perfbench import registry, run
from perfbench.reference.detect import letterbox, normalise
from perfbench.reference.model import to_device
from perfbench.tests.pb_helpers import RELU_CELL, add_relu_architecture, cpu, tiny_copy
from perfbench.weights import make_variables


# limits a thousand times tighter than the cells', which a sound float32
# program meets
TIGHT = {"score_gap.max": 1e-3, "box_px.max": 1e-3, "peak_gap.max": 1e-3, "count_gap.max": 0.0, "missed.sum": 0.0,
         "sure_score_gap.max": 1e-3, "sure_box_px.max": 1e-3, "sure_lm_px.max": 1e-3}


def float32_program(cfg, base):
    """The program's configuration of `cfg` (by `base`, a program's
    `detector_config`), computing in float32."""
    dc = base(cfg)
    return dataclasses.replace(dc, model=dataclasses.replace(dc.model, compute_dtype="float32"),
                               preprocess=dataclasses.replace(dc.preprocess, resize_dtype="float32"))


def compute_float32(monkeypatch, cell, root):
    """The cell's program, in the copy at `root`, computing in float32 for
    the rest of the test; the program's module."""
    prog = registry.program(registry.cell(cell, root).config)
    sound = prog.detector_config
    monkeypatch.setattr(prog, "detector_config", lambda cfg: float32_program(cfg, sound))
    return prog


def copy_with_relu(tmp_path):
    root = tiny_copy(tmp_path)
    add_relu_architecture(root)
    return root


@pytest.mark.parametrize("arch,name", [("mobilenetv2", "centerface-mbv2"), ("mobilenetv2", "mbv2x1.4-fpn48"),
                                       ("mobilenetv2-relu", "centerface-mbv2-relu")])
def test_network_maps_equal_the_port_module_forward(arch, name, tmp_path):
    from tpucenterface_torch.detector import Detector

    root = copy_with_relu(tmp_path)
    cfg = registry.Config(json.loads((root / "perfbench" / "configs" / f"{name}.json").read_text()), root)
    assert cfg["architecture"] == arch
    ref, prog = registry.architecture(cfg)
    variables = make_variables(cfg, 2**31 + 5, cpu())
    det = Detector(variables=variables, config=float32_program(cfg, prog.detector_config), device="cpu",
                   fold_bn=False)
    frame = np.random.default_rng(0).integers(0, 256, (96, 96, 3), dtype=np.uint8)
    x, *_ = letterbox(torch.from_numpy(frame), 96)
    x = normalise(x[None], cfg["preprocess"]["mean"], cfg["preprocess"]["std"])
    ours = ref.Network(cfg, to_device(variables, "cpu"))(x)
    with torch.no_grad():
        theirs = det.model(x.permute(0, 2, 3, 1).contiguous())
    for k, v in ours.items():
        torch.testing.assert_close(theirs[k], v, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cell", ["centerface-mbv2.batch32-640", "mbv2x1.4-fpn48.batch32-640",
                                  "centerface-mbv2.wider-tta", RELU_CELL])
def test_float32_program_agrees_with_the_reference(cell, tmp_path, monkeypatch):
    root = copy_with_relu(tmp_path)
    (root / "perfbench" / "limits" / f"{cell}.json").write_text(
        json.dumps({"limits": {k: {"limit": v} for k, v in TIGHT.items()}}))
    compute_float32(monkeypatch, cell, root)
    r = run.run(cell, 2**31 + 17, 0.2, False, cpu(), root=root)
    assert r["checked_frames"] > 0
    assert r["correct"], r["check"]
