"""Helpers of the harness tests: a copy of the benchmark whose traffic is
cut to a size the CPU runs in seconds."""

import json
import shutil
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
TINY = {
    "batch32-640": dict(images_per_call=2, heights=[128, 128], widths=[128, 128], distinct_calls=2,
                        warmup_calls=1, trace_calls=2, check_calls=2, score_thresh=0.02),
    "wider-tta": dict(images_per_call=6, heights=[120, 300], widths=[240, 240], distinct_calls=2, batch_size=4,
                      trace_calls=1, check_images=6),
}


def tiny_copy(dst: Path) -> Path:
    """BENCHMARK.json and perfbench/ under `dst`, traffic cut to TINY."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", dst / "perfbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, upd in TINY.items():
        p = dst / "perfbench" / "traffic" / f"{name}.json"
        d = json.loads(p.read_text())
        d.update(upd)
        p.write_text(json.dumps(d))
    return dst


def cpu():
    torch.set_num_threads(2)
    return torch.device("cpu")


RELU_REFERENCE = '''"""Architecture `mobilenetv2-relu`: `mobilenetv2` with ReLU where it has
ReLU6; the same leaves and work. Its configurations state no `relu6`."""

from perfbench.reference import mobilenetv2 as base
from perfbench.reference.mobilenetv2 import forward_flops, leaf_shapes, stride1_blocks  # noqa: F401


def check_config(cfg):
    if "relu6" in cfg:
        raise ValueError("mobilenetv2-relu states its activation by its name, not by relu6")
    base.check_config({**cfg, "relu6": True})


class Network(base.Network):
    def act(self, x):
        return x.relu()
'''

RELU_PROGRAM = '''"""Architecture `mobilenetv2-relu`: the port's MobileNetV2 detector built
with `relu6=False`."""

from perfbench.programs import mobilenetv2 as base
from tpucenterface_torch.detector import Detector


def detector_config(cfg):
    if "relu6" in cfg:
        raise ValueError("mobilenetv2-relu states its activation by its name, not by relu6")
    return base.detector_config({**cfg, "relu6": False})


def build(cfg, variables, device):
    return Detector(variables=variables, config=detector_config(cfg), device=device,
                    fold_bn=cfg["program"]["fold_bn"])
'''
RELU_CELL = "centerface-mbv2-relu.batch32-640"


def add_relu_architecture(root: Path) -> str:
    """In the copy at `root`, architecture `mobilenetv2-relu` with new files
    alone (its reference and program, a configuration of it, a cell on the
    `batch32-640` mix with the limits of `centerface-mbv2`'s) and two new
    entries of BENCHMARK.json; the cell's name."""
    pb = root / "perfbench"
    (pb / "reference" / "mobilenetv2-relu.py").write_text(RELU_REFERENCE)
    (pb / "programs" / "mobilenetv2-relu.py").write_text(RELU_PROGRAM)
    cfg = json.loads((pb / "configs" / "centerface-mbv2.json").read_text())
    del cfg["relu6"]
    cfg.update(name="centerface-mbv2-relu", architecture="mobilenetv2-relu")
    (pb / "configs" / "centerface-mbv2-relu.json").write_text(json.dumps(cfg))
    (pb / "limits" / f"{RELU_CELL}.json").write_text((pb / "limits" / "centerface-mbv2.batch32-640.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "centerface-mbv2-relu", "source": "https://arxiv.org/abs/1911.03599",
                             "file": "perfbench/configs/centerface-mbv2-relu.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": RELU_CELL, "config": "centerface-mbv2-relu", "traffic": "batch32-640",
                               "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return RELU_CELL
