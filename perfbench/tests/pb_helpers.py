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
