"""Where the harness finds things: every cell, configuration, traffic mix,
limit and metric reader by the name that `BENCHMARK.json` gives it.

- configuration: the file its `configs` entry names. It states its
  `architecture` `<a>`, which brings two files: `perfbench/reference/<a>.py`,
  the frozen plain reference and yardstick (`check_config`, `leaf_shapes`,
  `Network`, `forward_flops`, `stride1_blocks`), and
  `perfbench/programs/<a>.py`, the system under test (`build(cfg, variables,
  device)`, which refuses a key it does not build);
- traffic mix `<t>`: `perfbench/traffic/<t>.json`, data only;
- the entry point `<e>` that a mix drives: `perfbench/entries/<e>.py`, a
  module with a class `Driver` (`drivers.Driver`);
- the loop `<l>` that a mix sends its calls in: `perfbench/loops/<l>.py`, a
  module with `window(driver, seconds, sample, traffic, calls, first)`;
- a cell's limits of the comparison: `perfbench/limits/<cell>.json`;
- metric `<m>`: `perfbench/metrics/<m>.py`, a module with `read(ctx)`.

Adding any of them, a new architecture too, takes new files and a new
entry, no edit of a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Config(dict):
    """A configuration as read from its file; `root` is the checkout it was
    read from, where its architecture's files are looked up."""

    def __init__(self, data: dict, root: Path):
        super().__init__(data)
        self.root = root


class Architecture(NamedTuple):
    reference: ModuleType   # perfbench/reference/<arch>.py
    program: ModuleType     # perfbench/programs/<arch>.py


class Cell(NamedTuple):
    workload: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload '{name}' in BENCHMARK.json: {[w['name'] for w in bench['workloads']]}")
    w = found[0]
    (conf,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    with open(root / conf["file"]) as f:
        config = Config(json.load(f), root)
    base = root / "perfbench"
    with open(base / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(base / "limits" / f"{name}.json") as f:
        limits = {k: float(v["limit"]) for k, v in json.load(f)["limits"].items()}
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, reported)]
    return Cell(w, config, traffic, limits, e2e, per_layer)


_LOADED: Dict[Path, object] = {}


def _module(folder: str, name: str, root: Path):
    """perfbench/<folder>/<name>.py, loaded once a path."""
    path = (root / "perfbench" / folder / f"{name}.py").resolve()
    if path not in _LOADED:
        if not path.exists():
            raise FileNotFoundError(f"no {path.relative_to(root.resolve())}")
        spec = importlib.util.spec_from_file_location(f"perfbench.{folder}.{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def reader(metric: str, root: Path = ROOT):
    """The `read(ctx)` of perfbench/metrics/<metric>.py."""
    return _module("metrics", metric, root).read


def driver(entry: str, root: Path = ROOT):
    """The `Driver` class of perfbench/entries/<entry>.py."""
    return _module("entries", entry, root).Driver


def loop(name: str, root: Path = ROOT):
    """The `window` of perfbench/loops/<name>.py."""
    return _module("loops", name, root).window


def _architecture_module(folder: str, cfg: dict) -> ModuleType:
    if "architecture" not in cfg:
        raise KeyError(f"the configuration {cfg.get('name')!r} names no architecture")
    return _module(folder, cfg["architecture"], getattr(cfg, "root", ROOT))


def reference(cfg: dict) -> ModuleType:
    """perfbench/reference/<arch>.py of the configuration's architecture,
    once its `check_config(cfg)` has passed."""
    mod = _architecture_module("reference", cfg)
    mod.check_config(cfg)
    return mod


def program(cfg: dict) -> ModuleType:
    """perfbench/programs/<arch>.py of the configuration's architecture."""
    return _architecture_module("programs", cfg)


def architecture(cfg: dict) -> Architecture:
    """Both files of the configuration's architecture."""
    return Architecture(reference(cfg), program(cfg))
