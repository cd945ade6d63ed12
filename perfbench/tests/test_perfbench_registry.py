"""BENCHMARK.json against the contract, and the harness finding every
piece by its name, so that a cell, a configuration, an architecture, a mix
or a metric is added with new files and entries alone."""

import json
import re
from pathlib import Path

import pytest

from perfbench import check, registry
from perfbench.drivers import Driver
from perfbench.tests.pb_helpers import RELU_CELL, ROOT, add_relu_architecture, cpu, tiny_copy

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("perfbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        mix = json.loads((ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "perfbench" / "entries" / f"{mix['entry']}.py").exists()
        assert (ROOT / "perfbench" / "loops" / f"{mix['loop']}.py").exists()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").exists()
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists()
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"] and set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_is_found_by_name(cell):
    c = registry.cell(cell)
    assert c.config["name"] == c.workload["config"] and c.traffic["name"] == c.workload["traffic"]
    ref, prog = registry.architecture(c.config)
    assert callable(ref.Network) and callable(prog.build)
    assert c.limits and all(k.split(".")[0] in check.NUMBERS and k.split(".")[1] in check.STATS for k in c.limits)
    assert c.limits["missed.sum"] == 0.0
    assert callable(registry.loop(c.traffic["loop"])) and issubclass(registry.driver(c.traffic["entry"]), Driver)
    assert "setup_s" in {m["name"] for m in c.end_to_end} and len(c.end_to_end) >= 2
    assert c.per_layer and all(callable(registry.reader(m["name"])) for m in c.per_layer + c.end_to_end)


NEW_ENTRY = """
import torch

from perfbench import drivers
from perfbench.reference.detect import answer
from perfbench.work import forward_flops


class Driver(drivers.Driver):
    def size_of(self, f):
        return drivers.pick_bucket(self.cfg["buckets"], max(f.shape[:2]))

    def _run(self, imgs):
        return [self.det.detect(f, score_thresh=self.thresh, size=self.size_of(f)) for f in imgs]

    def flops(self, call):
        return sum(forward_flops(self.cfg, self.size_of(f)) for f in self.pool[call.index])

    def answers(self, ref, index, picks, device):
        out = []
        for j in picks:
            f = self.pool[index][j]
            vs = ref.variants([torch.from_numpy(f).to(device)], self.size_of(f), False, int(self.cfg["max_dets"]))[0]
            out.append((vs, answer(vs, self.thresh, None, None)))
        return out
"""


def test_a_new_cell_config_mix_entry_and_metric_need_only_files_and_entries(tmp_path):
    """In a copy: a configuration, a traffic mix over a new entry point
    (`Detector.detect`, one frame a call of the program), a cell over them,
    its limits and a per-layer metric, each new files and new entries; the
    harness runs the new cell on the CPU and reports the new metric."""
    from perfbench import run

    root = tiny_copy(tmp_path)
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "centerface-mbv2.json").read_text())
    cfg.update(name="centerface-mbv2-nolm", with_landmarks=False, buckets=[96, 128])
    (pb / "configs" / "centerface-mbv2-nolm.json").write_text(json.dumps(cfg))
    (pb / "entries" / "detect_each.py").write_text(NEW_ENTRY)
    mix = json.loads((pb / "traffic" / "batch32-640.json").read_text())
    mix.update(name="each3-96", entry="detect_each", images_per_call=3, heights=[80, 96], widths=[96, 120])
    (pb / "traffic" / "each3-96.json").write_text(json.dumps(mix))
    (pb / "limits" / "centerface-mbv2-nolm.each3-96.json").write_text(
        (pb / "limits" / "mbv2x1.4-fpn48.batch32-640.json").read_text())
    (pb / "metrics" / "calls_made.py").write_text("def read(ctx):\n    return float(len(ctx.calls))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "centerface-mbv2-nolm", "source": "https://arxiv.org/abs/1911.03599",
                             "file": "perfbench/configs/centerface-mbv2-nolm.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "centerface-mbv2-nolm.each3-96", "config": "centerface-mbv2-nolm",
                               "traffic": "each3-96", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "calls_made", "unit": "calls", "better": "higher", "bound": 0.25,
                                "source": "host_clock", "workloads": ["centerface-mbv2-nolm.each3-96"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run.run("centerface-mbv2-nolm.each3-96", 7, 0.2, False, cpu(), root=root)
    assert r["metrics"]["calls_made"]["value"] >= 1
    assert r["attempted"] % 3 == 0 and r["checked_frames"] == 3 * min(2, r["attempted"] // 3)
    assert r["correct"], r["check"]


def files(root):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}


def test_a_new_architecture_needs_only_files_and_entries(tmp_path, monkeypatch):
    """In a copy: `mobilenetv2-relu` (a reference with ReLU where
    `mobilenetv2` has ReLU6, a program built with `relu6=False`), a
    configuration of it, a cell, its limits, and a `configs` and a
    `workloads` entry; no file that was there changes but BENCHMARK.json's
    two lists. The cell runs correct. The reference is the architecture's:
    with the programs computing in float32 and limits a thousand times
    tighter than the cells', the ReLU program agrees with it and
    `mobilenetv2`'s ReLU6 program, on the same variables, does not. (At the
    cell's own limits the two programs both pass: on these random weights
    ReLU6 binds on about 0.1% of activations, PERF.md section 7.)"""
    from perfbench import run
    from perfbench.tests.test_perfbench_reference import TIGHT, compute_float32

    root = tiny_copy(tmp_path)
    before = files(root)
    assert add_relu_architecture(root) == RELU_CELL
    after = files(root)
    changed = {p for p in before if after[p] != before[p]}
    assert changed == {Path("BENCHMARK.json")}
    old, new = (json.loads(x[Path("BENCHMARK.json")]) for x in (before, after))
    for k in old:
        assert new[k] == old[k] or (k in ("configs", "workloads") and new[k][:len(old[k])] == old[k]), k
    seed = 2**31 + 41
    r = run.run(RELU_CELL, seed, 0.2, False, cpu(), root=root)
    assert r["checked_frames"] > 0 and r["correct"], r["check"]

    (root / "perfbench" / "limits" / f"{RELU_CELL}.json").write_text(
        json.dumps({"limits": {k: {"limit": v} for k, v in TIGHT.items()}}))
    relu = compute_float32(monkeypatch, RELU_CELL, root)
    relu6 = compute_float32(monkeypatch, "centerface-mbv2.batch32-640", root)
    r = run.run(RELU_CELL, seed, 0.2, False, cpu(), root=root)
    assert r["correct"], r["check"]
    monkeypatch.setattr(relu, "build", lambda cfg, variables, device: relu6.build({**cfg, "relu6": True},
                                                                                  variables, device))
    r = run.run(RELU_CELL, seed, 0.2, False, cpu(), root=root)
    assert r["checked_frames"] > 0 and not r["correct"], r["check"]


@pytest.mark.parametrize("folder", ["reference", "programs"])
def test_an_architecture_with_no_file_fails_naming_the_path(folder, tmp_path):
    from perfbench import run

    root = tiny_copy(tmp_path)
    add_relu_architecture(root)
    (root / "perfbench" / folder / "mobilenetv2-relu.py").unlink()
    with pytest.raises(FileNotFoundError, match=f"perfbench/{folder}/mobilenetv2-relu.py"):
        run.run(RELU_CELL, 3, 0.2, False, cpu(), root=root)
