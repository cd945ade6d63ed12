"""The port's `cli/bench_suite.py` (the five BASELINE configs) on the CPU.

- Each config returns the JAX package's JSON keys (read from both modules'
  source: the configs run at 640 and on 256 TTA images, too large for a CPU
  test), and config 5's `int8_unavailable` beside them; config 2's
  `vs_baseline` is null.
- Config 1 runs for real on a small Detector on the CPU: JAX's keys, finite
  positive times.
- `main` with stub runners: one JSON line a config, in the order asked,
  `--wider-root` handed to config 3 alone, the Detector from `--weights`
  (safetensors, or a torch `.pth` through `from_torch_pth`) on `--device`.
"""

import ast
import json
import math
import os

import numpy as np
import pytest
import torch

import tpucenterface_torch as T
from tpucenterface_torch.cli import bench_suite
from tpucenterface_torch.weights.io import save_safetensors
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("config1_single_320", "config2_batch640", "config3_tta", "config4_video", "config5_dp")


def _returned(path, fn_name):
    """{key: value node} of the dicts `fn_name` returns in the module at `path`."""
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    out = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            out.update({k.value: v for k, v in zip(node.value.keys, node.value.values)})
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_config_keys_are_jax_s(name):
    want = _returned(os.path.join(ROOT, "tpucenterface", "cli", "bench_suite.py"), name)
    got = _returned(bench_suite.__file__, name)
    assert want and set(got) - set(want) == ({"int8_unavailable"} if name == "config5_dp" else set())
    assert set(want) <= set(got)


def test_vs_baseline_is_null():
    node = _returned(bench_suite.__file__, "config2_batch640")["vs_baseline"]
    assert isinstance(node, ast.Constant) and node.value is None


def test_config1_on_the_cpu():
    det = T.Detector(config=T.preset("small"), device="cpu")
    out = bench_suite.config1_single_320(det)
    assert set(out) == set(_returned(os.path.join(ROOT, "tpucenterface", "cli", "bench_suite.py"),
                                     "config1_single_320"))
    assert out["value"] == out["tunnel_ms"] > 0
    assert math.isfinite(out["device_ms"]) and out["device_ms"] >= 0


@pytest.fixture
def stubs(monkeypatch):
    calls = []

    def stub(name):
        def run(det, **kw):
            calls.append((name, det, kw))
            return {"metric": name, "value": 1.0, "unit": "x"}
        return run

    for name in CONFIGS:
        monkeypatch.setattr(bench_suite, name, stub(name))
    return calls


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_main_one_line_a_config(stubs, capsys):
    bench_suite.main(["--configs", "3,1,5", "--device", "cpu", "--wider-root", "/data/WIDER"])
    lines = _lines(capsys)
    assert [ln["config"] for ln in lines] == [3, 1, 5]
    assert [ln["metric"] for ln in lines] == ["config3_tta", "config1_single_320", "config5_dp"]
    assert [kw for _, _, kw in stubs] == [{"wider_root": "/data/WIDER"}, {}, {}]
    det = stubs[0][1]
    assert isinstance(det, T.Detector) and det.device.type == "cpu"
    assert all(d is det for _, d, _ in stubs)


def test_main_weights(stubs, capsys, tmp_path):
    src = T.Detector(config=T.DetectorConfig(), device="cpu", fold_bn=False, seed=3)
    st = str(tmp_path / "w.safetensors")
    save_safetensors(src.variables, st)
    bench_suite.main(["--configs", "1", "--weights", st, "--device", "cpu"])
    det = stubs[-1][1]
    want = T.Detector.from_safetensors(st, device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32))
    with torch.inference_mode():
        assert torch.equal(det._forward(x)["hm"], want._forward(x)["hm"])
    assert [ln["config"] for ln in _lines(capsys)] == [1]


def test_main_pth_weights_take_the_importer(stubs, monkeypatch, tmp_path):
    seen = []
    monkeypatch.setattr(T.Detector, "from_torch_pth",
                        classmethod(lambda cls, path, config=T.DetectorConfig(), device=None:
                                    seen.append((path, device)) or cls(config=config, device=device)))
    pth = str(tmp_path / "w.pth")
    bench_suite.main(["--configs", "2", "--weights", pth, "--device", "cpu"])
    assert seen == [(pth, "cpu")] and stubs[-1][0] == "config2_batch640"


def test_main_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_suite.main(["--configs", "1"])
