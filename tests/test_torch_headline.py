"""The port's headline benchmark (`tpucenterface_torch/cli/bench.py`) against
the root `bench.py` of the JAX package, on the CPU.

- Its JSON keys are `bench.py`'s: both dicts read from the source with `ast`
  (`bench.py` measures at 640 on whatever backend JAX has, too large for a
  CPU test); the two `*vs_baseline` values are the constant None.
- `measure` runs once for real on a small Detector at a small size: every
  key present, the rates finite and positive, each spread around its median,
  the roofline shares in [0, 1], the line serializable.
- The int8-input program on the host-staged frames gives the int8
  program's boxes and scores on the raw frames, bit for bit.
- `main` needs a card unless `--device cpu` asks for the CPU, and reads
  BENCH_ITERS, BENCH_PASSES and BENCH_SERVE_ITERS.
"""

import ast
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpucenterface_torch as T
from tpucenterface_torch.bench.roofline import PEAK_BF16_TFLOPS, PEAK_INT8_TOPS
from tpucenterface_torch.cli import bench
from tpucenterface_torch.detector import stage_inputs
from tpucenterface_torch.quant.engine import apply_stem_lut
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(batch=2, side=64, dev_b=4, serve_k=100)
RATES = ("value", "serving_coalesced_img_s", "serving_int8_img_s", "serving_int8in_img_s")
SPREADS = {"value": "value_spread", "serving_coalesced_img_s": "serving_coalesced_spread",
           "serving_int8_img_s": "serving_int8_spread", "serving_int8in_img_s": "serving_int8in_spread"}
SHARES = ("serving_mfu", "serving_hbm_frac", "serving_int8_mfu", "serving_int8_hbm_frac")


def _dict_printed(path):
    """{key: value node} of the dict literal passed to `json.dumps` in the
    module's `main`."""
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call) and getattr(n.func, "attr", None) == "dumps")
    return dict(zip((k.value for k in call.args[0].keys), call.args[0].values))


def _dict_returned(path, fn_name):
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict))
    return dict(zip((k.value for k in ret.value.keys), ret.value.values))


JAX_KEYS = set(_dict_printed(os.path.join(ROOT, "bench.py")))


def test_keys_are_bench_py_s():
    got = _dict_returned(bench.__file__, "measure")
    assert len(JAX_KEYS) == 21 and set(got) == JAX_KEYS


@pytest.mark.parametrize("key", ["vs_baseline", "serving_int8_vs_baseline"])
def test_vs_baseline_is_null(key):
    node = _dict_returned(bench.__file__, "measure")[key]
    assert isinstance(node, ast.Constant) and node.value is None


@pytest.fixture(scope="module")
def small_det():
    return T.Detector(config=T.preset("small"), device="cpu")


@pytest.fixture(scope="module")
def measured(small_det):
    return bench.measure(small_det, iters=1, passes=2, serve_iters=2, **SMALL)


def test_measure_has_every_key(measured):
    assert set(measured) == JAX_KEYS
    assert measured["vs_baseline"] is None and measured["serving_int8_vs_baseline"] is None
    assert all(v is not None for k, v in measured.items() if not k.endswith("vs_baseline"))
    assert measured["unit"] == "img/s" and measured["metric"] == "images/sec/chip @64x64 bs2 fused"
    assert json.loads(json.dumps(measured)) == measured


@pytest.mark.parametrize("key", RATES)
def test_measure_rate_and_spread(measured, key):
    v, (lo, hi) = measured[key], measured[SPREADS[key]]
    assert math.isfinite(v) and v > 0 and lo <= v <= hi


@pytest.mark.parametrize("key", SHARES)
def test_measure_shares(measured, key):
    assert 0.0 <= measured[key] <= 1.0


@pytest.mark.parametrize("mode", ["", "int8_"])
def test_measure_rooflines_and_sections(measured, mode):
    roof = measured[f"serving_{mode}roofline"]
    assert roof["mfu"] == measured[f"serving_{mode}mfu"] and roof["hbm_frac"] == measured[f"serving_{mode}hbm_frac"]
    assert roof["total_ms"] > 0 and roof["gflops"] > 0
    secs = measured[f"serving_{mode}sections"]
    assert secs and secs == roof["sections"] and "conv" in secs
    assert roof["peak_tflops"] == (PEAK_INT8_TOPS if mode else PEAK_BF16_TFLOPS)


def test_measure_leaves_the_detector_in_bf16(small_det, measured):
    assert small_det._quant is None


def test_int8_input_program_equals_int8_program(small_det):
    """On the same frames, the int8-input serving program on the host-staged
    frames and the quantized uint8 serving program on the raw ones: equal
    boxes and scores, bit for bit."""
    b, side, dev_b, k = SMALL["batch"], SMALL["side"], SMALL["dev_b"], SMALL["serve_k"]
    imgs, hws = bench.frames(b, side)
    imgs128, hws128 = np.tile(imgs, (dev_b // b, 1, 1, 1)), np.tile(hws, (dev_b // b, 1))
    small_det.quantize(calib_images=imgs[:8], int8_dw=True)
    try:
        outs = []
        for int8_in, frames in ((False, imgs128), (True, apply_stem_lut(imgs128, small_det.stem_input_lut()))):
            fn, fmt = small_det._batch_fn_auto(dev_b, (side, side), side, identity=True, max_dets=k,
                                               int8_in=int8_in)
            outs.append(fn(*stage_inputs(fmt, frames, hws128, small_det.device)))
    finally:
        small_det.dequantize()
    (boxes, scores), (boxes_i8, scores_i8) = outs
    assert boxes.shape == (dev_b, k, 4) and scores.shape == (dev_b, k)
    assert torch.equal(boxes, boxes_i8) and torch.equal(scores, scores_i8)


def test_measure_refuses_a_ragged_serving_batch(small_det):
    with pytest.raises(ValueError, match="multiple"):
        bench.measure(small_det, batch=3, side=64, dev_b=4)


def test_main_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


@pytest.mark.parametrize("env, want", [
    ({}, (100, 5, None)),
    ({"BENCH_ITERS": "1", "BENCH_PASSES": "2"}, (1, 2, None)),
    ({"BENCH_ITERS": "3", "BENCH_PASSES": "1", "BENCH_SERVE_ITERS": "4"}, (3, 1, 4)),
])
def test_main_on_the_cpu(monkeypatch, capsys, env, want):
    seen = []

    def stub(det, **kw):
        seen.append((det, kw))
        return {"metric": "m", "value": 1.0}

    for name in ("BENCH_ITERS", "BENCH_PASSES", "BENCH_SERVE_ITERS"):
        monkeypatch.delenv(name, raising=False)
    for name, v in env.items():
        monkeypatch.setenv(name, v)
    monkeypatch.setattr(bench, "measure", stub)
    bench.main(["--device", "cpu"])
    (det, kw), = seen
    assert isinstance(det, T.Detector) and det.device.type == "cpu" and det.config.model.width_mult == 1.0
    assert (kw["iters"], kw["passes"], kw["serve_iters"]) == want and set(kw) == {"iters", "passes", "serve_iters"}
    assert [json.loads(ln) for ln in capsys.readouterr().out.splitlines()] == [{"metric": "m", "value": 1.0}]


def test_import_leaves_jax_out():
    code = (
        "import sys; import tpucenterface_torch.cli.bench; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'tensorflow', 'cv2', 'tpucenterface')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
