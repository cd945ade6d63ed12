"""The port's measurement tools (`tpucenterface_torch/bench/`) on the CPU,
held against the JAX package's `tpucenterface/bench/` on the same inputs.

- `roofline`: `summarize_rows`, `per_op_floor_ms` and `section_table` equal
  JAX's on the same seeded rows under the same peaks (the JAX module's
  constants set to the H100's for the comparison; the section tables on the
  categories both maps share); `tests/test_roofline.py`'s six cases with the
  card's peaks.
- `op_profile_table`: a hand-written Chrome trace with known kernels,
  launches, ranges and shapes reduces to known rows, categories and work;
  a real CPU trace of the module forward at 64 px has JAX's row fields, and
  its GFLOP equal torch's own `FlopCounterMode` count of the same forward
  (relative 1e-9: both count 2 x the multiply-adds of every conv and matrix
  product); `profile_detect_program` has JAX's fields.
- The same work whatever implements it: the module forward and the fast
  engine (B3's plain version on blocks 0 and 2 at width 0.5 and 128 px)
  read the same GFLOP within 1e-9 relative.
- `timing`: `median_spread` and `slo_sweep._percentiles` equal JAX's;
  every timing function returns a finite positive number on CPU tensors and
  refuses a call without tensors.
- `preset_sweep`: each preset's `params` equal JAX's `sweep_preset` count;
  the smoke case of `tests/test_preset_sweep.py`.
- `slo_sweep`: the counterpart of `tests/test_serving.py::
  test_slo_sweep_harness`.
- `profile_forward`: the row names equal JAX's for the same config.
- Imports: no new module pulls in jax, flax, tensorflow, cv2 or
  `tpucenterface`.
"""

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpucenterface_torch as T
from tpucenterface.bench import profile_forward as jprofile_forward
from tpucenterface.bench import roofline as jroofline
from tpucenterface.bench.slo_sweep import _percentiles as jpercentiles
from tpucenterface.bench.timing import median_spread as jmedian_spread
from tpucenterface.config import preset as jpreset
from tpucenterface.detector import Detector as JDetector
from tpucenterface_torch.bench import op_profile, profile_forward, roofline, timing
from tpucenterface_torch.bench.preset_sweep import sweep_preset
from tpucenterface_torch.bench.slo_sweep import _percentiles, measure_env_h2d, slo_sweep
from tpucenterface_torch.detector import quantize_unsupported
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

ROW_FIELDS = {"category", "name", "ms_per_iter", "gbytes_per_iter", "gflops_per_iter", "occurrences"}


# --------------------------------------------------------------------------- #
# roofline
# --------------------------------------------------------------------------- #


@pytest.fixture
def jax_h100(monkeypatch):
    """The JAX module's peaks set to the H100's (and no recorded floors), so
    that both modules compute with the same constants."""
    monkeypatch.setattr(jroofline, "MEASURED_BF16_TFLOPS", roofline.PEAK_BF16_TFLOPS)
    monkeypatch.setattr(jroofline, "MEASURED_INT8_TOPS", roofline.PEAK_INT8_TOPS)
    monkeypatch.setattr(jroofline, "MEASURED_VPU_TELEMOPS", roofline.PEAK_F32_TFLOPS)
    monkeypatch.setattr(jroofline, "MEASURED_HBM_TBPS", roofline.PEAK_HBM_TBPS)
    monkeypatch.setattr(jroofline, "RECORDED_SECTION_FLOORS", {})


def _rows(seed, categories, n=24):
    rng = np.random.RandomState(seed)
    return [{"category": categories[rng.randint(len(categories))],
             "name": f"op{i}",
             "ms_per_iter": float(rng.uniform(0.001, 5.0)),
             "gflops_per_iter": float(rng.choice([0.0, rng.uniform(0, 500)])),
             "gbytes_per_iter": float(rng.uniform(0, 2.0)),
             "occurrences": int(rng.randint(1, 9))} for i in range(n)]


# both maps: "copy" -> input, "sort" -> decode, an unknown category -> other;
# "convolution" and "matmul" are tensor-core rows in both per-op floors
SHARED = ["copy", "sort", "weird-new-category"]
TENSOR = ["convolution", "matmul"]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_roofline_equals_jax(jax_h100, seed, int8):
    rows = _rows(seed, SHARED + TENSOR)
    # (the JAX function's default HBM rate was bound at its definition)
    hbm = roofline.PEAK_HBM_TBPS
    assert (roofline.summarize_rows(rows, int8=int8, peak_hbm_tbps=hbm)
            == jroofline.summarize_rows(rows, int8=int8, peak_hbm_tbps=hbm))
    assert roofline.summarize_rows(rows, int8=int8) == roofline.summarize_rows(rows, int8=int8, peak_hbm_tbps=hbm)
    assert (roofline.summarize_rows(rows, int8=int8, peak_tflops=123.0, peak_hbm_tbps=2.0)
            == jroofline.summarize_rows(rows, int8=int8, peak_tflops=123.0, peak_hbm_tbps=2.0))
    for r in rows:
        assert roofline.per_op_floor_ms(r, int8=int8) == jroofline.per_op_floor_ms(r, int8=int8)
    shared = [r for r in rows if r["category"] in SHARED]
    assert shared
    for floors in (False, True):
        assert (roofline.section_table(shared, int8=int8, recorded_floors=floors)
                == jroofline.section_table(shared, int8=int8, recorded_floors=floors))


def test_peaks_are_the_h100_data_sheets():
    assert (roofline.PEAK_BF16_TFLOPS, roofline.PEAK_INT8_TOPS, roofline.PEAK_F32_TFLOPS,
            roofline.PEAK_HBM_TBPS) == (989.0, 1979.0, 67.0, 3.35)
    assert roofline.RECORDED_SECTION_FLOORS == {}
    assert not any(name.startswith("MEASURED") for name in vars(roofline))


def test_summarize_rows_arithmetic():
    # 2 ms, 100 GFLOP, 1.3 GB -> 50 TFLOP/s, 0.65 TB/s
    rows = [
        {"ms_per_iter": 1.5, "gflops_per_iter": 90.0, "gbytes_per_iter": 1.0},
        {"ms_per_iter": 0.5, "gflops_per_iter": 10.0, "gbytes_per_iter": 0.3},
    ]
    s = roofline.summarize_rows(rows)
    assert s["total_ms"] == 2.0
    assert s["tflops"] == 50.0
    assert s["mfu"] == round(50.0 / roofline.PEAK_BF16_TFLOPS, 4)
    assert s["hbm_tbps"] == 0.65
    assert s["hbm_frac"] == round(0.65 / roofline.PEAK_HBM_TBPS, 4)
    assert s["peak_tflops"] == roofline.PEAK_BF16_TFLOPS


def test_summarize_rows_int8_peak_and_override():
    rows = [{"ms_per_iter": 1.0, "gflops_per_iter": 35.0, "gbytes_per_iter": 0.0}]
    s = roofline.summarize_rows(rows, int8=True)
    assert s["peak_tflops"] == roofline.PEAK_INT8_TOPS
    assert s["mfu"] == round(35.0 / roofline.PEAK_INT8_TOPS, 4)
    assert roofline.summarize_rows(rows, peak_tflops=70.0)["mfu"] == 0.5


def test_summarize_rows_empty_and_missing_fields():
    assert roofline.summarize_rows([])["tflops"] is None
    s = roofline.summarize_rows([{"ms_per_iter": 2.0}])
    assert s["total_ms"] == 2.0 and s["tflops"] == 0.0 and s["mfu"] == 0.0


def test_roofline_of_fn_smoke(tmp_path):
    """A real CPU trace of a matrix product, reduced: the field set, and the
    product's 2 M N K."""
    a = torch.from_numpy(np.random.RandomState(0).rand(256, 256).astype(np.float32))
    s = roofline.roofline_of_fn(lambda x: x @ x, (a,), iters=2, logdir=str(tmp_path))
    for k in ("total_ms", "tflops", "mfu", "hbm_tbps", "hbm_frac", "sections"):
        assert k in s
    assert s["gflops"] == round(2 * 256 ** 3 / 1e9, 2)
    assert 0.0 <= s["mfu"] <= 1.0 and 0.0 <= s["hbm_frac"] <= 1.0


def test_per_op_floor_ms_axes():
    # conv row: the tensor-core rate's compute floor dominates
    conv = {"category": "convolution", "ms_per_iter": 1.0, "gflops_per_iter": 989.0, "gbytes_per_iter": 0.335}
    assert abs(roofline.per_op_floor_ms(conv) - 1.0) < 1e-9
    assert abs(roofline.per_op_floor_ms(conv, int8=True) - 989.0 / 1979.0) < 1e-9
    # the port's kernels are tensor-core rows too
    assert roofline.per_op_floor_ms({**conv, "category": "conv"}) == roofline.per_op_floor_ms(conv)
    # elementwise row: costed at the float32 rate, not the tensor cores'
    elem = {"category": "elementwise", "ms_per_iter": 1.0, "gflops_per_iter": 0.5, "gbytes_per_iter": 0.0}
    assert abs(roofline.per_op_floor_ms(elem) - 0.5 / roofline.PEAK_F32_TFLOPS) < 1e-9
    # HBM-bound row: the bytes axis wins
    stream = {"category": "copy", "ms_per_iter": 1.0, "gflops_per_iter": 0.0, "gbytes_per_iter": 3.35}
    assert abs(roofline.per_op_floor_ms(stream) - 1.0) < 1e-9


def test_section_table_mapping_and_ratios(monkeypatch):
    rows = [
        {"category": "convolution", "ms_per_iter": 20.0, "gflops_per_iter": 9895.0,
         "gbytes_per_iter": 3.25},                                   # floor 5 (int8)
        {"category": "copy", "ms_per_iter": 0.8, "gflops_per_iter": 0.0, "gbytes_per_iter": 1.34},  # floor 0.4
        {"category": "sort", "ms_per_iter": 0.2, "gflops_per_iter": 0.0, "gbytes_per_iter": 0.0},
        {"category": "upsample", "ms_per_iter": 0.4, "gflops_per_iter": 0.0, "gbytes_per_iter": 0.67},  # 0.2
        {"category": "weird-new-category", "ms_per_iter": 0.1, "gflops_per_iter": 0.0, "gbytes_per_iter": 0.0},
    ]
    t = roofline.section_table(rows, int8=True, recorded_floors=True)
    assert set(t) == {"conv", "input", "decode", "neck", "other"}
    assert t["conv"]["ms"] == 20.0 and abs(t["conv"]["floor_ms"] - 5.0) < 1e-6 and t["conv"]["ratio"] == 4.0
    assert t["input"]["ms"] == 0.8 and abs(t["input"]["ratio"] - 2.0) < 1e-6
    assert t["neck"]["ratio"] == 2.0
    # zero-floor section: ratio None, not a division crash
    assert t["decode"]["ms"] == 0.2 and t["decode"]["ratio"] is None
    # no floor recorded on a card yet: recorded_floors attaches nothing
    assert not any("recorded_floor_ms" in d for d in t.values())
    # the mechanism, with a floor in the table: per mode and section, only on request
    monkeypatch.setattr(roofline, "RECORDED_SECTION_FLOORS", {("int8", "conv"): 22.5})
    t = roofline.section_table(rows, int8=True, recorded_floors=True)
    assert t["conv"]["recorded_floor_ms"] == 22.5 and abs(t["conv"]["vs_recorded"] - 20.0 / 22.5) < 1e-3
    assert "recorded_floor_ms" not in t["other"]
    assert "recorded_floor_ms" not in roofline.section_table(rows, int8=False, recorded_floors=True)["conv"]
    assert "vs_recorded" not in roofline.section_table(rows, int8=True)["conv"]


# --------------------------------------------------------------------------- #
# op_profile
# --------------------------------------------------------------------------- #


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid, "ts": ts, "dur": dur, "args": args}


CONV_ARGS = {
    "Input Dims": [[2, 8, 16, 16], [16, 4, 3, 3], [16], [], [], [], []],
    "Input type": ["c10::BFloat16"] * 3 + ["ScalarList"] * 3 + ["Scalar"],
    "Concrete Inputs": ["", "", "", "[2, 2]", "[1, 1]", "[1, 1]", "2"],
}


def _card_trace():
    """A card's trace: capture_trace's warm-up call; then a grouped conv
    (three kernels, the longest its strided bias add), a work range of B3 and
    one of B2 (two kernels), a pinned copy inside aten::copy_, a kernel whose
    launch is not in the trace, and one linked by its External id only."""
    return [
        # the warm-up call, left out: its ops and kernels start before its range ends
        _x("user_annotation", op_profile.WARM_UP_RANGE, -300, 250, **{"External id": 30}),
        _x("cpu_op", "aten::conv2d", -290, 100, **{"External id": 31}, **CONV_ARGS),
        _x("cuda_runtime", "cudaLaunchKernel", -280, 5, correlation=41),
        _x("kernel", "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", -270, 40, tid=9,
           correlation=41),
        _x("kernel", "a warm-up kernel", -100, 40, tid=9, correlation=42),
        _x("cpu_op", "aten::conv2d", 0, 100, **{"External id": 1}, **CONV_ARGS),
        _x("cpu_op", "aten::cudnn_convolution", 10, 80, **{"External id": 2}),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 5, correlation=11),
        _x("cuda_runtime", "cudaLaunchKernel", 50, 5, correlation=12),
        _x("kernel", "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", 1000, 40, tid=9,
           correlation=11, **{"External id": 2}),
        _x("kernel", "void cudnn::ops::nchwToNhwcKernel<__nv_bfloat16>(...)", 1040, 10, tid=9, correlation=12),
        _x("cuda_runtime", "cudaLaunchKernel", 70, 5, correlation=17),
        _x("kernel", "void at::native::elementwise_kernel<128, 4, (bias add)>(int, (lambda))", 1050, 60, tid=9,
           correlation=17),
        _x("user_annotation", "tcf::mbconv flops=1000 bytes=500", 200, 50, **{"External id": 3}),
        _x("cpu_op", "aten::empty", 205, 2, **{"External id": 4}),
        _x("cuda_runtime", "cudaLaunchKernel", 210, 5, correlation=13),
        _x("kernel", "void mbconv_kernel<8, 2>(Params)", 1100, 30, tid=9, correlation=13),
        _x("user_annotation", "tcf::decode flops=13 bytes=24", 300, 40, **{"External id": 5}),
        _x("cuda_runtime", "cudaLaunchKernel", 305, 5, correlation=14),
        _x("cuda_runtime", "cudaLaunchKernel", 320, 5, correlation=15),
        _x("kernel", "band_kernel(Plane3, unsigned long*, int, int, int, int)", 1200, 5, tid=9, correlation=14),
        _x("kernel", "merge_kernel(unsigned long const*, ...)", 1205, 3, tid=9, correlation=15),
        _x("cpu_op", "aten::copy_", 395, 20, **{"External id": 6, "Input Dims": [[250], [250]],
                                               "Input type": ["float", "float"]}),
        _x("cuda_runtime", "cudaMemcpyAsync", 400, 5, correlation=16),
        _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 1300, 4, tid=9, correlation=16, bytes=1000),
        _x("kernel", "void at::native::elementwise_kernel<128, 2, (lambda)>(int, (lambda))", 1400, 7, tid=9,
           correlation=99),
        _x("cpu_op", "aten::add", 500, 10, **{"External id": 20, "Input Dims": [[4, 4], [4, 4], []],
                                             "Input type": ["float", "float", "Scalar"]}),
        _x("kernel", "void at::native::vectorized_elementwise_kernel<4, (lambda)>(int, (lambda))", 1500, 6, tid=9,
           **{"External id": 20}),
        {"ph": "i", "name": "an instant event", "pid": 7, "tid": 1, "ts": 5},
    ]


def test_op_profile_table_hand_written_trace(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _card_trace()}))
    rows = {r["name"]: r for r in op_profile.op_profile_table([str(path)], iters=1)}
    assert all(set(r) == ROW_FIELDS for r in rows.values())
    # the conv: 2 x 2 images x 16 outputs x 8x8 positions x (4 inputs x 9 taps);
    # bytes: x, w, b and out (2 x 16 x 8 x 8), bfloat16; credited to its
    # longest convolution kernel, not to the longer bias add
    conv = rows["sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"]
    assert conv["category"] == "convolution" and conv["ms_per_iter"] == 0.04
    assert conv["gflops_per_iter"] == pytest.approx(2 * 2 * 16 * 64 * 4 * 9 / 1e9)
    assert conv["gbytes_per_iter"] == pytest.approx((2 * 8 * 256 + 16 * 36 + 16 + 2 * 16 * 64) * 2 / 1e9)
    transpose = rows["void cudnn::ops::nchwToNhwcKernel<__nv_bfloat16>(...)"]
    assert (transpose["category"], transpose["gflops_per_iter"], transpose["gbytes_per_iter"]) == (
        "data formatting", 0.0, 0.0)
    mb = rows["tcf::mbconv"]
    assert (mb["category"], mb["ms_per_iter"], mb["occurrences"]) == ("conv", 0.03, 1)
    assert mb["gflops_per_iter"] == pytest.approx(1e-6) and mb["gbytes_per_iter"] == pytest.approx(5e-7)
    dec = rows["tcf::decode"]  # two kernels, one row, one call
    assert (dec["category"], dec["ms_per_iter"], dec["occurrences"]) == ("decode", 0.008, 1)
    assert dec["gflops_per_iter"] == pytest.approx(13e-9) and dec["gbytes_per_iter"] == pytest.approx(24e-9)
    cp = rows["Memcpy HtoD (Pinned -> Device)"]  # its own bytes; the op credits nothing more
    assert cp["category"] == "copy" and cp["gbytes_per_iter"] == pytest.approx(1e-6)
    bias = rows["void at::native::elementwise_kernel<128, 4, (bias add)>(int, (lambda))"]
    assert (bias["category"], bias["ms_per_iter"], bias["gflops_per_iter"]) == ("strided elementwise", 0.06, 0.0)
    strided = rows["void at::native::elementwise_kernel<128, 2, (lambda)>(int, (lambda))"]
    assert (strided["category"], strided["gbytes_per_iter"]) == ("strided elementwise", 0.0)
    vec = rows["void at::native::vectorized_elementwise_kernel<4, (lambda)>(int, (lambda))"]
    assert vec["category"] == "elementwise" and vec["gbytes_per_iter"] == pytest.approx(3 * 16 * 4 / 1e9)
    assert list(rows) == sorted(rows, key=lambda n: -rows[n]["ms_per_iter"])
    assert "a warm-up kernel" not in rows and conv["occurrences"] == 1
    # two iterations: halves per iteration, occurrences summed
    two = {r["name"]: r for r in op_profile.op_profile_table([str(path), str(path)], iters=2)}
    assert two["tcf::mbconv"]["occurrences"] == 2 and two["tcf::mbconv"]["ms_per_iter"] == 0.03
    owners = op_profile.kernel_owners([str(path)])
    assert owners["void at::native::elementwise_kernel<128, 4, (bias add)>(int, (lambda))"] == {"aten::conv2d": 1}
    assert owners["void mbconv_kernel<8, 2>(Params)"] == {"tcf::mbconv flops=1000 bytes=500": 1}
    assert owners["merge_kernel(unsigned long const*, ...)"] == {"tcf::decode flops=13 bytes=24": 1}
    assert owners["void at::native::elementwise_kernel<128, 2, (lambda)>(int, (lambda))"] == {"(not found)": 1}
    assert owners["void at::native::vectorized_elementwise_kernel<4, (lambda)>(int, (lambda))"] == {"aten::add": 1}


@pytest.mark.parametrize("name, category", [
    ("sm90_xmma_gemm_s8s8_s32_128x128", "matmul"),
    ("nvjet_tst_128x64_64x4_1x2_h_bz_TNN", "matmul"),
    ("void conv2d_grouped_direct_kernel<float>(...)", "convolution"),
    ("void at::native::reduce_kernel<512, 1>(...)", "reduce"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<...>", "cat"),
    ("void at::native::upsample_nearest2d_nhwc_out_frame<c10::BFloat16, &nearest_neighbor_compute_source_index>",
     "upsample"),
    ("void nhwcAddPaddingKernel<__nv_bfloat16>(..., cudnn::reduced_divisor)", "data formatting"),
    ("void at::native::sbtopk::gatherTopK<float>(...)", "sort"),
    ("void at::native::index_elementwise_kernel<128, 4>(...)", "strided elementwise"),
    ("Memset (Device)", "memset"),
    ("void int8_block_s1_kernel<8, 4, 2>(Params)", "conv"),
    ("nms_kernel(float const*, ...)", "decode"),
    ("something else", "other"),
])
def test_kernel_categories(name, category):
    assert op_profile.kernel_category(name) == category


def _flop_counter_count(fn, x):
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn(x)
    return fc.get_total_flops()


def test_op_profile_of_a_cpu_forward(tmp_path):
    """A real CPU trace of the module forward at 64 px: JAX's row fields, and
    the GFLOP of torch's own FlopCounterMode on the same forward."""
    det = T.Detector(config=T.DetectorConfig(), device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32))
    paths = op_profile.capture_trace(det._forward, (x,), str(tmp_path), iters=2)
    assert len(paths) == 1
    rows = op_profile.op_profile_table(paths, iters=2)
    assert rows and all(set(r) == ROW_FIELDS for r in rows)
    cats = {r["category"] for r in rows}
    assert {"convolution", "matmul", "upsample"} <= cats
    with torch.inference_mode():
        want = _flop_counter_count(det._forward, x) / 1e9
    got = sum(r["gflops_per_iter"] for r in rows)
    assert got == pytest.approx(want, rel=1e-9)


def test_same_gflop_module_forward_and_fast_engine(tmp_path):
    """The fast engine runs B3 (its plain version on the CPU) on blocks 0 and
    2 at 128 px; its work ranges read what the module forward's convolutions
    read."""
    cfg = T.DetectorConfig(model=T.ModelConfig(width_mult=0.5))
    det = T.Detector(config=cfg, device="cpu")
    fast = T.Detector(config=T.DetectorConfig(model=T.ModelConfig(width_mult=0.5, inference_engine="fast")),
                      device="cpu")
    assert fast._engine.kernel_blocks(128) == [0, 2]
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 128, 128, 3).astype(np.float32))
    gflops = {}
    for name, d in (("module", det), ("fast", fast)):
        rows = op_profile.op_profile_table(op_profile.capture_trace(d._forward, (x,), str(tmp_path / name)), 3)
        gflops[name] = sum(r["gflops_per_iter"] for r in rows)
        if name == "fast":
            mb = [r for r in rows if r["name"] == "tcf::mbconv"]
            assert len(mb) == 1 and mb[0]["occurrences"] == 2 * 3 and mb[0]["category"] == "conv"
    assert gflops["fast"] == pytest.approx(gflops["module"], rel=1e-9)
    with torch.inference_mode():
        assert gflops["module"] == pytest.approx(_flop_counter_count(det._forward, x) / 1e9, rel=1e-9)


def test_profile_detect_program_fields():
    jfields = {"total_ms", "img_per_s", "roofline", "sections", "by_category_ms", "top_ops"}
    out = op_profile.profile_detect_program(batch=2, size=64, iters=1, device="cpu")
    assert set(out) == jfields
    assert out["total_ms"] > 0 and out["roofline"]["gflops"] > 0
    assert all(set(r) == ROW_FIELDS for r in out["top_ops"])
    assert set(out["sections"]) <= {"conv", "input", "decode", "neck", "other"}


def test_profile_detect_program_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        op_profile.profile_detect_program(batch=1, size=64, iters=1)


# --------------------------------------------------------------------------- #
# timing
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", range(3))
def test_median_spread_and_percentiles_equal_jax(seed):
    rng = np.random.RandomState(seed)
    for n in (1, 2, 5, 30, 101):
        vals = [float(v) for v in rng.exponential(40.0, n)]
        assert timing.median_spread(vals) == jmedian_spread(vals)
        assert timing.median_spread(vals, ndigits=3) == jmedian_spread(vals, ndigits=3)
        assert _percentiles(vals) == jpercentiles(vals)


def test_timing_on_cpu_tensors():
    a = torch.from_numpy(np.random.RandomState(0).rand(64, 64).astype(np.float32))
    for ms in (timing.op_time_ms(torch.matmul, a, a, k_pair=(1, 3), reps=2),
               timing.chain_op_time_ms(lambda y: y * 0.5 + 1.0, a, k_pair=(1, 3), reps=2),
               timing.dep_op_time_ms(lambda y: y.sum(0), a, k_pair=(1, 3), reps=2)):
        assert math.isfinite(ms) and ms >= 0.0

    def prog(im, hw):
        return im.float().mean((1, 2, 3)), hw.sum(1).float()

    im = torch.zeros((4, 16, 16, 3), dtype=torch.uint8)
    hw = torch.full((4, 2), 16, dtype=torch.int32)
    ips = [timing.fifo_ips(prog, im, hw, 4, 3), timing.throughput_images_per_sec(prog, (im, hw), 4, iters=3),
           *timing.fifo_ips_passes(prog, im, hw, 4, 2, passes=2)]
    assert all(math.isfinite(v) and v > 0 for v in ips)
    with pytest.raises(ValueError, match="tensor"):
        timing.op_time_ms(lambda: None)


# --------------------------------------------------------------------------- #
# preset_sweep
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["small", "default", "large"])
def test_sweep_preset_params_equal_jax(name):
    import jax

    jdet = JDetector(config=jpreset(name))
    want = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(jdet.variables))
    out = sweep_preset(name, side=64, dev_b=2, iters=1, passes=1, device="cpu")
    assert out["params"] == want
    assert out["serving_int8_img_s"] is not None and out["int8_unavailable"] is None


def test_sweep_preset_smoke():
    out = sweep_preset("small", side=64, dev_b=4, iters=2, passes=1, device="cpu")
    assert out["preset"] == "small" and out["params"] > 0
    assert np.isfinite(out["serving_bf16_img_s"])
    assert out["serving_int8_img_s"] is not None
    assert out["serving_bf16_spread"][0] <= out["serving_bf16_img_s"] <= out["serving_bf16_spread"][1]


@pytest.mark.parametrize("model, why", [
    (dict(folded=False), "folded"),
    (dict(folded=True, s2d_stem=True), "s2d"),
    (dict(folded=True, head_conv=0), "head_conv"),
    (dict(folded=True), None),
])
def test_quantize_unsupported_is_quantize_s_check(model, why):
    reason = quantize_unsupported(T.ModelConfig(**model))
    assert (reason is None) == (why is None) and (why is None or why in reason)


def test_quantize_raises_the_precondition():
    det = T.Detector(config=T.DetectorConfig(model=T.ModelConfig(head_conv=0)), device="cpu")
    reason = quantize_unsupported(det.config.model)
    assert reason is not None
    with pytest.raises(ValueError) as e:
        det.quantize(calib_images=np.zeros((1, 64, 64, 3), np.uint8), size=64)
    assert str(e.value) == reason


# --------------------------------------------------------------------------- #
# slo_sweep
# --------------------------------------------------------------------------- #


def test_slo_sweep_harness():
    """At toy scale: saturation, a lone-request floor, per-load percentiles
    and the copy's constant, as `tests/test_serving.py::test_slo_sweep_harness`."""
    det = T.Detector(config=T.DetectorConfig(model=T.ModelConfig(compute_dtype="float32"), default_size=64),
                     device="cpu")
    out = slo_sweep(det, (64, 64), request_bs=4, device_batch=8, fractions=(0.5,), seconds=1.5, max_dets=None)
    assert out["saturation_img_s"] > 0
    lone = out["lone_request"]
    assert lone["n"] == 30 and lone["p50_ms"] <= lone["p95_ms"] <= lone["p99_ms"]
    (pt,) = out["loaded"]
    assert pt["load_frac"] == 0.5 and pt["achieved_requests"] >= 1
    for k in ("p50_ms", "p95_ms", "p99_ms"):
        assert pt[k] is not None and pt[k] > 0
    assert out["env_h2d_launch_bs"] == 8 and out["staging"] == "formatted"
    assert {"env_h2d_ms_per_launch", "env_h2d_mb_s"} <= set(out)


def test_measure_env_h2d():
    out = measure_env_h2d((32, 32), 4, trials=3, staging="plain", device="cpu")
    assert set(out) == {"env_h2d_ms_per_launch", "env_h2d_mb_s"}
    with pytest.raises(ValueError, match="staging"):
        measure_env_h2d((32, 32), 4, staging="warp", device="cpu")


# --------------------------------------------------------------------------- #
# profile_forward
# --------------------------------------------------------------------------- #


def test_profile_forward_rows_equal_jax(monkeypatch):
    monkeypatch.setattr(jprofile_forward, "op_time_ms", lambda *a, **k: 0.0)
    want = jprofile_forward.profile(batch=1, size=64)
    got = profile_forward.profile(batch=1, size=64, k_pair=(1, 2), device="cpu")
    assert list(got) == list(want)
    assert all(math.isfinite(ms) and ms >= 0 for ms in got.values())


# --------------------------------------------------------------------------- #
# imports
# --------------------------------------------------------------------------- #


def test_import_leaves_jax_out():
    code = (
        "import sys; import tpucenterface_torch.bench, tpucenterface_torch.bench.timing, "
        "tpucenterface_torch.bench.roofline, tpucenterface_torch.bench.op_profile, "
        "tpucenterface_torch.bench.profile_forward, tpucenterface_torch.bench.preset_sweep, "
        "tpucenterface_torch.bench.slo_sweep, tpucenterface_torch.cli.bench_suite; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'tensorflow', 'cv2', 'tpucenterface')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
