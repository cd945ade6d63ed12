"""The result line's keys, and the reading of a trace."""

import json

from pytest import approx

from perfbench import registry, run
from perfbench.tests.pb_helpers import ROOT
from perfbench.trace import kernel_category, read_trace
from types import SimpleNamespace

CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


def fake_trace(path, launched=True):
    def ev(name, cat, ts, dur, tid=1, **args):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid, "args": args}

    events = [
        ev("perfbench::window", "user_annotation", 100, 1000),
        ev("aten::conv2d", "cpu_op", 100, 300, **{"Input Dims": [[2, 3, 64, 64], [32, 3, 3, 3]]}),
        ev("aten::convolution", "cpu_op", 101, 298, **{"Input Dims": [[2, 3, 64, 64], [32, 3, 3, 3]]}),
        ev("cudaLaunchKernel", "cuda_runtime", 150 if launched else 50, 5, correlation=5),
        ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 110, 90, tid=7),
        ev("void mbconv_kernel<64, 8, 2, 2, true>(Params)", "kernel", 200, 100, tid=7, correlation=5),
        ev("void at::native::elementwise_kernel<128, 4>(add)", "kernel", 250, 150, tid=7),
        ev("aten::topk", "cpu_op", 500, 400),
        ev("void at::native::sbtopk::gatherTopK<float>()", "kernel", 600, 50, tid=7),
        ev("void band_kernel<1024>()", "kernel", 1000, 200, tid=7),  # runs past the window's end
        ev("void outside()", "kernel", 5000, 10, tid=7),
    ]
    path.write_text(json.dumps({"traceEvents": events}))
    return read_trace(str(path))


def test_trace_reading(tmp_path):
    tr = fake_trace(tmp_path / "t.json")
    assert tr.window_s == approx(1000e-6)
    assert tr.busy_s() == approx((400 - 110 + 50 + 100) * 1e-6)  # [110, 400], [600, 650], [1000, 1100]
    gaps = tr.idle_gaps(2)
    assert [g[0] for g in gaps] == ["aten::topk"] * 2 and [g[1] for g in gaps] == approx([350e-6, 200e-6])
    assert tr.top_ops(1)[0][0] == "void band_kernel<1024>()" and tr.top_ops(1)[0][1] == approx(200e-6)
    cats = tr.by_category_s()
    assert [cats["conv"], cats["strided elementwise"], cats["decode"]] == approx([100e-6, 150e-6, 200e-6])
    assert kernel_category("void at::native::vectorized_elementwise_kernel<4>") == "elementwise"


def test_per_layer_readers_on_a_trace(tmp_path):
    from perfbench.work import stride1_blocks

    tr = fake_trace(tmp_path / "t.json")
    assert tr.forwards == [(100, 2, 64, 64)]
    cfg = json.loads((ROOT / "perfbench" / "configs" / "centerface-mbv2.json").read_text())
    block = stride1_blocks(cfg, 64, 64, 2)[0]  # the forward's one launch: its first stride-1 block
    ctx = SimpleNamespace(trace=tr, images=2, flops=989 * 10**6, config=cfg, calls=[], setup_s=1.0)
    read = lambda m: registry.reader(m)(ctx)  # noqa: E731
    assert read("h2d_ms_per_image") == approx(90e-6 * 1e3 / 2)
    assert read("elementwise_ms_per_image") == approx(150e-6 * 1e3 / 2)
    assert read("decode_ms_per_image") == approx((50 + 200) * 1e-6 * 1e3 / 2)
    assert abs(read("mfu") - 100 * 989e6 / (1e-3 * 989e12)) < 1e-9
    assert abs(read("idle_share") - 100 * (1 - 440 / 1000)) < 1e-9
    assert abs(read("mbconv_roofline") - 100 * block.floor_s() / 100e-6) < 1e-9
    ctx.trace = fake_trace(tmp_path / "u.json", launched=False)  # launched before any forward: nothing to read
    assert read("mbconv_roofline") is None


def test_result_line_carries_the_contract_keys_and_the_check_last(tmp_path):
    result = {"correct": True, "attempted": 64, "failed": 0, "metrics": {"setup_s": {"value": 1.0, "unit": "s"}},
              "check": {"score_gap": {"value": 0.1, "limit": 0.5}}, "checked_frames": 4, "memory_peak_bytes": 7}
    card = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    line = run.result_line(result, card)
    assert list(line) == CONTRACT + ["check"]
    assert line["device"]["memory_peak_bytes"] == 7
    result["trace"] = fake_trace(tmp_path / "t.json")
    line = run.result_line(result, card)
    assert list(line) == CONTRACT + ["breakdown", "check"]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes", "busy_s", "window_s"}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(line)
