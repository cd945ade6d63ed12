"""The span readers (`spans.py`, `metrics/*_launched_*`, `metrics/*_idle_*`)
on a synthetic Chrome trace whose launched and idle times are known by
hand, their silence where the program opened no span, and a traced run of
the harness on the CPU that finds the program's spans."""

import json
from types import SimpleNamespace

import pytest
from pytest import approx

from perfbench import registry, spans
from perfbench.tests.pb_helpers import cpu, tiny_copy
from perfbench.tests.test_perfbench_result import fake_trace
from perfbench.trace import read_trace

BENCH = registry.load_benchmark()
NEW = [m["name"] for m in BENCH["per_layer"] if "_launched_" in m["name"] or "_idle_" in m["name"]]


def span_trace(path, tta=False):
    """Window [100, 1100] us on thread 1. A batch call's spans stage [100, 200],
    preprocess [200, 250], forward [250, 400] (a work range inside),
    decode [400, 450], results [450, 700], and a stage span before the
    window; with `tta`, pad [700, 720] and merge [1000, 1050]. Launches
    (host time, correlation id) and the device events they made:
        150 (1) copy [170, 240]   210 (2) [240, 260]   260 (3) [260, 380]
        300 (4) [380, 430]        420 (5) [430, 440]   460 (6) copy [460, 480]
        800 (7) [900, 950], launched inside no span.
    Busy [170, 440], [460, 480], [900, 950]; idle [100, 170], [440, 460],
    [480, 900], [950, 1100]."""
    def ev(name, cat, ts, dur, tid=1, **args):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid, "args": args}

    events = [
        ev("perfbench::window", "user_annotation", 100, 1000),
        ev("tcf.stage", "user_annotation", 0, 50),
        ev("tcf.stage", "user_annotation", 100, 100),
        ev("tcf.preprocess", "user_annotation", 200, 50),
        ev("tcf.forward", "user_annotation", 250, 150),
        ev("tcf::mbconv flops=1 bytes=2", "user_annotation", 255, 100),
        ev("tcf.decode", "user_annotation", 400, 50),
        ev("tcf.results", "user_annotation", 450, 250),
        ev("aten::sum", "cpu_op", 720, 180),
    ]
    if tta:
        events += [ev("tcf.tta.pad", "user_annotation", 700, 20), ev("tcf.tta.merge", "user_annotation", 1000, 50)]
    for t, corr in ((150, 1), (210, 2), (260, 3), (300, 4), (420, 5), (460, 6), (800, 7)):
        events.append(ev("cudaLaunchKernel", "cuda_runtime", t, 5, correlation=corr))
    for name, s, e, corr in (("Memcpy HtoD (Pageable -> Device)", 170, 240, 1), ("normalize", 240, 260, 2),
                             ("conv_a", 260, 380, 3), ("conv_b", 380, 430, 4), ("topk", 430, 440, 5),
                             ("Memcpy DtoH (Device -> Pageable)", 460, 480, 6), ("late", 900, 950, 7)):
        cat = "gpu_memcpy" if name.startswith("Memcpy") else "kernel"
        events.append(ev(name, cat, s, e - s, tid=7, correlation=corr))
    path.write_text(json.dumps({"traceEvents": events}))
    return read_trace(str(path))


def _read(tr, images=2):
    ctx = SimpleNamespace(trace=tr, images=images)
    return lambda m: registry.reader(m)(ctx)


def test_batch_span_readers_by_hand(tmp_path):
    read = _read(span_trace(tmp_path / "t.json"))
    per_ms = 1e-3 / 2  # us of device time -> ms per image, two images
    assert read("preprocess_launched_ms_per_image") == approx(20 * per_ms)
    assert read("forward_launched_ms_per_image") == approx((120 + 50) * per_ms)
    assert read("decode_launched_ms_per_image") == approx(10 * per_ms)
    assert read("stage_idle_ms_per_image") == approx(70 * per_ms)  # [100, 170]: the span before the window is out
    assert read("results_idle_ms_per_image") == approx((10 + 220) * per_ms)
    for m in ("preprocess_launched", "forward_launched", "decode_launched", "stage_idle", "results_idle"):
        assert read(f"{m}_ms_per_image.tta") == read(f"{m}_ms_per_image")
    assert read("assemble_idle_ms_per_image.tta") is None and read("merge_idle_ms_per_image.tta") is None


def test_tta_span_readers_by_hand(tmp_path):
    read = _read(span_trace(tmp_path / "t.json", tta=True), images=4)
    assert read("assemble_idle_ms_per_image.tta") == approx(20 * 1e-3 / 4)
    assert read("merge_idle_ms_per_image.tta") == approx(50 * 1e-3 / 4)
    assert read("stage_idle_ms_per_image.tta") == approx(70 * 1e-3 / 4)


def test_every_span_reader_reads_nothing_without_its_span(tmp_path):
    """A program that opens no span (a port older than the spans): every
    span metric is left out, never 0; so is an untraced run."""
    assert len(NEW) == 12
    bare = fake_trace(tmp_path / "bare.json")
    for tr in (bare, None):
        read = _read(tr)
        assert {m: read(m) for m in NEW} == {m: None for m in NEW}


def test_interval_helpers():
    assert spans.union([(5, 7), (0, 2), (1, 3), (7, 8), (9, 9)]) == [(0, 3), (5, 8)]
    assert spans.subtract([(0, 10), (20, 30)], [(2, 4), (8, 22), (25, 26)]) == [(0, 2), (4, 8), (22, 25), (26, 30)]
    assert spans.subtract([(0, 10)], []) == [(0, 10)] and spans.subtract([], [(0, 1)]) == []
    assert spans.overlap_s([(0, 10), (20, 30)], [(5, 25)]) == approx(10e-6)
    assert spans.is_span("tcf.tta.merge") and not spans.is_span("tcf::mbconv flops=1 bytes=2")


def test_summary_puts_the_idle_down_to_spans_and_checks_the_clock(tmp_path):
    tr = span_trace(tmp_path / "t.json", tta=True)
    s = spans.summary(tr)
    assert s["idle_s"] == approx((70 + 20 + 420 + 150) * 1e-6)
    assert set(s["spans"]) == {"tcf.stage", "tcf.preprocess", "tcf.forward", "tcf.decode", "tcf.results",
                               "tcf.tta.pad", "tcf.tta.merge"}
    assert s["spans"]["tcf.stage"]["count"] == 1 and s["spans"]["tcf.forward"]["launched_s"] == approx(170e-6)
    # idle in no span: [720, 900], [950, 1000], [1050, 1100]
    assert s["unspanned_idle_s"] == approx(280e-6)
    assert s["unspanned_idle_share"] == approx(280 / 660)
    assert s["unspanned_idle_longest"][0][:2] == ["aten::sum", approx(180e-6)]
    assert s["unspanned_idle_longest"][1][0] == "after aten::sum; before tcf.tta.merge"  # [950, 1000]
    assert s["spans"]["tcf.preprocess"]["lead_us"] == approx(-30.0)
    assert s["launch_lead_us"] == approx(0.0)  # launch 260 and 460 start at once on the device
    assert s["results_overrun_us"] == approx(480 - 700)


@pytest.mark.parametrize("cell", ["centerface-mbv2.batch32-640", "centerface-mbv2.wider-tta"])
def test_a_traced_run_finds_the_programs_spans(cell, tmp_path):
    """The harness's traced run on the CPU at the tiny traffic: every span
    metric of the cell reads a number (no device there: launched 0, and the
    whole window idle), and the window's spans take in most of it."""
    root = tiny_copy(tmp_path)
    c = registry.cell(cell, root)
    r = spans.report(cell, 11, cpu(), root=root, cost=True)
    mine = [m["name"] for m in c.per_layer if m["name"] in NEW]
    assert len(mine) == (7 if cell.endswith("tta") else 5)
    assert all(r["metrics"][m] >= 0 for m in mine), r["metrics"]
    assert r["correct"] and r["calls"] == c.traffic["trace_calls"]
    assert "tcf.build" not in r["spans"] and r["spans"]["tcf.forward"]["count"] >= r["calls"]
    assert r["unspanned_idle_share"] < 0.5
    assert 0 < r["span_cost"]["off_us"] < r["span_cost"]["on_us"]
