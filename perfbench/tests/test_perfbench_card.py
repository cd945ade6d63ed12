"""Every cell on the card, briefly, as the driver runs it: the result line
as the contract has it, `correct` true. Skips without a CUDA device.

    python3 -m pytest perfbench/tests/test_perfbench_card.py
"""

import json
import subprocess
import sys

import pytest
import torch

from perfbench.tests.pb_helpers import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_on_the_card(card, cell, trace):
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", cell, "--seed", str(2**31 + 7),
                          "--seconds", "3", "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    want = {m["name"] for m in (BENCH["per_layer"] if trace else BENCH["end_to_end"])
            if "workloads" not in m or cell in m["workloads"]}
    assert set(line["metrics"]) == want
    assert list(line)[-1] == "check"
