"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: top-level module names compared
whole, since `tpucenterface_torch` begins with `tpucenterface`."""

import json
import subprocess
import sys

from perfbench.tests.pb_helpers import ROOT

PROBE = """
import json, sys
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(body=body)], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program_or_jax():
    """Every module of `reference/`, every architecture's among them, and
    the yardstick around it."""
    refs = sorted(p.stem for p in (ROOT / "perfbench" / "reference").glob("*.py") if p.stem != "__init__")
    assert {"detect", "model", "mobilenetv2"} <= set(refs)
    mods = loaded("import importlib, perfbench.check, perfbench.work, perfbench.weights, perfbench.frames, "
                  f"perfbench.trace\nfor m in {refs!r}: importlib.import_module('perfbench.reference.' + m)")
    assert not mods & {"jax", "jaxlib", "flax", "tpucenterface", "tpucenterface_torch"}


def test_a_run_loads_the_port_and_no_jax(tmp_path):
    from perfbench.tests.pb_helpers import tiny_copy

    root = tiny_copy(tmp_path)
    mods = loaded(f"""
import torch; torch.set_num_threads(2)
from pathlib import Path
from perfbench import run
run.run("centerface-mbv2.wider-tta", 11, 0.2, False, torch.device("cpu"), root=Path({str(root)!r}))
assert run.forbidden_modules() == []
""")
    assert "tpucenterface_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "tpucenterface"}


def test_forbidden_names_are_compared_whole():
    from perfbench import run

    assert run.forbidden_modules(["tpucenterface_torch", "tpucenterface_torch.detector", "jaxtyping"]) == []
    assert run.forbidden_modules(["tpucenterface.detector", "jax._src", "flax", "numpy"]) == [
        "flax", "jax", "tpucenterface"]
