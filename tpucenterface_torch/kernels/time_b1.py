"""Time B1 (`csrc/nms.cu`) on one CUDA card, beside another checkout's:

    python3 -m tpucenterface_torch.kernels.time_b1
    python3 -m tpucenterface_torch.kernels.time_b1 --against DIR

At (32, 160, 160) (a landmark model's heat map at bs32 @ 640), (4, 80, 80)
and (1, 256, 256), on 3*randn logits from a seed, it holds
`sigmoid_pseudo_nms_fused` bit-equal to `sigmoid_pseudo_nms_plain` and
prints one JSON line: one call between CUDA events (the wrapper's host time
included) and the device time a call (calls back to back in a CUDA graph),
a shape each. With `--against DIR` (a checkout of another commit, e.g. the
parent's) it runs the same in DIR's package and in this one, each in its own
process, in turns (DIR, this, this, DIR), and prints a line for each run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from tpucenterface_torch.decode.fused_nms import sigmoid_pseudo_nms_fused, sigmoid_pseudo_nms_plain
from tpucenterface_torch.kernels.sweep_b2 import _graph_ms, _one_call_ms

SHAPES = ((32, 160, 160), (4, 80, 80), (1, 256, 256))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def times():
    """[{"shape", "one_call_ms", "device_ms"}] of the imported package's B1."""
    gen = torch.Generator().manual_seed(5)
    out = []
    for shape in SHAPES:
        hm = (3.0 * torch.randn(*shape, generator=gen)).cuda()
        if not torch.equal(sigmoid_pseudo_nms_fused(hm), sigmoid_pseudo_nms_plain(hm)):
            raise AssertionError(f"B1 differs from its plain version at {shape}")
        call = lambda: sigmoid_pseudo_nms_fused(hm)  # noqa: E731
        out.append({"shape": list(shape), "one_call_ms": _one_call_ms(call), "device_ms": _graph_ms(call)})
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", help="a checkout of another commit whose B1 to time in turns with this one's")
    parser.add_argument("--times", action="store_true", help="print times() of the imported package")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_b1 needs a CUDA card")
    if not opts.against:
        print(json.dumps(times() if opts.times else {"root": ROOT, "times": times()}), flush=True)
        return 0
    other = os.path.abspath(opts.against)
    for name, root in (("against", other), ("this", ROOT), ("this", ROOT), ("against", other)):
        # this file as a script, on `root`'s package (its timing helpers are sweep_b2's, in both)
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--times"], cwd=root,
                           capture_output=True, text=True, env={**os.environ, "PYTHONPATH": root})
        if r.returncode != 0:
            raise RuntimeError(f"timing B1 of {root} failed:\n{r.stdout}{r.stderr}")
        print(json.dumps({"wrapper": name, "root": root, "times": json.loads(r.stdout.strip().splitlines()[-1])}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
