"""Readings from which the limits of the comparison are set.

    python3 -m perfbench.calibrate --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3] [--seconds 2]

For each seed, one run of the cell as `run.py` makes it (a short window at
the cell's own load, then the same sample held to the reference). For each
control seed, the control in the program's place: the plain reference
itself with its network computed in float8 (`reference.model.fp8`), the step
below the bfloat16 that the configurations state, answering the same
frames a run's sample holds (`check_calls` calls of the pool, the same
picks), held to the float32 reference by the same numbers. One JSON line per
reading: which side, the seed, the numbers compared. The benchmark's own
runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from perfbench import check, drivers, registry, run
from perfbench.reference.detect import Detector as Reference
from perfbench.reference.model import to_device
from perfbench.weights import make_variables


def control(cell_name: str, seed: int, device, root=registry.ROOT) -> dict:
    """The control's numbers over `check_calls` calls' worth of the cell's
    frames from `seed`: the float8 reference's answers held to the float32
    reference's."""
    cell = registry.cell(cell_name, root)
    cfg, traffic = cell.config, cell.traffic
    variables = to_device(make_variables(cfg, seed, device), device)
    driver = registry.driver(traffic["entry"], root)(None, cfg, traffic, seed, device)
    ref, low = Reference(cfg, variables), Reference(cfg, variables, low=True)
    rng = np.random.default_rng(seed)
    per_frame = []
    for i in range(int(traffic["check_calls"])):
        index = i % len(driver.pool)
        call = drivers.Call(index, 0.0, 0.0, int(traffic["images_per_call"]), None)
        picks = run.picks(driver, call, traffic, rng)
        outs = {j: drivers.Detections(a.dets[:, :4], a.dets[:, 4], a.lms)
                for j, (_, a) in zip(picks, driver.answers(low, index, picks, device))}
        per_frame += driver.compare(ref, call._replace(out=outs), picks, device)
    numbers = {k: check.statistic(per_frame, k) for k in cell.limits}
    return {"check": {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()},
            "correct": check.judge(numbers, cell.limits), "checked_frames": len(per_frame),
            "check_summary": check.summary(per_frame), "attempted": 0, "metrics": {}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    todo = [("program", int(s)) for s in args.seeds.split(",") if s]
    todo += [("control", int(s)) for s in args.control_seeds.split(",") if s]
    for side, seed in todo:
        if side == "program":
            r = run.run(args.workload, seed, args.seconds, False, dev)
        else:
            r = control(args.workload, seed, dev)
        print(json.dumps({"side": side, "seed": seed, "workload": args.workload, "frames": r["checked_frames"],
                          "attempted": r["attempted"], "correct": r["correct"],
                          **{k: v["value"] for k, v in r["check"].items()},
                          "summary": r["check_summary"],
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
