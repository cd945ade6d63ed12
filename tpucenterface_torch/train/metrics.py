"""Metrics logging: TensorBoard when `tensorboardX` is installed, printing
always.

Mirrors `tpucenterface/train/metrics.py::make_logger`; the loop only sees a
`log_fn(step, metrics)` callable either way.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, Optional


def make_logger(
    workdir: Optional[str] = None, use_tensorboard: bool = True
) -> Callable[[int, Dict[str, float]], None]:
    writer = None
    if workdir and use_tensorboard:
        try:
            from tensorboardX import SummaryWriter

            writer = SummaryWriter(logdir=workdir)
        except (ImportError, OSError):
            writer = None

    def log(step: int, metrics: Dict[str, float]) -> None:
        if writer is not None:
            for k, v in metrics.items():
                writer.add_scalar(k, v, step)
        print(f"[step {step}] " + json.dumps({k: round(v, 4) for k, v in metrics.items()}))

    return log
