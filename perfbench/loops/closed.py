"""Loop `closed`: one client sends a call, waits for its results on the
host, and sends the next, back to back. (More clients, or an open loop that
sends at a rate drawn from the seed, are other files of this folder.)"""

from __future__ import annotations

import time
from typing import List, Optional


def window(driver, seconds: float, sample, traffic: dict, calls: Optional[int] = None, first: int = 0) -> List:
    """Calls from input `first` on until `seconds` have passed (or, where
    `calls` is given, that many calls); each call's (start, end, images),
    its results offered to `sample`."""
    if traffic.get("clients", 1) != 1:
        raise ValueError(f"loop 'closed' runs one client, not {traffic['clients']}")
    out = []
    start = time.perf_counter()
    i = first
    while (len(out) < calls) if calls is not None else (not out or out[-1].end - start < seconds):
        c = driver.call(i)
        sample.offer(c)
        out.append(c._replace(out=None))
        i += 1
    return out
