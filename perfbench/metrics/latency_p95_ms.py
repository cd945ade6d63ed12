"""latency_p95_ms: the 95th percentile (linear interpolation) over every
call of the window of the time from sending the call to its results on the
host, in milliseconds."""

import numpy as np


def read(ctx):
    if ctx.trace is not None or not ctx.calls:
        return None
    return float(np.percentile([c.end - c.start for c in ctx.calls], 95)) * 1e3
