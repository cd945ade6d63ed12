"""mbconv_roofline: the fused MBConv kernel's (B3's) share of its roofline,
in %: the floors of the blocks it ran in the traced window (operations at
the bf16 peak or bytes at the HBM rate, the larger, each launch apart) over
the device time of its launches.

Which blocks it ran is read from the trace, not from the program's rule:
its launches are grouped by the forward that issued them (`trace.
launches_by_forward`: the forward's rows and input size from its stem's
recorded shape), and a forward's n launches are taken as the first n of the
network's stride-1 blocks (`work.stride1_blocks`), the blocks the kernel
fuses, from the first on, as it gives up on the deep, narrow maps first.
Nothing where the trace holds no launch, a launch it cannot place, or more
launches in a forward than there are stride-1 blocks."""

from perfbench.trace import MBCONV_KERNEL
from perfbench.work import stride1_blocks


def read(ctx):
    if ctx.trace is None:
        return None
    groups = ctx.trace.launches_by_forward(MBCONV_KERNEL)
    if not groups:
        return None
    floor_s = device_s = 0.0
    for fwd, launches in groups:
        work = stride1_blocks(ctx.config, fwd.height, fwd.width, fwd.rows)
        if len(launches) > len(work):
            return None
        floor_s += sum(b.floor_s() for b in work[:len(launches)])
        device_s += sum(e.end - e.start for e in launches) / 1e6
    return 100.0 * floor_s / device_s
