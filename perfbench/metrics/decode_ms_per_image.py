"""decode_ms_per_image: device milliseconds of the decode in the traced
window, per image: the kernels that the frozen categories call decode (the
port's B1 and B2), sort (top-K) or index (gathers)."""

from perfbench.trace import kernel_category


def read(ctx):
    if ctx.trace is None or not ctx.images:
        return None
    s = ctx.trace.device_s(lambda name: kernel_category(name) in ("decode", "sort", "index"))
    return s * 1e3 / ctx.images if s > 0 else None
