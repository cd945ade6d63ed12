"""elementwise_ms_per_image: device milliseconds of elementwise kernels
(vectorized and strided: cuDNN's bias add, the clamps, casts and adds) in
the traced window, per image."""

from perfbench.trace import kernel_category


def read(ctx):
    if ctx.trace is None or not ctx.images:
        return None
    s = ctx.trace.device_s(lambda name: kernel_category(name) in ("elementwise", "strided elementwise"))
    return s * 1e3 / ctx.images if s > 0 else None
