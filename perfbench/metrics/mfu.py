"""mfu: the whole step's share of the card's bf16 peak, in %: the
operations of the forwards that the traced window's images need (`work.
forward_flops` at each size an image runs, twice where it is mirrored;
padding rows not counted) over the window's time at 989 TFLOP/s."""

from perfbench.work import PEAK_BF16_FLOPS


def read(ctx):
    if ctx.trace is None or not ctx.flops:
        return None
    return 100.0 * ctx.flops / (ctx.trace.window_s * PEAK_BF16_FLOPS)
