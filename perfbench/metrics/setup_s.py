"""setup_s: seconds from the start of the process to the first timed call:
imports, the kernels from the checkout's build cache, weights and frames
from the seed, the Detector, the warm-up of the cell's shapes."""


def read(ctx):
    return ctx.setup_s
