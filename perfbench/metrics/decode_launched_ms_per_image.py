"""decode_launched_ms_per_image: device milliseconds of the events the host
launched inside the program's `tcf.decode` spans in the traced window (B1 or
B2, top-K, gathers, and the mapping back to frame pixels), per image;
nothing where the window holds no such span (`spans.py`)."""

from perfbench.spans import launched_ms_per_image


def read(ctx):
    return launched_ms_per_image(ctx, "tcf.decode")
