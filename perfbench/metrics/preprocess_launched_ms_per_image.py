"""preprocess_launched_ms_per_image: device milliseconds of the events the
host launched inside the program's `tcf.preprocess` spans in the traced
window (the normalize or the letterbox, and the flip's mirror), per image;
nothing where the window holds no such span (`spans.py`)."""

from perfbench.spans import launched_ms_per_image


def read(ctx):
    return launched_ms_per_image(ctx, "tcf.preprocess")
