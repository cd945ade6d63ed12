"""forward_launched_ms_per_image: device milliseconds of the events the host
launched inside the program's `tcf.forward` spans in the traced window (the
whole forward: B3, cuDNN, the library ops), per image; nothing where the
window holds no such span (`spans.py`)."""

from perfbench.spans import launched_ms_per_image


def read(ctx):
    return launched_ms_per_image(ctx, "tcf.forward")
