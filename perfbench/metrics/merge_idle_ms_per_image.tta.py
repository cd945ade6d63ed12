"""merge_idle_ms_per_image.tta: milliseconds of the traced window with nothing
on the device inside the TTA runner's `tcf.tta.merge` span (the host's NMS
merge of every frame's variants), per image; nothing where the window holds
no such span (`spans.py`)."""

from perfbench.spans import idle_ms_per_image


def read(ctx):
    return idle_ms_per_image(ctx, "tcf.tta.merge")
