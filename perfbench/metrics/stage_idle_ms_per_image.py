"""stage_idle_ms_per_image: milliseconds of the traced window with nothing on
the device inside the program's `tcf.stage` spans (the host's half of a
launch's copy, which `h2d_ms_per_image` cannot see), per image; nothing
where the window holds no such span (`spans.py`)."""

from perfbench.spans import idle_ms_per_image


def read(ctx):
    return idle_ms_per_image(ctx, "tcf.stage")
