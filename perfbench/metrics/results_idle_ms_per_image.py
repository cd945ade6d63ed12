"""results_idle_ms_per_image: milliseconds of the traced window with nothing on
the device inside the program's `tcf.results` spans (fetching a launch's
outputs and thresholding them on the host), per image; nothing where the
window holds no such span (`spans.py`)."""

from perfbench.spans import idle_ms_per_image


def read(ctx):
    return idle_ms_per_image(ctx, "tcf.results")
