"""assemble_idle_ms_per_image.tta: milliseconds of the traced window with
nothing on the device inside the TTA runner's `tcf.tta.pad` and
`tcf.tta.assemble` spans (padding the frames to their shapes, picking their
buckets, and copying each chunk's frames into its batch on the host), per
image; nothing where the window holds no such span (`spans.py`)."""

from perfbench.spans import idle_ms_per_image


def read(ctx):
    return idle_ms_per_image(ctx, ("tcf.tta.pad", "tcf.tta.assemble"))
