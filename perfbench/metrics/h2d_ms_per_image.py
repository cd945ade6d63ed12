"""h2d_ms_per_image: device milliseconds of the host-to-device copies
(`Memcpy HtoD` events) in the traced window, per image sent."""


def read(ctx):
    if ctx.trace is None or not ctx.images:
        return None
    s = ctx.trace.device_s(lambda name: name.startswith("Memcpy HtoD"))
    return s * 1e3 / ctx.images if s > 0 else None
