"""Share of the traced stretch in which no device op runs. Layer: the
device. Moves ``frames_per_s``."""


def read(ctx):
    if ctx.traced is None or not ctx.traced["window_s"]:
        return None
    return 100.0 * (1.0 - ctx.traced["busy_s"] / ctx.traced["window_s"])
