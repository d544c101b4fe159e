"""Device kernels a camera frame in the traced stretch. Layer: the
session. Moves ``frames_per_s``."""


def read(ctx):
    if ctx.traced is None:
        return None
    return ctx.traced["kernels"] / (ctx.traced["frames"] * ctx.cameras)
