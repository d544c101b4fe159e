"""Device ms a camera frame of PyTorch's own kernels (elementwise, reduce,
copy, pad, cat; ``kernel_names/`` op ``elementwise``) in the traced
stretch. Layer: the model step. Moves ``frames_per_s``."""


def read(ctx):
    s = ctx.device_seconds("elementwise")
    return None if s is None else 1e3 * s / (ctx.traced["frames"] * ctx.cameras)
