"""The image and feature warps' share of their roofline (``csrc/warp*.cu``
via ``ops/warp_kernels.py``). Layer: the kernels. Moves ``frames_per_s``."""

from stereo_bench.layer_metrics._roofline import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "warp")
