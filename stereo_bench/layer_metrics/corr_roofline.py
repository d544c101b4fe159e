"""The correlation kernels' share of their roofline (``csrc/correlation.cu``
via ``ops/correlation.py``). Layer: the kernels. Moves ``frames_per_s``."""

from stereo_bench.layer_metrics._roofline import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "corr")
