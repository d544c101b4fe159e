"""Shared by the ``<op>_roofline`` readers: the least time of the
op's calls in the traced stretch (``rooflines/``: the larger of the
operations over the configuration's peak and the bytes over the memory's)
over the device time of the kernels that ``kernel_names/`` attributes to
the op. None where no such kernel ran."""

from stereo_bench import rooflines


def roofline_pct(ctx, op: str):
    spent = ctx.device_seconds(op)
    if not spent:
        return None
    flops_peak, bytes_peak = ctx.peak(ctx.cell.config["peak"]), ctx.peak("hbm")
    least = 0.0
    for kind, n in ctx.traced_work().items():
        for record in ctx.ops_of()[kind]["ops"]:
            if record[0].startswith(op + "_"):
                least += n * rooflines.least_seconds(record, flops_peak, bytes_peak)
    return 100.0 * least / spent
