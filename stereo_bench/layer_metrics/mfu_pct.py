"""The FLOPs the window's frames needed over the window's time and the
configuration's peak. A frame's FLOPs come from the reference at the
cell's shapes (``opcount.py``): under MAD each block's step weighted by
the frames that trained it. Layer: the model step. Moves
``frames_per_s``."""


def read(ctx):
    work = ctx.ops_of()
    if "frame" in work:
        flops = work["frame"]["flops"] * ctx.window["frames"] * ctx.cameras
    else:
        flops = sum(work[f"block{k}"]["flops"] * n for k, n in enumerate(ctx.block_counts))
    if not flops or ctx.traced is None:
        return None  # off the card there is no peak to speak of
    return 100.0 * flops / (ctx.window["seconds"] * ctx.peak(ctx.cell.config["peak"]))
