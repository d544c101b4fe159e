"""Mean host ms a step call inside the program's ``fused.load_frame`` span
in the spans stretch (``spans.py``): the staging-event wait, the copy into
the pinned staging buffer and the upload's enqueue; None off the card,
where no frame is staged. Layer: the session. Moves ``disp_p95_ms``."""

from stereo_bench import spans


def read(ctx):
    rec = spans.record(ctx)
    return None if rec is None else spans.stage_host_ms(rec)
