"""95th percentile over the step calls of the spans stretch (``spans.py``)
of the device's time at the tracer's first event of a call less the host
time it was enqueued, on the calibrated clock: how long a frame's first
device work waited behind the frames before it. Layer: the session.
Moves ``disp_p95_ms``."""

from stereo_bench import spans


def read(ctx):
    rec = spans.record(ctx)
    return None if rec is None else spans.queue_wait_ms(rec)
