"""Mean device ms a step call of the frame's upload in the spans stretch
(``spans.py``): the tracer's event after the upload's copies less the one
before them, on the session's stream. Layer: the session. Moves
``frames_per_s``."""

from stereo_bench import spans


def read(ctx):
    rec = spans.record(ctx)
    return None if rec is None else spans.upload_device_ms(rec)
