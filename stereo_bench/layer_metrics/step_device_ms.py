"""Mean device ms a step call of the launch alone (the graph, or the
switch's parent) in the spans stretch (``spans.py``): the tracer's event
after the launch less the one right before it. Layer: the model step.
Moves ``frames_per_s``."""

from stereo_bench import spans


def read(ctx):
    rec = spans.record(ctx)
    return None if rec is None else spans.step_device_ms(rec)
