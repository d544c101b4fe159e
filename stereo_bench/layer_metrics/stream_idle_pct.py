"""Share of the spans stretch (``spans.py``), from the first call's first
event to the last call's last, in which the session's stream had nothing
to run, untraced by any profiler: the gaps from a call's event after its
disparity's copy to the next call's event before its upload, and the
waits inside a call for the host (``spans.idle_gaps``). Layer: the
device. Moves ``frames_per_s``."""

from stereo_bench import spans


def read(ctx):
    rec = spans.record(ctx)
    return None if rec is None else spans.stream_idle_pct(rec)
