"""Host ms a frame inside ``step`` and ``fetch_disp`` over the measured
window (the staging-event wait included), timed by the harness before
the profiler opens. Layer: the session. Moves ``disp_p95_ms``."""


def read(ctx):
    issue = ctx.window["issue"]
    return 1e3 * sum(issue) / len(issue) if issue else None
