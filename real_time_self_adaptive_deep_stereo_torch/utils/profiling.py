"""Profiling and tracing.

Port of ``real_time_self_adaptive_deep_stereo_tpu/utils/profiling.py``.
The reference's only introspection is wall-clock per-100-frames timing
(Stereo_Online_Adaptation.py:230-239). Here:

* :func:`trace`: a context manager over ``torch.profiler`` that writes a
  Chrome trace (``*.pt.trace.json``) under a directory, host and, where a
  card is present, device;
* :func:`summarize_trace`: that trace back into a table of time by op
  family on one track (the device's kernels by default), the tool that
  splits a frame's device time between the convolutions, the elementwise
  kernels and the port's own kernels;
* :class:`StepTimer`: rolling per-frame wall-clock stats.

``torch`` is imported inside :func:`trace` alone: the summary and the
timer are framework-free.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import re
import time
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = ["trace", "summarize_trace", "StepTimer"]

# track: the ``cat`` of the trace's complete events it counts
TRACKS: Dict[str, Tuple[str, ...]] = {
    # the device's ops, as the JAX "XLA Ops" track: kernels, copies, sets
    "kernels": ("kernel", "gpu_memcpy", "gpu_memset"),
    # whole steps on the device: ``record_function`` ranges as the device
    # ran them, as the JAX "XLA Modules" track gives whole programs
    "steps": ("gpu_user_annotation",),
    # PyTorch ops on the host (an op's nested ops are counted too)
    "host": ("cpu_op",),
}

# a CUDA kernel's name less its argument list: ``void corr_fwd_kernel<2>(float
# const*, ...)`` is ``corr_fwd_kernel<2>``, a template instance its own family
_KERNEL = re.compile(r"[\w:]*_kernel\b(<[^(]*>)?")


@contextlib.contextmanager
def trace(logdir: str) -> Iterator:
    """Capture a trace: ``with trace('/tmp/tr'): run_steps()``. Writes
    ``logdir/trace_<pid>_<ns>.pt.trace.json`` when the block ends, raised
    or not, and yields the ``torch.profiler.profile``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def _op_family(name: str) -> str:
    """The family of an event's name: a CUDA kernel's name with its
    template arguments and without its argument list; any other name less
    a numbered suffix, as the JAX function folds ``fusion.12`` into
    ``fusion``."""
    m = _KERNEL.search(name)
    if m:
        return m.group(0)
    return re.sub(r"[.\d]+$", "", name)


def _trace_files(logdir: str) -> List[str]:
    if os.path.isfile(logdir):
        return [logdir]
    return sorted(
        glob.glob(f"{logdir}/**/*.pt.trace.json", recursive=True)
        + glob.glob(f"{logdir}/**/*.pt.trace.json.gz", recursive=True)
    )


def summarize_trace(logdir: str, top: Optional[int] = 30, track: str = "kernels") -> List[Tuple[str, int, float]]:
    """Aggregate the complete events of one ``track`` (:data:`TRACKS`) of
    every trace under ``logdir`` (or of the one trace file ``logdir``) by
    :func:`_op_family`.

    Only the track's own events are counted: the host's ops, the CUDA
    runtime's launches and the ``record_function`` ranges overlap the
    device's kernels in wall time and would count them twice. Pass
    ``track="steps"`` for whole-step device times instead.

    Returns ``[(name, count, total_ms)]`` sorted by total time, the first
    ``top`` (all with ``top=None``)."""
    if track not in TRACKS:
        raise ValueError(f"unknown track {track!r}; one of {sorted(TRACKS)}")
    cats = TRACKS[track]
    agg: Dict[str, List[float]] = {}
    for path in _trace_files(logdir):
        with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as fh:
            events = json.load(fh).get("traceEvents", [])
        for e in events:
            if e.get("ph") == "X" and "dur" in e and e.get("cat") in cats:
                a = agg.setdefault(_op_family(e.get("name", "?")), [0, 0.0])
                a[0] += 1
                a[1] += float(e["dur"])
    out = sorted(((k, int(n), us / 1000.0) for k, (n, us) in agg.items()), key=lambda kv: -kv[2])
    return out if top is None else out[:top]


class StepTimer:
    """Rolling wall-clock stats for the frame loop: ``tick()`` once a
    frame; ``avg_ms`` over the last ``window`` intervals, ``fps`` over all."""

    def __init__(self, window: int = 100):
        self.window = window
        self._times: deque = deque(maxlen=window)
        self._last: Optional[float] = None
        self.total = 0.0
        self.steps = 0

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            self.total += dt
            self.steps += 1
        self._last = now

    @property
    def avg_ms(self) -> float:
        return 1000.0 * sum(self._times) / len(self._times) if self._times else 0.0

    @property
    def fps(self) -> float:
        return self.steps / self.total if self.total > 0 else 0.0
