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
* :class:`StepTimer`: rolling per-frame wall-clock stats;
* :data:`tracer`, the one :class:`Tracer` of the process: host spans,
  counters and CUDA-event ranges of the fused session's step calls,
  recorded without the profiler. Off by default; ``tracer.start()`` and
  ``tracer.stop()`` around the frames to look at, ``stop`` returning the
  record.

``torch`` is imported inside :func:`trace` and :meth:`Tracer.start`
alone: the summary, the timer and an idle tracer are framework-free.
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

__all__ = ["trace", "summarize_trace", "StepTimer", "Tracer", "tracer", "COUNTERS", "MARKS"]

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


# what the fused session counts while the tracer is on
COUNTERS = (
    "steps",  # step calls
    "replays",  # graph replays and switch launches
    "eager_steps",  # steps run eagerly: without graphs, or a branch's first use
    "captures",  # graphs captured
    "staged_bytes",  # frame bytes uploaded through the pinned staging buffers
    "fetched_bytes",  # disparity bytes copied to the host by fetch_disp
)
# a step call's device marks, in stream order: before and after the frame's
# upload, after the pick's device ops (right before the launch), after the
# launch, after the disparity's copy to the host
MARKS = ("upload", "uploaded", "picked", "launched", "fetched")
RANGES = 1024  # the pool's slots: step calls in flight; an older range is read back before its slot is reused
MAX_TAGS = 32  # block ids kept a range: one per stream and trained block


class _Span:
    """An open span of a :class:`Tracer`: a row ``[name, frame, parent,
    start_ns, end_ns]`` of its spans, and, while a ``torch.profiler`` is
    recording, a ``record_function`` range of the same name inside it."""

    __slots__ = ("spans", "stack", "row", "fn")

    def __init__(self, tracer: "Tracer", name: str, frame: Optional[int]):
        self.spans, self.stack = tracer._spans, tracer._stack
        self.row = [name, frame, -1, 0, 0]
        self.fn = tracer._record_function(name) if tracer._profiler_enabled() else None

    def __enter__(self) -> "_Span":
        self.row[2] = self.stack[-1] if self.stack else -1
        self.stack.append(len(self.spans))
        self.spans.append(self.row)
        self.row[3] = time.perf_counter_ns()
        if self.fn is not None:
            self.fn.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self.fn is not None:
            self.fn.__exit__(*exc)
        self.row[4] = time.perf_counter_ns()
        self.stack.pop()
        return False


class Tracer:
    """Spans, counters and device ranges of the fused session's step calls,
    measured without the profiler (:data:`tracer` is the process's one).

    Off (``on`` false) a site in the session reads ``on`` and does nothing
    else: no allocation, no lock, no CUDA call. Between :meth:`start` and
    :meth:`stop` it keeps in memory:

    * spans: ``[name, frame, parent, start_ns, end_ns]`` on
      ``time.perf_counter_ns``, ``frame`` the session's step count
      (shared by every span and range of one step call), ``parent`` the
      index of the enclosing span (-1 at the root); each span also opens a
      ``record_function`` range while a ``torch.profiler`` records, so an
      exported Chrome trace shows them beside the kernels;
    * counters (:data:`COUNTERS`);
    * on a CUDA device, a range a step call: ``torch.cuda.Event`` timing
      events at the marks of :data:`MARKS`, recorded on the session's
      stream at host level (never inside a graph capture) from a pool
      allocated at :meth:`start` and recycled, each with the host time it
      was enqueued, and under MAD a device copy of the block ids the
      launch reads. :meth:`start` and :meth:`stop` each time a reference
      event against the host clock after a ``synchronize``; the events'
      times are mapped onto ``perf_counter_ns`` between the two, so spans
      and ranges share one clock.

    The record is for one host thread driving the sessions."""

    def __init__(self):
        self.on = False
        self._events: List[List] = []  # the pool: a row of MARKS events a slot
        self._tags = None  # [slots, MAX_TAGS] int32 on the device
        self._device = None
        self._spans: List[List] = []
        self._stack: List[int] = []
        self._ranges: Dict[int, Dict] = {}
        self._handles = 0  # range handles, never reused: a stale one finds no range

    # ------------------------------------------------------------- on / off
    def start(self, device=None) -> None:
        """Start recording. ``device``: the CUDA device whose step calls get
        device ranges (default: the current one, where a card is present;
        ``"cpu"``: none)."""
        if self.on:
            raise RuntimeError("the tracer is already on")
        import torch

        self._torch = torch
        self._profiler_enabled = torch._C._autograd._profiler_enabled
        self._record_function = torch.profiler.record_function
        self._spans, self._stack = [], []
        self._counters = dict.fromkeys(COUNTERS, 0)
        self._ranges = {}
        dev = torch.device(device) if device is not None else None
        if dev is None and torch.cuda.is_available():
            dev = torch.device("cuda")
        self._device = None
        if dev is not None and dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)
            self._allocate(dev)
            self._owner: List[Optional[int]] = [None] * len(self._events)
            self._device = dev
            self._ref = self._reference()
        self._t0 = time.perf_counter_ns()
        self.on = True

    def stop(self) -> Dict:
        """Stop recording and return the record: ``spans`` (closed ones,
        as lists ``[name, frame, parent, start_ns, end_ns]``),
        ``counters``, ``marks`` (:data:`MARKS`), ``ranges`` (one a step
        call on the card: ``frame``, ``enqueued`` and ``device``, the host
        ns each mark was enqueued and the calibrated ns the device reached
        it, None where not recorded, and ``tags``, the block ids or None),
        ``clock`` (``uncertainty_ns`` and ``drift_ppm`` of the mapping; None
        off the card), ``device``, ``start_ns`` and ``stop_ns``. Waits for
        the device."""
        if not self.on:
            raise RuntimeError("the tracer is not on")
        self.on = False
        t1 = time.perf_counter_ns()
        ranges, clock = [], None
        if self._device is not None:
            torch = self._torch
            torch.cuda.synchronize(self._device)
            for i in self._owner:
                if i is not None:
                    self._read_back(i)
            h1, u1, ref1 = self._ref
            h2, u2, ref2 = self._reference()
            ms = ref1.elapsed_time(ref2)
            scale = (h2 - h1) / (ms * 1e6) if ms > 0 else 1.0
            for r in self._ranges.values():
                ranges.append({
                    "frame": r["frame"],
                    "enqueued": r["enqueued"],
                    "device": [None if d is None else h1 + d * 1e6 * scale for d in r["device_ms"]],
                    "tags": r["tags"],
                })
            clock = {"uncertainty_ns": max(u1, u2), "drift_ppm": (scale - 1.0) * 1e6}
        spans, self._spans, self._stack, self._ranges = self._spans, [], [], {}
        return {
            "spans": [s for s in spans if s[4]],
            "counters": dict(self._counters),
            "marks": list(MARKS),
            "ranges": ranges,
            "clock": clock,
            "device": None if self._device is None else self._torch.cuda.get_device_name(self._device),
            "start_ns": self._t0,
            "stop_ns": t1,
        }

    # ---------------------------------------------------------------- sites
    def span(self, name: str, frame: Optional[int] = None) -> _Span:
        """A context manager: a span of ``name`` for step call ``frame``,
        nested in the span open around it. Call while on."""
        return _Span(self, name, frame)

    def count(self, name: str, n: int = 1) -> None:
        self._counters[name] += n

    def open_range(self, frame: int, device) -> Optional[int]:
        """A device range for step call ``frame`` of a session on ``device``
        (None where the tracer times no such device)."""
        torch = self._torch
        if self._device is None or device.type != "cuda":
            return None
        if (torch.cuda.current_device() if device.index is None else device.index) != self._device.index:
            return None
        i = self._handles
        self._handles += 1
        slot = i % len(self._events)
        if self._owner[slot] is not None:
            self._read_back(self._owner[slot])
        self._owner[slot] = i
        self._ranges[i] = {"frame": frame, "slot": slot, "enqueued": [None] * len(MARKS),
                           "device_ms": [None] * len(MARKS), "ntags": 0, "tags": None}
        return i

    def mark(self, i: Optional[int], k: int) -> None:
        """Record mark ``k`` of range ``i`` on the device's current stream."""
        r = self._ranges.get(i)
        if r is None or self._owner[r["slot"]] != i or self._torch.cuda.is_current_stream_capturing():
            return  # no range of this start, or read back already
        stream = self._torch.cuda.current_stream(self._device)
        r["enqueued"][k] = time.perf_counter_ns()
        self._events[r["slot"]][k].record(stream)

    def tag(self, i: Optional[int], ids) -> None:
        """Copy the int32 block ids ``ids`` (a device tensor), as the
        device holds them when the stream reaches this point, into range
        ``i``'s row of the tag ring."""
        r = self._ranges.get(i)
        if r is None or self._owner[r["slot"]] != i or self._torch.cuda.is_current_stream_capturing():
            return
        flat = ids.reshape(-1)
        n = min(flat.numel(), MAX_TAGS)
        self._tags[r["slot"], :n].copy_(flat[:n])
        r["ntags"] = n

    # ------------------------------------------------------------- internal
    def _allocate(self, dev) -> None:
        """The pool: :data:`RANGES` rows of timing events, each recorded once
        on the stream so that it exists before any step call records it,
        and the tag ring; kept from one start to the next on the same
        device."""
        torch = self._torch
        slots = RANGES
        if self._tags is not None and self._tags.device == dev and len(self._events) == slots:
            return
        stream = torch.cuda.current_stream(dev)
        self._events = [[torch.cuda.Event(enable_timing=True) for _ in MARKS] for _ in range(slots)]
        for row in self._events:
            for e in row:
                e.record(stream)
        self._tags = torch.full((slots, MAX_TAGS), -1, dtype=torch.int32, device=dev)
        torch.cuda.synchronize(dev)

    def _reference(self) -> Tuple[int, int, object]:
        """A timing event recorded on an idle device, with the host ns it
        maps to (the middle of the tightest of five record-and-wait
        windows) and half that window's width, the mapping's uncertainty."""
        torch = self._torch
        stream = torch.cuda.current_stream(self._device)
        best = None
        for _ in range(5):
            ev = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(self._device)
            a = time.perf_counter_ns()
            ev.record(stream)
            ev.synchronize()
            b = time.perf_counter_ns()
            if best is None or b - a < 2 * best[1]:
                best = ((a + b) // 2, (b - a + 1) // 2, ev)
        return best

    def _read_back(self, i: int) -> None:
        """Range ``i``'s event times (ms after the start's reference) and
        block ids, waiting for its last mark; frees its slot."""
        r = self._ranges[i]
        row = self._events[r["slot"]]
        done = [k for k, h in enumerate(r["enqueued"]) if h is not None]
        if done:
            row[done[-1]].synchronize()  # the marks run in stream order
        ref = self._ref[2]
        r["device_ms"] = [ref.elapsed_time(row[k]) if k in done else None for k in range(len(MARKS))]
        if r["ntags"]:
            r["tags"] = self._tags[r["slot"], : r["ntags"]].tolist()
        self._owner[r["slot"]] = None


# the process's tracer: the fused session's sites read it
tracer = Tracer()
