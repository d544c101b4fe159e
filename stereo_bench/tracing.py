"""The traced stretch and what the per-layer readers read.

``traced_stretch`` runs the cell's ``trace_frames`` more frames of the same
loop under ``torch.profiler`` at the end of the window (a profiler window
slows a conditional node's bodies for the rest of the process, so it
opens only once the measured window has closed), with the harness's own
spans around the calls into the session (``step``, ``fetch_disp``,
``materialize``), and reads its Chrome trace back: the device's ops
(kernels, copies, sets) by family, their union (``busy_s``), the
stretch's length (``window_s``), and the idle gaps with what the host was
doing. The trace is written under the temporary directory and deleted.

``Context`` is what a reader of ``layer_metrics/`` gets: the cell, the
build, the window's timings and block counts, the traced stretch, and the
op counts of a frame from the reference (``ops_of``).
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Dict, List, Optional

import torch

# a CUDA kernel's name less its argument list, a template instance its own family
_KERNEL = re.compile(r"[\w:]*_kernel\b(<[^(]*>)?")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("step", "fetch_disp", "materialize")
TOP = 10
WARM_FRAMES = 4


def op_family(name: str) -> str:
    m = _KERNEL.search(name)
    if m:
        return m.group(0)
    return re.sub(r"[.\d]+$", "", name)


def _union(intervals) -> float:
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def read_trace(events: List[Dict], frames: int, t0_us: float, t1_us: float) -> Dict:
    """The traced stretch's numbers from its complete events (times in
    µs): device ops by family, busy and window seconds, idle gaps."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and "dur" in e]
    fam: Dict[str, List[float]] = {}
    for e in dev:
        a = fam.setdefault(op_family(e.get("name", "?")), [0, 0.0])
        a[0] += 1
        a[1] += e["dur"] * 1e-6
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") in SPANS and e.get("cat") == "user_annotation"]
    runtime = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"]
    iv = sorted((max(e["ts"], t0_us), min(e["ts"] + e["dur"], t1_us)) for e in dev)
    iv = [(s, e) for s, e in iv if e > s]
    gaps, end = [], t0_us
    for s, e in iv + [(t1_us, t1_us)]:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)

    def doing(a: float, b: float) -> str:
        mid = 0.5 * (a + b)
        over = [e["name"] for e in spans if e["ts"] <= mid <= e["ts"] + e["dur"]]
        call = [e["name"] for e in runtime if e["ts"] <= mid <= e["ts"] + e["dur"]]
        return "/".join(over[-1:] + call[-1:]) or "python"

    by_label: Dict[str, float] = {}
    for a, b in gaps:
        label = doing(a, b)
        by_label[label] = max(by_label.get(label, 0.0), (b - a) * 1e-6)
    return {
        "families": {k: (n, s) for k, (n, s) in fam.items()},
        "kernels": sum(1 for e in dev if e.get("cat") == "kernel"),
        "busy_s": _union(iv) * 1e-6,
        "window_s": (t1_us - t0_us) * 1e-6,
        "frames": frames,
        "breakdown": {
            "device_ops": [[k, s / frames] for k, (n, s) in sorted(fam.items(), key=lambda kv: -kv[1][1])[:TOP]],
            "idle_gaps": sorted(([k, v] for k, v in by_label.items()), key=lambda kv: -kv[1])[:TOP],
        },
    }


def traced_stretch(drv, frames: int, device) -> Optional[Dict]:
    """``frames`` more frames of ``drv`` under the profiler; None off the
    card (no device trace)."""
    if device.type != "cuda":
        drv.run(count=frames)
        return None
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    # a first, discarded profiler session takes CUPTI's one-time set-up
    warm = profile(activities=activities)
    warm.start()
    drv.run(count=WARM_FRAMES)
    torch.cuda.synchronize(device)
    warm.stop()
    counts0 = drv.sess.fetch_counter.clone()
    torch.cuda.synchronize(device)
    prof = profile(activities=activities)
    drv.spans = True
    prof.start()
    try:
        with torch.profiler.record_function("traced_stretch"):
            drv.run(count=frames)
        torch.cuda.synchronize(device)
    finally:
        prof.stop()
        drv.spans = False
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    (stretch,) = [e for e in events if e.get("name") == "traced_stretch" and e.get("cat") == "user_annotation"]
    out = read_trace(events, frames, stretch["ts"], stretch["ts"] + stretch["dur"])
    counts = (drv.sess.fetch_counter - counts0).cpu()
    out["block_counts"] = counts.reshape(-1, counts.shape[-1]).sum(0).tolist()
    return out


class Context:
    """What a per-layer reader reads."""

    def __init__(self, cell, build, window: Dict, counts: torch.Tensor, traced: Optional[Dict]):
        self.cell, self.build, self.window, self.traced = cell, build, window, traced
        # frames of each block trained in the window, summed over the cameras
        self.block_counts = counts.reshape(-1, counts.shape[-1]).sum(0).tolist()
        self.cameras = len(build.seeds)
        self._ops = None

    def device_seconds(self, op: str) -> Optional[float]:
        """Seconds of the traced stretch's device ops whose family matches a
        pattern of ``kernel_names/`` for ``op``; None where none ran."""
        if self.traced is None:
            return None
        pats = [re.compile(p) for p in self.cell.kernel_patterns(op)]
        hits = [s for k, (n, s) in self.traced["families"].items() if any(p.search(k) for p in pats)]
        return sum(hits) if hits else None

    def ops_of(self):
        """The reference's op counts of a frame (``opcount.frame_ops``)."""
        if self._ops is None:
            from stereo_bench import opcount

            self._ops = opcount.frame_ops(self.cell)
        return self._ops

    def traced_work(self) -> Dict[str, float]:
        """``{kind: frames}`` of the traced stretch, by the kinds of
        ``ops_of``: ``frame``, or under MAD ``block<k>``."""
        if self.cell.traffic["mode"] == "MAD":
            return {f"block{k}": float(c) for k, c in enumerate(self.traced["block_counts"])}
        return {"frame": float(self.traced["frames"] * self.cameras)}

    def peak(self, key: str) -> float:
        return float(self.cell.peaks[key]["value"])
