"""The spans stretch and the numbers the session's and device's readers
take from it.

The program's tracer (``utils/profiling.py``'s ``tracer``) records spans
inside the fused session, counters at the same boundaries, and on the card
a CUDA-event range a step call: marks before and after the frame's
upload, after the pick's device ops, after the launch and after the
disparity's copy, on the host's clock. The stretch is the cell's own loop
(``harness.Build`` and ``harness.FrameLoop`` from the run's seed: its
start and warm-up, then ``8 x trace_frames`` frames under the tracer) in a
process of its own, run once by the first reader that asks
(:func:`record`): the run's own process has had a profiler open by then,
and a profiler slows a conditional node's bodies for the rest of a
process, while the tracer's numbers are those of the untraced stream. So
the five numbers come from a sibling of the run, built again from the
same seed, and not from its window: ``stage_host_ms`` is not bounded by
the same line's ``host_issue_ms``. Where the program has no tracer, every
reader reads None; where the stretch fails, the reader raises.

    python3 stereo_bench/spans.py --workload NAME --seed N --frames K --out FILE [--device D] [--root DIR]

writes the tracer's record, with the stretch's frames, seconds and
latencies (``stretch``), to FILE as JSON. With ``--cost`` it writes no
record and logs the tracer's cost instead: ``K`` frames untraced, ``K``
traced and ``K`` untraced again, and the host us of the tracer's own
work a step call.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FRAMES_PER_TRACE_FRAME = 8
TIMEOUT_S = 900
UPLOAD, UPLOADED, PICKED, LAUNCHED, FETCHED = range(5)  # the tracer's marks
TOP = 10


def log(msg: str) -> None:
    print(f"stereo_bench: spans stretch: {msg}", file=sys.stderr, flush=True)


# ------------------------------------------------------------ the stretch
def _loop(name: str, seed: int, device: str, root: Optional[Path]):
    """The cell's build and loop from ``seed``, started and warmed up as the
    run's are."""
    from stereo_bench import harness
    from stereo_bench.spec import Cell

    cell = Cell(name, root)
    b = harness.Build(cell, seed, device)
    drv = harness.FrameLoop(b.sess, b.frames)
    drv.run(count=3)
    drv.run(count=2 * cell.traffic["warmup_frames"])
    harness._sync(b.device)
    return b, drv


def _frames(b, drv, frames: int, tracer=None) -> Dict:
    """``frames`` more frames of the loop, under ``tracer`` where given:
    the loop's numbers, the blocks they trained summed over the cameras,
    and the tracer's record."""
    from stereo_bench import harness

    first, before = drv.i, b.sess.fetch_counter.clone()
    if tracer is not None:
        tracer.start(b.device)
    try:
        out = drv.run(count=frames)
    finally:
        rec = tracer.stop() if tracer is not None else None
    harness._sync(b.device)
    counts = b.sess.fetch_counter - before
    return {"first_frame": first, "frames": out["frames"], "seconds": out["seconds"],
            "latency_ns": [round(s * 1e9) for s in out["latency"]], "issue_s": sum(out["issue"]),
            "blocks": counts.reshape(-1, counts.shape[-1]).sum(0).tolist(), "record": rec}


def stretch(name: str, seed: int, frames: int, device: str, root: Optional[Path] = None) -> Optional[Dict]:
    """The cell's loop from ``seed``: the run's start and warm-up, then
    ``frames`` frames under the tracer; the tracer's record with
    ``stretch`` added. None where the program has no tracer."""
    from real_time_self_adaptive_deep_stereo_torch.utils import profiling

    tracer = getattr(profiling, "tracer", None)
    if tracer is None:
        return None
    b, drv = _loop(name, seed, device, root)
    on = _frames(b, drv, frames, tracer)
    b.sess.finalize()  # raises where a switch found ids that name no branch
    rec = on.pop("record")
    rec["stretch"] = {**on, "cameras": len(b.seeds)}
    return rec


def cost(name: str, seed: int, frames: int, device: str, root: Optional[Path] = None) -> List[str]:
    """The tracer's cost in the cell's loop: ``frames`` frames untraced,
    traced and untraced again (frames/s and host us in step and fetch a
    call, and for MAD each stretch's period against the one its blocks
    predict from the traced step ms by block), then the tracer's own work
    alone (:func:`tracer_us`)."""
    from real_time_self_adaptive_deep_stereo_torch.utils.profiling import tracer

    b, drv = _loop(name, seed, device, root)
    runs = [_frames(b, drv, frames), _frames(b, drv, frames, tracer), _frames(b, drv, frames)]
    b.sess.finalize()
    rec, ncam = runs[1]["record"], len(b.seeds)
    fps = [r["frames"] * ncam / r["seconds"] for r in runs]
    us = [1e6 * r["issue_s"] / r["frames"] for r in runs]
    lines = [f"cost: frames/s untraced, traced, untraced {fps[0]:.3f}, {fps[1]:.3f}, {fps[2]:.3f} (the tracer's "
             f"cost {100 * (1 - 2 * fps[1] / (fps[0] + fps[2])):.3f}%); host in step+fetch us a call "
             f"{us[0]:.3f}, {us[1]:.3f}, {us[2]:.3f}; the tracer's own work alone "
             f"{tracer_us(tracer, b.sess):.3f} us a call"]
    by_block = step_by_block(rec)
    if by_block:
        e = [_efficiency(rec, by_block, r["frames"], r["seconds"], r["blocks"]) for r in runs]
        lines.append(f"cost: blocks trained {[r['blocks'] for r in runs]}; the tracer's cost for those blocks "
                     f"{100 * (1 - 2 * e[1] / (e[0] + e[2])):.3f}% (period against the blocks' prediction "
                     f"{e[0]:.4f}, {e[1]:.4f}, {e[2]:.4f})")
    return lines


def tracer_us(tracer, sess, calls: int = 256) -> float:
    """Host us of the tracer's own work a step call of ``sess``, alone: the
    sites a traced call passes (seven spans, the counts, a device range's
    five marks on the session's stream and, under MAD, the copy of the
    block ids), ``calls`` times, with no step between them."""
    tags = sess.cur_blocks if sess.mode == "MAD" else None
    tracer.start(sess.device)
    t0 = time.perf_counter_ns()
    for i in range(calls):
        with tracer.span("fused.step", i):
            r = tracer.open_range(i, sess.device)
            with tracer.span("fused.load_frame", i):
                with tracer.span("fused.stage_wait", i):
                    pass
                for _ in range(2):  # left, right
                    tracer.count("staged_bytes", 1)
                tracer.mark(r, UPLOAD)
                tracer.mark(r, UPLOADED)
            with tracer.span("fused.pick", i):
                if tags is not None:
                    tracer.tag(r, tags)
                tracer.mark(r, PICKED)
            with tracer.span("fused.launch", i):
                tracer.count("replays")
                tracer.mark(r, LAUNCHED)
            tracer.count("steps")
        with tracer.span("fused.fetch_disp", i):
            tracer.mark(r, FETCHED)
            tracer.count("fetched_bytes", 1)
        with tracer.span("fused.materialize", i):
            pass
    t1 = time.perf_counter_ns()
    tracer.stop()
    return (t1 - t0) / calls / 1e3


def _run_seed() -> int:
    """The run's ``--seed`` (``run.py``'s command line, which checked it);
    0 where the harness was called from Python."""
    argv = sys.argv[1:]
    for a, b in zip(argv, argv[1:] + [""]):
        if a == "--seed":
            return int(b)
        if a.startswith("--seed="):
            return int(a.split("=", 1)[1])
    return 0


def record(ctx) -> Optional[Dict]:
    """The spans stretch's record for the run of ``ctx``, made once (in a
    process of its own) and kept on ``ctx.spans_record``; None where the
    program has no tracer. Raises where the stretch's process fails."""
    if hasattr(ctx, "spans_record"):
        return ctx.spans_record
    ctx.spans_record = None
    from real_time_self_adaptive_deep_stereo_torch.utils import profiling

    if getattr(profiling, "tracer", None) is None:
        log("the program has no tracer: nothing to read")
        return None
    frames = FRAMES_PER_TRACE_FRAME * int(ctx.cell.traffic["trace_frames"])
    fd, out = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    cmd = [sys.executable, str(HERE / "spans.py"), "--workload", ctx.cell.name, "--seed", str(_run_seed()),
           "--frames", str(frames), "--device", str(ctx.build.device), "--root", str(ctx.cell.here.parent),
           "--out", out]
    try:
        p = subprocess.run(cmd, cwd=str(ROOT), capture_output=True, text=True, timeout=TIMEOUT_S)
        if p.returncode != 0:
            log(f"FAILED (exit {p.returncode}):\n{p.stderr[-4000:]}")
            raise RuntimeError(f"the spans stretch failed (exit {p.returncode}); its errors are logged above")
        with open(out) as f:
            rec = json.load(f)
    finally:
        os.remove(out)
    ctx.spans_record = rec
    for line in summary(rec, ctx.window, ctx.block_counts):
        log(line)
    return rec


# ------------------------------------------------------------ the numbers
def _ms(ns: float) -> float:
    return ns * 1e-6


def _durations(rec: Dict, name: str) -> Dict[int, float]:
    """ns in spans of ``name``, by frame."""
    out: Dict[int, float] = {}
    for n, frame, _, t0, t1 in rec["spans"]:
        if n == name:
            out[frame] = out.get(frame, 0.0) + (t1 - t0)
    return out


def _ranges(rec: Dict, *marks: int) -> List[Dict]:
    """The ranges with every one of ``marks`` on the device, by frame."""
    return sorted((r for r in rec["ranges"] if all(r["device"][k] is not None for k in marks)),
                  key=lambda r: r["frame"])


def stage_host_ms(rec: Dict) -> Optional[float]:
    """Mean host ms a step call in ``fused.load_frame``: the staging-event
    wait, the copy into the pinned staging buffer, the upload's enqueue.
    None where no frame went through the staging (off the card)."""
    steps = rec["counters"]["steps"]
    if not steps or not rec["counters"]["staged_bytes"]:
        return None
    return _ms(sum(_durations(rec, "fused.load_frame").values())) / steps


def _mean_range_ms(rec: Dict, a: int, b: int) -> Optional[float]:
    rs = _ranges(rec, a, b)
    return _ms(sum(r["device"][b] - r["device"][a] for r in rs)) / len(rs) if rs else None


def upload_device_ms(rec: Dict) -> Optional[float]:
    """Mean device ms a step call from the mark before the frame's upload
    to the mark after it."""
    return _mean_range_ms(rec, UPLOAD, UPLOADED)


def step_device_ms(rec: Dict) -> Optional[float]:
    """Mean device ms a step call from the mark before the launch to the
    mark after it: the graph, or the switch's parent, alone."""
    return _mean_range_ms(rec, PICKED, LAUNCHED)


def queue_wait_ms(rec: Dict) -> Optional[float]:
    """95th percentile over the step calls of the time from the host's
    enqueue of the first mark to the device reaching it: how long a
    frame's first device work waited behind the frames before it."""
    rs = _ranges(rec, UPLOAD)
    if not rs:
        return None
    return _ms(float(np.percentile([r["device"][UPLOAD] - r["enqueued"][UPLOAD] for r in rs], 95)))


def idle_gaps(rec: Dict) -> List[tuple]:
    """``(start_ns, end_ns)`` of the stream's idle gaps, in device order.
    Between calls: from a call's last mark to the next call's first, where
    the next begins later. Inside a call: before a mark the device reached
    as soon as the host enqueued it (within the width of the clock's
    reference window, twice its uncertainty), from the mark before it to
    that enqueue, the device having waited for the host."""
    rs = _ranges(rec, *range(len(rec["marks"])))
    if not rs:
        return []
    near = 2 * rec["clock"]["uncertainty_ns"]
    gaps = []
    for i, r in enumerate(rs):
        if i and r["device"][UPLOAD] > rs[i - 1]["device"][FETCHED]:
            gaps.append((rs[i - 1]["device"][FETCHED], r["device"][UPLOAD]))
        d, e = r["device"], r["enqueued"]
        for k in range(1, len(d)):
            end = min(e[k], d[k])
            if d[k] - e[k] <= near and end > d[k - 1]:
                gaps.append((d[k - 1], end))
    return gaps


def stream_idle_pct(rec: Dict) -> Optional[float]:
    """The share of the stretch, from the first call's first mark to the
    last call's last, in which the stream had nothing to run (the gaps of
    :func:`idle_gaps`)."""
    rs = _ranges(rec, *range(len(rec["marks"])))
    if len(rs) < 2:
        return None
    whole = rs[-1]["device"][FETCHED] - rs[0]["device"][UPLOAD]
    return 100.0 * sum(b - a for a, b in idle_gaps(rec)) / whole if whole > 0 else None


# ------------------------------------------------------------ the log
def _depths(spans: List) -> List[int]:
    depth: List[int] = []
    for _, _, parent, _, _ in spans:
        depth.append(0 if parent < 0 else depth[parent] + 1)
    return depth


def idle_by_span(rec: Dict) -> Dict[str, float]:
    """The idle gaps' ms by the innermost program span that overlaps each
    most (``python`` where none does)."""
    spans = rec["spans"]
    out: Dict[str, float] = {}
    if not spans:
        return out
    t0 = np.array([s[3] for s in spans], dtype=np.float64)
    t1 = np.array([s[4] for s in spans], dtype=np.float64)
    depth = np.array(_depths(spans), dtype=np.float64)
    for a, b in idle_gaps(rec):
        over = np.clip(np.minimum(t1, b) - np.maximum(t0, a), 0.0, None)
        label = "python"
        if over.max() > 0:
            # the most overlap, and of equal overlaps the innermost
            label = spans[int(np.lexsort((depth, over))[-1])][0]
        out[label] = out.get(label, 0.0) + _ms(b - a)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def latency_split(rec: Dict) -> Dict[str, np.ndarray]:
    """Each traced frame's latency in parts (ns), from ``fused.step``'s
    start to ``fused.materialize``'s end: the host before the first mark,
    the queue, the upload, the pick, the step, the fetch, and the host's
    notice after the last mark; and their sum."""
    start = {f: t0 for n, f, p, t0, _ in rec["spans"] if n == "fused.step" and p < 0}
    end = {f: t1 for n, f, p, _, t1 in rec["spans"] if n == "fused.materialize"}
    rows = []
    for r in _ranges(rec, UPLOAD, UPLOADED, PICKED, LAUNCHED, FETCHED):
        f, d = r["frame"], r["device"]
        if f in start and f in end:
            rows.append([r["enqueued"][UPLOAD] - start[f], d[UPLOAD] - r["enqueued"][UPLOAD], d[UPLOADED] - d[UPLOAD],
                         d[PICKED] - d[UPLOADED], d[LAUNCHED] - d[PICKED], d[FETCHED] - d[LAUNCHED],
                         end[f] - d[FETCHED], end[f] - start[f], f])
    a = np.array(rows, dtype=np.float64).reshape(-1, 9)
    names = ("host", "queue", "upload", "pick", "step", "fetch", "notice", "total", "frame")
    return {k: a[:, j] for j, k in enumerate(names)}


def step_by_block(rec: Dict) -> Dict[int, tuple]:
    """``{block: (frames, step ms)}``: a call's step ms as the sum of one
    term a trained block (least squares over the calls; with one camera
    each block's mean)."""
    rs = [r for r in _ranges(rec, PICKED, LAUNCHED) if r["tags"]]
    if not rs:
        return {}
    blocks = sorted({k for r in rs for k in r["tags"]})
    a = np.zeros((len(rs), len(blocks)))
    for i, r in enumerate(rs):
        for k in r["tags"]:
            a[i, blocks.index(k)] += 1
    y = np.array([_ms(r["device"][LAUNCHED] - r["device"][PICKED]) for r in rs])
    x = np.linalg.lstsq(a, y, rcond=None)[0]
    return {k: (int(a[:, j].sum()), float(x[j])) for j, k in enumerate(blocks)}


def _efficiency(rec: Dict, by_block: Dict, frames: int, seconds: float, blocks: List[int]) -> float:
    """A stretch of ``frames`` frames in ``seconds`` that trained ``blocks``
    (frames a block, over the cameras): the period its blocks predict (the
    traced step ms by block, plus the traced calls' other device ms) over
    its measured period."""
    rs = _ranges(rec, UPLOAD, FETCHED)
    other = _ms(sum(r["device"][FETCHED] - r["device"][UPLOAD] - (r["device"][LAUNCHED] - r["device"][PICKED])
                    for r in rs)) / len(rs)
    expected = sum(n * by_block[k][1] for k, n in enumerate(blocks) if k in by_block) / frames + other
    return expected / (1e3 * seconds / frames)


def summary(rec: Dict, window: Optional[Dict] = None, window_blocks: Optional[List[int]] = None) -> List[str]:
    """The stretch's log: its cost against the run's window, the latency
    split, the idle gaps by span, MAD's step by block, the counters and
    the consistency checks."""
    st, c = rec["stretch"], rec["counters"]
    fps = st["frames"] * st["cameras"] / st["seconds"]
    us = 1e6 * st["issue_s"] / st["frames"]
    line = f"{st['frames']} frames from frame {st['first_frame']}; frames/s {fps:.3f}"
    if window and window["issue"]:
        fps_w = window["frames"] * st["cameras"] / window["seconds"]
        us_w = 1e6 * sum(window["issue"]) / len(window["issue"])
        line += (f" against the window's {fps_w:.3f} (the tracer's cost {100 * (1 - fps / fps_w):.3f}%); host in "
                 f"step+fetch us a call {us:.3f} against the window's {us_w:.3f}")
    lines = [line]
    # steady: no capture, and on the graphs' path no eager step (off the card every step is eager)
    steady = c["captures"] == 0 and (c["eager_steps"] == 0 or c["replays"] == 0)
    lines.append(f"counters {c}; steady {steady}")
    values = {k: f(rec) for k, f in (("stage_host_ms", stage_host_ms), ("upload_device_ms", upload_device_ms),
                                     ("queue_wait_ms", queue_wait_ms), ("step_device_ms", step_device_ms),
                                     ("stream_idle_pct", stream_idle_pct))}
    lines.append("numbers " + ", ".join(f"{k} {v!r}" for k, v in values.items()))
    if values["stage_host_ms"] is not None:
        own = 1e3 * st["issue_s"] / st["frames"]
        lines.append(f"check: stage_host_ms {values['stage_host_ms']:.4f} <= the stretch's host in step+fetch "
                     f"{own:.4f}: {values['stage_host_ms'] <= own} (the window's host_issue_ms is another "
                     f"process's)")
    if not rec["ranges"]:
        return lines + ["no device ranges (no card)"]
    clock = rec["clock"]
    lines.append(f"clock: uncertainty {clock['uncertainty_ns'] / 1e3:.3f} us, drift {clock['drift_ppm']:.3f} ppm")
    rs = _ranges(rec, UPLOAD, FETCHED)
    whole = rs[-1]["device"][FETCHED] - rs[0]["device"][UPLOAD]
    parts = {}
    for name, (a, b) in (("upload", (UPLOAD, UPLOADED)), ("pick", (UPLOADED, PICKED)),
                         ("step", (PICKED, LAUNCHED)), ("fetch", (LAUNCHED, FETCHED))):
        parts[name] = sum(r["device"][b] - r["device"][a] for r in rs)
    gaps = idle_gaps(rec)
    between = sum(max(0, y["device"][UPLOAD] - x["device"][FETCHED]) for x, y in zip(rs, rs[1:]))
    inside = sum(b - a for a, b in gaps) - between
    busy = 100.0 * (sum(parts.values()) - inside) / whole
    lines.append("device ms a call " + ", ".join(f"{k} {_ms(v) / len(rs):.4f}" for k, v in parts.items())
                 + f"; ranges' share less the idle inside them ({100 * inside / whole:.3f}%) {busy:.3f}% against "
                 f"100 - stream_idle_pct {100 - values['stream_idle_pct']:.3f}%")
    if c["staged_bytes"] and parts["upload"]:
        lines.append(f"upload {c['staged_bytes'] / parts['upload']:.3f} GB/s, fetch "
                     f"{c['fetched_bytes'] / parts['fetch']:.3f} GB/s (bytes over the ranges)")
    split = latency_split(rec)
    if len(split["total"]):
        lines.append("latency split ms p50/p95: " + ", ".join(
            f"{k} {_ms(np.percentile(v, 50)):.4f}/{_ms(np.percentile(v, 95)):.4f}"
            for k, v in split.items() if k != "frame"))
        lat = np.array(st["latency_ns"], dtype=np.float64)
        frames = split["frame"].astype(int) - st["first_frame"]
        ok = (frames >= 0) & (frames < len(lat))
        gap = lat[frames[ok]] - split["total"][ok]
        lines.append(f"latency measured less the split's sum us: p50 {np.percentile(gap, 50) / 1e3:.3f}, max "
                     f"{gap.max() / 1e3:.3f}, min {gap.min() / 1e3:.3f} (clock uncertainty "
                     f"{clock['uncertainty_ns'] / 1e3:.3f} us); measured p50 {_ms(np.percentile(lat, 50)):.4f} "
                     f"p95 {_ms(np.percentile(lat, 95)):.4f} ms")
    idle = idle_by_span(rec)
    lines.append(f"idle ms by span ({len(gaps)} gaps): "
                 + ", ".join(f"{k} {v:.4f}" for k, v in list(idle.items())[:TOP]))
    by_block = step_by_block(rec)
    if by_block:
        lines.append("step ms by block (frames): " + ", ".join(
            f"{k}: {ms:.4f} ({n})" for k, (n, ms) in by_block.items()))
        # a stretch's frames/s moves with the blocks it trained: each against the period its blocks predict
        if window and window_blocks:
            e_on = _efficiency(rec, by_block, st["frames"], st["seconds"], st["blocks"])
            e_w = _efficiency(rec, by_block, window["frames"], window["seconds"], window_blocks)
            lines.append(f"blocks trained traced {st['blocks']}, in the window {window_blocks}; the tracer's cost "
                         f"for those blocks {100 * (1 - e_on / e_w):.3f}% (period against the blocks' "
                         f"prediction: traced {e_on:.4f}, the window {e_w:.4f})")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--out", default=None, help="the record's file (not with --cost)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=None)
    ap.add_argument("--cost", action="store_true", help="log the tracer's cost instead of writing a record")
    args = ap.parse_args(argv)
    if not args.cost and args.out is None:
        ap.error("--out is required without --cost")

    import torch

    torch.set_num_threads(1)  # as run.py
    root = Path(args.root) if args.root else None
    if args.cost:
        for line in cost(args.workload, args.seed, args.frames, args.device, root):
            log(line)
        return 0
    rec = stretch(args.workload, args.seed, args.frames, args.device, root)
    with open(args.out, "w") as f:
        json.dump(rec, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
