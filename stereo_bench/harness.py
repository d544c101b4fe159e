"""One run of one cell: set-up, warm-up, the measured window, the optional
traced stretch, and the output check.

The entry the window drives is the one the ``adapt`` CLI and the demo
use: ``get_stereo_net`` and ``load_state_dict`` of the seed's weights,
``make_blocks`` of the configuration's block groups, an
``AdaptationEngine`` and a ``FusedOnlineSession`` at the CLI's defaults
with ``compute_metrics=False`` (no ground truth on a car). A frame is
handed to ``step`` from pinned host memory, ``fetch_disp`` starts its
disparity's copy, and the previous frame's disparity is materialised in
host memory while this one runs (depth-1 pipelining, ``step_pipelined``).
The loop is closed: the next frame follows as soon as the calls return,
replaying the recorded video as fast as the system goes.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from stereo_bench import check, video, weights
from stereo_bench.reference.models import MODELS
from stereo_bench.spec import Cell, SpecError

def log(msg: str) -> None:
    print(f"stereo_bench: {msg}", file=sys.stderr, flush=True)


_STATE = ("scores", "loss_t1", "loss_t2", "last_mask", "fetch_counter", "step_count", "reset_count")


def snapshot(sess) -> Dict[str, torch.Tensor]:
    """The session's state, cloned on the device in stream order: the
    state after the steps enqueued so far."""
    snap = {"flat": sess.arena.flat.clone(), **{k: getattr(sess, k).clone() for k in _STATE}}
    if "acc" in sess.opt:
        snap["acc"] = sess.opt["acc"][0].clone()
    return snap


class FrameLoop:
    """The depth-1 pipelined closed loop over the video, frame ``i`` the
    video's frame ``i % len(frames)``, ``i`` counted over the session's
    life."""

    def __init__(self, sess, frames: List[Dict]):
        self.sess, self.frames = sess, frames
        self.i = 0
        self.snaps: Dict[int, Dict] = {}
        self.kept: Dict[int, np.ndarray] = {}
        self.spans = False  # name the calls for a profiler

    def _span(self, name: str):
        return torch.profiler.record_function(name) if self.spans else contextlib.nullcontext()

    def run(self, count: Optional[int] = None, seconds: Optional[float] = None, snap_at=(), keep=()) -> Dict:
        """Frames until ``count`` have been handed in or ``seconds`` have
        passed, then the last disparity; returns the frames, the seconds,
        each frame's latency (hand-off to disparity in host memory) and the
        host's seconds inside ``step`` and ``fetch_disp``."""
        lat, issue, pending = [], [], None
        last = max({*snap_at, *keep}, default=-1)
        t0 = time.perf_counter()
        n = 0
        while True:
            i = self.i
            if i in snap_at:
                self.snaps[i] = snapshot(self.sess)
            ta = time.perf_counter()
            with self._span("step"):
                self.sess.step(self.frames[i % len(self.frames)])
            with self._span("fetch_disp"):
                fetch = self.sess.fetch_disp()
            issue.append(time.perf_counter() - ta)
            if pending is not None:
                lat.append(self._settle(*pending, keep))
            pending = (i, fetch, ta)
            self.i += 1
            n += 1
            if count is not None and n >= count:
                break
            # a timed run also hands in every frame it snapshots before or keeps
            if seconds is not None and time.perf_counter() - t0 >= seconds and self.i > last:
                break
        lat.append(self._settle(*pending, keep))
        return {"frames": n, "seconds": time.perf_counter() - t0, "latency": lat, "issue": issue}

    def _settle(self, i: int, fetch, t_hand: float, keep) -> float:
        with self._span("materialize"):
            disp = fetch()
        if i in keep:
            self.kept[i] = disp
        return time.perf_counter() - t_hand


class Build:
    """The program under test, built from the seed, and the seed's inputs."""

    def __init__(self, cell: Cell, seed: int, device, precision: Optional[str] = None):
        t_import = time.perf_counter()
        from real_time_self_adaptive_deep_stereo_torch.adapt import AdaptationEngine, FusedOnlineSession, make_blocks
        from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
        from real_time_self_adaptive_deep_stereo_torch.ops import set_conv_precision

        cfg, trf = cell.config, cell.traffic
        self.device = torch.device(device)
        self.rig = trf["num_streams"] > 0
        ncam = max(trf["num_streams"], 1)
        # the block sampler's generators take the adapt CLI's default seed (camera c: + c), the same
        # for every --seed: the blocks trained, and with them a frame's work, do not change with it
        self.seeds = [int(trf["sampler_seed"]) + c for c in range(ncam)]
        h, w, nf = cfg["input"]["height"], cfg["input"]["width"], trf["frames_per_camera"]
        pin = self.device.type == "cuda"
        t0 = time.perf_counter()
        log(f"set-up: the port's import {t0 - t_import:.3f} s")
        # one contiguous block a camera; a rig's frame is a view across them
        self.host = [torch.empty((ncam, nf, 1, h, w, 3), dtype=torch.float32, pin_memory=pin) for _ in range(2)]
        for c in range(ncam):
            views = video.make_video(seed, c, nf, h, w, self.device, **trf.get("video", {}))
            for host, v in zip(self.host, views):
                host[c].copy_(v.unsqueeze(1))
            del views
        pick = (lambda t: t) if self.rig else (lambda t: t[0])
        self.frames = [{"left": pick(self.host[0][:, i]), "right": pick(self.host[1][:, i])} for i in range(nf)]
        t1 = time.perf_counter()

        set_conv_precision(precision or cfg["precision"])
        # MADNet's bulkhead under MAD, as the adapt CLI sets it
        kwargs = {"bulkhead": cfg["bulkhead_in"].get(trf["mode"], False)} if "bulkhead_in" in cfg else {}
        model = get_stereo_net(cfg["model"], device=self.device, **kwargs)
        self.w0 = weights.make_weights(MODELS[cfg["model"]][2](), cfg["weights"], seed, self.device)
        model.load_state_dict(self.w0)
        engine = AdaptationEngine(model, make_blocks(cfg["blocks"], model), lr=trf["lr"], momentum=trf["momentum"],
                                  device=self.device)
        self.sess = FusedOnlineSession(
            engine, mode=trf["mode"], sample_mode=trf["sample_mode"], num_blocks=trf["num_blocks"],
            ssim_th=trf["ssim_th"], compute_metrics=False, seed=self.seeds if self.rig else self.seeds[0],
            num_streams=trf["num_streams"], stream_impl=trf["stream_impl"],
        )
        self.entries = self.sess.spec.entries
        log(f"set-up: video {t1 - t0:.3f} s ({ncam} x {nf} frames), model and session {time.perf_counter() - t1:.3f} s")

    def frame_at(self, i: int):
        """Frame ``i``'s (left, right) on the device, as handed in."""
        f = self.frames[i % len(self.frames)]
        return f["left"].to(self.device), f["right"].to(self.device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda", root=None,
             t_process: Optional[float] = None, precision: Optional[str] = None) -> Dict:
    """One run; returns the result object (``checks`` last)."""
    t_start = time.perf_counter() if t_process is None else t_process
    cell = Cell(name, root)
    trf = cell.traffic
    rng = np.random.default_rng([int(seed) % 2**63, 7])
    log(f"set-up: {time.perf_counter() - t_start:.3f} s to the build")
    b = Build(cell, seed, device, precision)
    drv = FrameLoop(b.sess, b.frames)
    # the start: three frames from the seed, the state after one and three kept
    t0 = time.perf_counter()
    drv.run(count=3, snap_at={1}, keep={0, 1, 2})
    t1 = time.perf_counter()
    drv.run(count=trf["warmup_frames"], snap_at={3})
    _sync(b.device)
    rate = drv.run(count=trf["warmup_frames"])
    log(f"set-up: first 3 frames {t1 - t0:.3f} s, warm-up {time.perf_counter() - t1:.3f} s "
        f"(last {rate['frames']} frames {1e3 * rate['seconds'] / rate['frames']:.3f} ms each)")
    expected = rate["frames"] / rate["seconds"] * seconds
    follow = drv.i + int(rng.uniform(0.2, 0.5) * expected)
    samples = sorted(drv.i + int(k) for k in rng.choice(max(int(0.8 * expected), 8), 8, replace=False))
    samples = samples if trf["mode"] == "NONE" else []
    counts0 = b.sess.fetch_counter.clone()
    if b.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(b.device)
    _sync(b.device)
    setup_s = time.perf_counter() - t_start
    win = drv.run(seconds=seconds, snap_at={follow, follow + 3}, keep={follow, follow + 1, follow + 2, *samples})
    counts = (b.sess.fetch_counter - counts0).cpu()
    lat, iss = np.asarray(win["latency"]) * 1e3, np.asarray(win["issue"]) * 1e3
    log(f"window: {win['frames']} frames in {win['seconds']:.3f} s; latency ms p50 {np.median(lat):.3f} "
        f"p95 {np.percentile(lat, 95):.3f} max {lat.max():.3f}; host in step+fetch ms p50 {np.median(iss):.3f} "
        f"p95 {np.percentile(iss, 95):.3f} max {iss.max():.3f}; blocks trained {counts.reshape(-1).tolist()}")
    peak = torch.cuda.max_memory_allocated(b.device) if b.device.type == "cuda" else 0
    traced = None
    if trace:
        from stereo_bench import tracing

        traced = tracing.traced_stretch(drv, trf["trace_frames"], b.device)
    b.sess.finalize()  # raises where a switch found ids that name no branch
    snaps, kept, entries, w0 = drv.snaps, drv.kept, b.entries, b.w0
    # the program's state is freed before the reference runs
    drv.sess = b.sess = None
    gc.collect()
    if b.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    values, where = check.run_checks(cell, w0, entries, snaps, kept, b.frame_at, b.seeds, follow, samples)
    log(f"output check: {time.perf_counter() - t0:.3f} s; followed from frame {follow}; all numbers {values}; "
        f"worst at {where}")
    # the cell's limits name the numbers it compares
    limits = cell.limits
    unknown = sorted(set(limits) - set(values))
    if unknown:
        raise SpecError(f"limits/{name}.json names numbers this cell does not make: {unknown}")
    values = {k: values[k] for k in limits}
    correct = all(values[k] <= limits[k] for k in values)

    ncam = len(b.seeds)
    frames = win["frames"] * ncam
    result = {"correct": correct, "attempted": frames, "failed": 0}
    device_info = {"platform": "gpu" if b.device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(b.device) if b.device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if not trace:
        e2e = {
            "frames_per_s": frames / win["seconds"],
            "disp_p95_ms": 1e3 * float(np.percentile(win["latency"], 95)),
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    else:
        from stereo_bench import tracing

        ctx = tracing.Context(cell, b, win, counts, traced)
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if traced is not None and traced.get("window_s"):
            device_info["busy_s"] = traced["busy_s"]
            device_info["window_s"] = traced["window_s"]
            result["breakdown"] = traced["breakdown"]
    result["metrics"] = metrics
    result["device"] = device_info
    result["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    return result

