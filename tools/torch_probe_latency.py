#!/usr/bin/env python3
"""Dispatch-to-disparity-on-the-host latency of the port's fused MAD step.

The counterpart of ``tools/probe_latency.py``: MADNet with the bulkhead,
fused MAD, PROBABILITY, ``ssim_th`` 1e9, at 384x1280, four frames made in
memory (a random image and its shifts of 4-7 px), already on the device.
Each variant runs N = 64 frames after 10 warm ones and prints one JSON line
(p50, p99, mean and min ms, and the p50 of the host's enqueue, the time
``step`` itself takes: the port's ``step`` waits on the upload event of the
frame two back, ``adapt/fused.py::_load_frame``, so that wait is part of
what is measured here):

  wire_rtt_4B[_pinned]      a fresh 4-byte result to the host, pageable or pinned
  wire_d2h_*KiB[_pinned]    the device-to-host copy over 64, 512 and 1920 KiB
  blocking_f32              step, then ``last_disp.cpu()``
  async_f32                 step, then ``fetch_disp()()``
  poll_f32                  step, then a copy to pinned memory on a copy stream of
                            the probe's, ``Event.query()`` polled every 0.5 ms, then
                            the array (CUDA only)
  async_f16                 a ``disp_dtype=torch.float16`` session, ``fetch_disp()()``
  pipelined_f16             depth 1: dispatch frame i+1, then take frame i's
                            disparity (one frame stale)

Every variant checks that each disparity it hands back is the session's own
for its frame, bit for bit (a copy made on the device right after the step,
outside the timed region), and raises otherwise.

    python tools/torch_probe_latency.py [--height 384 --width 1280 --frames 64 --warmup 10]
        [--device cuda|cpu]

Runs on the card unless ``--device cpu`` (the wire probe and ``poll_f32``
then say that they need CUDA). Imports the port, numpy and torch, never JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

H, W = 384, 1280
N = 64
WARMUP = 10
WIRE_KIB = (64, 512, 1920)
VARIANTS = ("blocking_f32", "async_f32", "poll_f32", "async_f16", "pipelined_f16")
CUDA_ONLY = ("poll_f32",)
POLL_S = 0.0005


def build_session(disp_dtype=None, h: int = H, w: int = W, n: int = N, warmup: int = WARMUP, device=None):
    """The probed session and its four frames (on the session's device)."""
    import torch

    from real_time_self_adaptive_deep_stereo_torch.adapt import (
        AdaptationEngine,
        FusedOnlineSession,
        load_block_config,
        make_blocks,
    )
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net

    model = get_stereo_net("MADNet", bulkhead=True, device=device)
    blocks = make_blocks(load_block_config(str(ROOT / "block_config" / "MadNet_full.json")), model)
    engine = AdaptationEngine(model, blocks, lr=1e-4, device=device)
    sess = FusedOnlineSession(
        engine, mode="MAD", sample_mode="PROBABILITY", ssim_th=1e9,
        max_steps=warmup + 8 * n + 16, seed=0, disp_dtype=disp_dtype,
    )
    rng = np.random.default_rng(0)
    base = rng.random((h, w, 3)).astype(np.float32) * 255
    frames = []
    for shift in range(4, 8):
        frames.append({
            "left": torch.from_numpy(base[None].copy()).to(engine.device),
            "right": torch.from_numpy(np.roll(base, -shift, axis=1)[None].copy()).to(engine.device),
            "target": torch.full((1, h, w, 1), float(shift), device=engine.device),
        })
    return sess, frames


def report(name: str, lats, extra: Optional[Dict] = None, log=print) -> Dict:
    """One variant's JSON line, printed through ``log`` and returned."""
    lats = np.sort(np.asarray(lats, dtype=np.float64))
    rec = {
        "variant": name,
        "p50_ms": float(lats[len(lats) // 2]),
        "p99_ms": float(lats[int(len(lats) * 0.99)]),
        "mean_ms": float(lats.mean()),
        "min_ms": float(lats[0]),
        **(extra or {}),
    }
    log(json.dumps(rec))
    return rec


def probe_wire(n: int = N, log=print) -> List[Dict]:
    """The host-device wire alone, on the card: a 4-byte result made anew
    each time and waited for, so its copy waits on the wire alone, then
    device-to-host copies over a size sweep, each into pageable and into
    pinned memory."""
    import torch

    recs = []
    for kib in (0, *WIRE_KIB):
        numel = 1 if kib == 0 else kib * 256  # kib KiB of float32
        src = torch.zeros(numel, device="cuda")
        pinned = torch.empty(numel, pin_memory=True)
        for kind in ("pageable", "pinned"):
            lats = []
            for _ in range(n if kib == 0 else 16):
                y = src + 1
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if kind == "pageable":
                    y.cpu()
                else:
                    pinned.copy_(y)
                lats.append((time.perf_counter() - t0) * 1e3)
            name = ("wire_rtt_4B" if kib == 0 else f"wire_d2h_{kib}KiB") + ("" if kind == "pageable" else "_pinned")
            rec = report(name, lats, {"bytes": 4 * numel, "into": kind}, log)
            rec["mib_per_s"] = 4 * numel / 2**20 / (rec["p50_ms"] / 1e3)
            recs.append(rec)
    return recs


def _poll_fetch(copy_stream) -> Callable:
    """``get(sess)`` of ``poll_f32``: the copy into a pinned buffer on
    ``copy_stream``, after the step, an event polled, then the array."""
    import torch

    bufs = {}

    def get(sess):
        d = sess.last_disp
        host = bufs.get(d.shape)
        if host is None:
            host = bufs[d.shape] = torch.empty(tuple(d.shape), dtype=d.dtype, pin_memory=True)
        copy_stream.wait_stream(torch.cuda.current_stream(d.device))
        with torch.cuda.stream(copy_stream):
            host.copy_(d, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy_stream)
        while not done.query():
            time.sleep(POLL_S)
        return host.numpy().copy()

    return get


def run_variant(name: str, sess, frames, n: int) -> Tuple[List[float], List[float], List[np.ndarray]]:
    """``n`` frames (``frames[i % 4]``) through variant ``name``: each
    frame's latency and the host's enqueue time (ms), and the disparities
    handed back, in frame order. Raises unless each is, bit for bit, the
    session's own disparity for its frame."""
    import torch

    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}; one of {VARIANTS}")
    if name in CUDA_ONLY and sess.device.type != "cuda":
        raise ValueError(f"{name} polls a CUDA event: it needs the card")
    lats, enq, outs, refs = [], [], [], []
    if name == "pipelined_f16":
        sess.step(frames[0])
        pending = sess.fetch_disp()
        refs.append(sess.last_disp.clone())
        for i in range(1, n + 1):
            t0 = time.perf_counter()
            sess.step(frames[i % len(frames)])
            t1 = time.perf_counter()
            nxt = sess.fetch_disp()
            outs.append(pending())
            lats.append((time.perf_counter() - t0) * 1e3)
            enq.append((t1 - t0) * 1e3)
            pending = nxt
            refs.append(sess.last_disp.clone())
        refs.pop()  # frame n's disparity, still in flight
    else:
        get = {
            "blocking_f32": lambda s: s.last_disp.cpu().numpy(),
            "async_f32": lambda s: s.fetch_disp()(),
            "async_f16": lambda s: s.fetch_disp()(),
        }.get(name) or _poll_fetch(torch.cuda.Stream(sess.device))
        for i in range(n):
            t0 = time.perf_counter()
            sess.step(frames[i % len(frames)])
            t1 = time.perf_counter()
            outs.append(get(sess))
            lats.append((time.perf_counter() - t0) * 1e3)
            enq.append((t1 - t0) * 1e3)
            refs.append(sess.last_disp.clone())
    want_dtype = torch.float16 if name.endswith("f16") else torch.float32
    for i, (out, ref) in enumerate(zip(outs, refs)):
        got = torch.from_numpy(out)
        if ref.dtype != want_dtype or not torch.equal(got, ref.cpu()):
            raise AssertionError(f"{name} frame {i}: the disparity handed back ({got.dtype}) is not the "
                                 f"session's own ({ref.dtype}), max diff "
                                 f"{float((got.float() - ref.cpu().float()).abs().max()):.3g}")
    return lats, enq, outs


def _warm(sess, frames, warmup: int) -> None:
    for i in range(warmup):
        sess.step(frames[i % len(frames)])
    sess.block_until_ready()


def probe(h: int = H, w: int = W, n: int = N, warmup: int = WARMUP, device=None, log=print) -> List[Dict]:
    """Every variant (and on the card the wire) at ``h`` x ``w``; the
    records of :func:`report`. A variant that needs the card is reported as
    skipped on the CPU."""
    import torch

    recs = []
    cuda = (device is None or torch.device(device).type == "cuda")
    if cuda:
        recs += probe_wire(n, log)
    nbytes = h * w * 4
    sess, frames = build_session(None, h, w, n, warmup, device)
    _warm(sess, frames, warmup)
    for name in ("blocking_f32", "async_f32", "poll_f32"):
        if name in CUDA_ONLY and not cuda:
            recs.append({"variant": name, "skipped": "CUDA only"})
            log(json.dumps(recs[-1]))
            continue
        lats, enq, _ = run_variant(name, sess, frames, n)
        recs.append(report(name, lats, {"bytes": nbytes, "enqueue_p50_ms": float(np.median(enq)),
                                        "checked_frames": n}, log))
    sess.block_until_ready()  # counts the launches the device switched to
    del sess
    sess, frames = build_session(torch.float16, h, w, n, warmup, device)
    _warm(sess, frames, warmup)
    for name in ("async_f16", "pipelined_f16"):
        lats, enq, _ = run_variant(name, sess, frames, n)
        extra = {"bytes": nbytes // 2, "enqueue_p50_ms": float(np.median(enq)), "checked_frames": n}
        if name == "pipelined_f16":
            extra["staleness_frames"] = 1
        recs.append(report(name, lats, extra, log))
    sess.block_until_ready()
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--frames", type=int, default=N)
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    import torch

    if args.device in (None, "cuda") and torch.cuda.is_available():
        print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    probe(args.height, args.width, args.frames, args.warmup, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
