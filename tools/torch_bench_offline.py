#!/usr/bin/env python3
"""Batched offline inference on the port: forward-only frames/s over a
batch sweep.

The counterpart of ``tools/bench_offline.py``. Online adaptation runs one
frame at a time; offline work (evaluating a folder of frames) may batch.
This tool times ``full_res_disp`` of MADNet and DispNet-Corr1D (seeded
weights, no ground truth) at 384x1280 for each batch, under
``--precision`` (``bf16_act`` by default, the serving mode): 6 warm
forwards, then ``--passes`` passes of ``--iters`` forwards, each pass
timed by CUDA events with one sync, the median of the passes reported. The
JAX tool threads a tiny perturbation through its forwards and drains each
pass with a host fetch, to work around a remote TPU runtime that cached
repeated calls; a CUDA event needs neither.

Operations a frame: ``torch.utils.flop_counter.FlopCounterMode`` over one
forward, which counts the convolutions (2 a multiply-add) but not the
correlation, a kernel of the port's own, whose 2·C·(2R+1)·H·W a call are
added from each call's shapes; elementwise work is not counted, where
XLA's ``cost_analysis``, which the JAX tool reads, counts it, so the two
figures are not the same yardstick. The share is against the H100's dense
bf16 peak, 989 TFLOP/s (NVIDIA's data sheet, SXM, 700 W), whatever the
precision.

Each batch's disparities must equal the batch-1 disparities of the same
frame (every frame of a batch is the same frame) within the mode's
tolerance (``batch_error``): at ``highest`` within 1e-4 of the largest
disparity; in the other modes the median relative difference within 0.05,
the JAX package's bound on a bf16 forward's drift.

    python tools/torch_bench_offline.py [--models MADNet,Dispnet] [--batches 1,2,4,8]
        [--iters 32] [--passes 3] [--height 384 --width 1280] [--precision bf16_act]
        [--trace DIR] [--device cuda|cpu]

``--trace DIR`` traces the last (model, batch) with ``utils/profiling.py``
and prints its kernel families. Runs on the card unless ``--device cpu``
(then the host clock replaces the events). Imports the port, numpy and
torch, never JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

H, W = 384, 1280
BATCHES = (1, 2, 4, 8)
H100_BF16_PEAK_TFLOPS = 989.0
WARM = 6
# a batch's disparities against batch 1's. At highest: the largest
# difference within the model's parity figure, 1e-4 of the largest
# disparity. In the other modes cuDNN picks other algorithms for another
# batch, which round apart (TF32, bf16) as another implementation of the
# mode would, and a network of random weights amplifies that as it
# amplifies the mode's own rounding (MADNet's disparities under bf16_act
# 0.18-0.21 of the largest from batch 1's, a median of 0.038, on an NVIDIA
# H100): so the bound is the JAX package's on a bf16 forward's drift from
# highest (tests/test_adapt.py::test_bf16_act_forward_drift_bounded), the
# median over the pixels of |d - d1| / max(|d1|, 1) within 0.05
HIGHEST_RTOL = 1e-4
DRIFT_MEDIAN = 0.05


def batch_error(out: np.ndarray, ref: np.ndarray, mode: str):
    """(statistic, bound, its name) of the disparities ``out`` [B, ...]
    against batch 1's ``ref`` [...] under precision ``mode``."""
    if mode == "highest":
        return float(np.abs(out - ref[None]).max()) / float(np.abs(ref).max()), HIGHEST_RTOL, "max of the largest"
    med = float(np.median(np.abs(out - ref[None]) / np.maximum(np.abs(ref[None]), 1.0)))
    return med, DRIFT_MEDIAN, "median relative"


@contextlib.contextmanager
def counting_correlations(counts: List[int]) -> Iterator[None]:
    """Within the block, every correlation the models call appends its
    operations, 2·C·(2R+1)·H·W a frame of the batch (R the radius,
    stride 1), to ``counts``."""
    from real_time_self_adaptive_deep_stereo_torch.models import dispnet, madnet

    originals = {m: m.correlation for m in (madnet, dispnet)}

    def counted(fn):
        def correlation(x, y, max_disp, *args, **kwargs):
            b, c, h, w = x.shape
            counts.append(2 * b * c * (2 * max_disp + 1) * h * w)
            return fn(x, y, max_disp, *args, **kwargs)
        return correlation

    try:
        for m, fn in originals.items():
            m.correlation = counted(fn)
        yield
    finally:
        for m, fn in originals.items():
            m.correlation = fn


def frame_flops(model, left, right) -> Dict[str, float]:
    """One forward's operations a frame: the convolutions' (FlopCounterMode)
    and the correlations' (counted from their shapes)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    corr: List[int] = []
    with torch.no_grad(), FlopCounterMode(display=False) as counter, counting_correlations(corr):
        model(left, right)
    b = left.shape[0]
    return {"conv_flop": counter.get_total_flops() / b, "corr_flop": sum(corr) / b}


def inputs(batch: int, h: int, w: int, device):
    """``batch`` copies of one random frame: left, and right its 6-px shift."""
    import torch

    rng = np.random.default_rng(0)
    base = (rng.random((h, w, 3)) * 255).astype(np.float32)
    left = torch.from_numpy(np.broadcast_to(base, (batch, h, w, 3)).copy()).to(device)
    right = torch.from_numpy(np.broadcast_to(np.roll(base, -6, axis=1), (batch, h, w, 3)).copy()).to(device)
    return left, right


def time_passes(fwd, iters: int, passes: int, cuda: bool) -> List[float]:
    """Seconds of each pass of ``iters`` calls: CUDA events and one sync a
    pass on the card, the host clock on the CPU."""
    import torch

    out = []
    for _ in range(passes):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fwd()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fwd()
            out.append(time.perf_counter() - t0)
    return out


def run(model_name: str, batches=BATCHES, iters: int = 32, passes: int = 3, h: int = H, w: int = W,
        precision: Optional[str] = None, trace_dir: Optional[str] = None, device=None,
        log=print) -> List[Dict]:
    """Every batch of ``batches`` for one model under ``precision`` (the
    mode in force where None): a record each, printed through ``log``.
    Raises unless each batch's disparities are batch 1's (``BATCH_RTOL``).
    ``trace_dir``: trace the last batch's passes there."""
    import torch

    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.ops import conv_precision, get_conv_precision

    with conv_precision(precision or get_conv_precision()):
        mode = get_conv_precision()
        model = get_stereo_net(model_name, device=device)
        cuda = next(model.parameters()).device.type == "cuda"
        dev = next(model.parameters()).device
        recs, ref = [], None
        for bi, batch in enumerate(batches):
            left, right = inputs(batch, h, w, dev)

            def fwd():
                with torch.no_grad():
                    return model(left, right)["full_res_disp"]

            flops = frame_flops(model, left, right)
            for _ in range(WARM):
                out = fwd()
            out = out.float().cpu().numpy()
            if ref is None:
                ref = out[0]
            err, bound, kind = batch_error(out, ref, mode)
            if not err <= bound:
                raise AssertionError(f"{model_name} batch {batch}: disparities {err:.3g} ({kind}) from batch 1's "
                                     f"(bound {bound})")
            ctx = contextlib.nullcontext()
            if trace_dir and bi == len(batches) - 1:
                from real_time_self_adaptive_deep_stereo_torch.utils.profiling import trace

                ctx = trace(trace_dir)
            with ctx:
                secs = time_passes(fwd, iters, passes, cuda)
            pass_fps = [iters * batch / s for s in secs]
            fps = float(np.median(pass_fps))
            tflop = (flops["conv_flop"] + flops["corr_flop"]) / 1e12
            rec = {
                "metric": f"{model_name.lower()}_offline_inference_fps_{h}x{w}",
                "batch": batch,
                "value": fps,
                "unit": "frames/s",
                "precision": mode,
                "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "tflop_per_frame": tflop,
                "conv_tflop_per_frame": flops["conv_flop"] / 1e12,
                "corr_tflop_per_frame": flops["corr_flop"] / 1e12,
                "flop_counter": "FlopCounterMode (convolutions) + the correlations' shapes; no elementwise work",
                "sustained_tflops": tflop * fps,
                # a share of the card's peak; none for a CPU run
                "mfu_vs_h100_bf16_peak": tflop * fps / H100_BF16_PEAK_TFLOPS if cuda else None,
                "peak_tflops": H100_BF16_PEAK_TFLOPS,
                "pass_fps": pass_fps,
                "aggregation": "median",
                "batch_err": err,
                "batch_err_bound": bound,
                "batch_err_kind": kind,
                "batch_max_rel_err": float(np.abs(out - ref[None]).max()) / float(np.abs(ref).max()),
            }
            log(json.dumps(rec))
            recs.append(rec)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--models", default="MADNet,Dispnet")
    ap.add_argument("--batches", default=",".join(map(str, BATCHES)))
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--precision", default="bf16_act")
    ap.add_argument("--trace", default="", help="profiler logdir for the last (model, batch)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    models = args.models.split(",")
    batches = [int(b) for b in args.batches.split(",")]
    for i, name in enumerate(models):
        run(name, batches, args.iters, args.passes, args.height, args.width, args.precision,
            args.trace if i == len(models) - 1 else None, args.device)
    if args.trace:
        from real_time_self_adaptive_deep_stereo_torch.utils.profiling import summarize_trace

        print(f"\nper-op attribution of the last combination ({models[-1]}, batch {batches[-1]}):")
        print(f"{'op family':<48}{'count':>8}{'total ms':>12}")
        for name, count, ms in summarize_trace(args.trace, top=25):
            print(f"{name:<48}{count:>8}{ms:>12.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
