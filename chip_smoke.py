#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its main path on one GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, each of which raises on failure (nothing is caught):

1. The card's name and power limit (``nvidia-smi``) and the TF32 flags,
   which must be off: the port runs the JAX package's ``highest``
   precision, fp32.
2. Build every CUDA kernel from ``csrc/`` (one ``nvcc`` per source, all
   started together) and print the build time and the ptxas report.
3. Each kernel at every shape the main path gives it, against its plain
   PyTorch version on the card, with disparities outside the clamp
   windows. Prints its time (median of CUDA-event-timed runs), its bound
   (bytes over 3.35 TB/s, or fp32 operations over 67 TFLOP/s, whichever
   is larger), the plain version's time and, for the warps, the time of
   ``F.grid_sample`` on the same sampling as a yardstick (never called
   by the port).
4. The NONE-mode online session of full-width MADNet at 320x1216, the
   ``cli/adapt.py`` default frame size: seeded weights made with numpy in
   the JAX layout and carried over with ``params_from_jax``, synthetic
   frames whose right image is the left one shifted by a known
   disparity. The launch counters are set to 0 just before the session
   and must read 5 / 1 / 4 launches per frame after it. Then one frame
   runs again with the plain modes on the card, and the disparities must
   agree within 1e-4 of the largest.

Prints the card line, a JSON line of the kernels, and as the last line
``{"ok": true, "device": {"platform": "gpu", ...}}``. Exits non-zero,
with no result, when no CUDA device is available or the port is missing.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

H, W = 320, 1216  # cli/adapt.py default frame size
N_FRAMES = 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores, published
RADIUS = 2  # MADNet radius_d
MAX_DISP = 192  # warp_max_disp
MAX_POS = 4
# MADNet's main-path shapes (NCHW) at 320x1216: (level channels, downscale factor)
CORR_LEVELS = [(192, 64), (128, 32), (96, 16), (64, 8), (32, 4)]  # scales 6..2
FEAT_LEVELS = CORR_LEVELS[1:]  # the feature warp runs at scales 5..2
CORR_TOL = dict(rtol=1e-5, atol=1e-5)  # fp32 sums over C in another order
WARP_TOL = dict(rtol=0.0, atol=1e-6)  # same roundings as the plain version
MODEL_RTOL = 1e-4  # of the largest disparity; the JAX package's figure vs TF1

REPLACES = {
    "corr_fwd": "real_time_self_adaptive_deep_stereo_tpu/ops/correlation.py:53",
    "warp_image_fwd": "real_time_self_adaptive_deep_stereo_tpu/ops/warp_pallas.py:69",
    "warp_features_fwd": "real_time_self_adaptive_deep_stereo_tpu/ops/warp_pallas.py:247",
}
SOURCES = {
    "corr_fwd": "real_time_self_adaptive_deep_stereo_torch/csrc/correlation.cu",
    "warp_image_fwd": "real_time_self_adaptive_deep_stereo_torch/csrc/warp.cu",
    "warp_features_fwd": "real_time_self_adaptive_deep_stereo_torch/csrc/warp.cu",
}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps: int = 20, inner: int = 20) -> float:
    """Device time of one call of ``fn``: ``inner`` calls are captured in a
    CUDA graph, and the median over ``reps`` CUDA-event-timed replays is
    divided by ``inner``. The graph takes the host's launch cost out, so
    kernel, plain version and library call are timed alike."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def call_ms(fn, reps: int = 200) -> float:
    """Time of one eager call as the main path makes it, launch cost
    included: ``reps`` calls between two CUDA events, per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_flops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def seeded(shape, seed, lo=None, hi=None):
    r = np.random.default_rng(seed)
    a = r.standard_normal(shape) if lo is None else r.random(shape) * (hi - lo) + lo
    return torch.from_numpy(a.astype(np.float32)).cuda()


def grid_for(shift: torch.Tensor, sign: float) -> torch.Tensor:
    """grid_sample grid (align_corners=True) sampling row h at x + sign*shift."""
    b, _, h, w = shift.shape
    xs = torch.arange(w, device=shift.device, dtype=torch.float32)
    ys = torch.arange(h, device=shift.device, dtype=torch.float32)
    gx = (xs + sign * shift[:, 0]) * (2.0 / (w - 1)) - 1.0
    gy = (ys * (2.0 / (h - 1)) - 1.0)[None, :, None].expand(b, h, w)
    return torch.stack([gx, gy], dim=-1).contiguous()


# ------------------------------------------------------------------ phase 3
def check_kernels(ops):
    """Every kernel at its main-path shapes against its plain version."""
    import torch.nn.functional as F

    rows = {name: [] for name in REPLACES}
    for i, (c, f) in enumerate(CORR_LEVELS):
        shape = (1, c, H // f, W // f)
        x, y = seeded(shape, 10 + i), seeded(shape, 20 + i)
        got, want = ops.correlation_cuda(x, y, RADIUS), ops.correlation_torch(x, y, RADIUS)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **CORR_TOL)
        k = 2 * RADIUS + 1
        n = shape[2] * shape[3]
        rows["corr_fwd"].append(dict(
            shape=list(shape), err=float((got - want).abs().max()), tol=CORR_TOL,
            ms=time_ms(lambda: ops.correlation_cuda(x, y, RADIUS)),
            call_ms=call_ms(lambda: ops.correlation_cuda(x, y, RADIUS)),
            plain_ms=time_ms(lambda: ops.correlation_torch(x, y, RADIUS)),
            library_ms=None,
            bound=bound(4.0 * n * (2 * c + k), 2.0 * n * c * k),
        ))

    img = seeded((1, 3, H, W), 30)
    disp = seeded((1, 1, H, W), 31, -20.0, MAX_DISP + 40.0)  # crosses 0 and max_disp
    got, want = ops.warp_image_cuda(img, disp, MAX_DISP), ops.warp_image_clamped(img, disp, MAX_DISP)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **WARP_TOL)
    grid = grid_for(disp.clamp(0.0, MAX_DISP), -1.0)
    lib = lambda: F.grid_sample(img, grid, "bilinear", "border", align_corners=True)  # noqa: E731
    rows["warp_image_fwd"].append(dict(
        shape=list(img.shape), err=float((got - want).abs().max()), tol=WARP_TOL,
        lib_err=float((lib() - want).abs().max()),
        ms=time_ms(lambda: ops.warp_image_cuda(img, disp, MAX_DISP)),
        call_ms=call_ms(lambda: ops.warp_image_cuda(img, disp, MAX_DISP)),
        plain_ms=time_ms(lambda: ops.warp_image_clamped(img, disp, MAX_DISP)),
        library_ms=time_ms(lib),
        bound=bound(4.0 * H * W * (3 + 1 + 3), 3.0 * 3 * H * W),
    ))

    for i, (c, f) in enumerate(FEAT_LEVELS):
        shape = (1, c, H // f, W // f)
        neg = -(-MAX_DISP // f)
        feats = seeded(shape, 40 + i)
        dx = seeded((1, 1, *shape[2:]), 50 + i, -neg - 10.0, MAX_POS + 6.0)  # outside the window
        got = ops.warp_features_cuda(feats, dx, neg, MAX_POS)
        want = ops.warp_features_clamped(feats, dx, neg, MAX_POS)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **WARP_TOL)
        grid = grid_for(dx.clamp(-neg, MAX_POS), 1.0)
        lib = lambda: F.grid_sample(feats, grid, "bilinear", "zeros", align_corners=True)  # noqa: E731
        n = shape[2] * shape[3]
        rows["warp_features_fwd"].append(dict(
            shape=list(shape), max_neg=neg, err=float((got - want).abs().max()), tol=WARP_TOL,
            lib_err=float((lib() - want).abs().max()),
            ms=time_ms(lambda: ops.warp_features_cuda(feats, dx, neg, MAX_POS)),
            call_ms=call_ms(lambda: ops.warp_features_cuda(feats, dx, neg, MAX_POS)),
            plain_ms=time_ms(lambda: ops.warp_features_clamped(feats, dx, neg, MAX_POS)),
            library_ms=time_ms(lib),
            bound=bound(4.0 * n * (2 * c + 1), 3.0 * c * n),
        ))

    for name, rs in rows.items():
        for r in rs:
            r["bound_ms"], r["bound_by"] = r.pop("bound")
            log(f"kernel {name} {r}")
    return rows


# ------------------------------------------------------------------ phase 4
def seeded_jax_params(seed: int):
    """MADNet weights in the JAX layout (HWIO ``w``, ``b``), Xavier-uniform
    from a numpy seed, with small non-zero biases."""
    from real_time_self_adaptive_deep_stereo_torch.models import MADNet

    shapes = {k: tuple(v.shape) for k, v in MADNet(device="cpu").state_dict().items()}
    r = np.random.default_rng(seed)
    tree = {}
    for key, shape in sorted(shapes.items()):
        group, layer, leaf = key.split(".")
        if leaf == "weight":
            cout, cin, kh, kw = shape
            lim = math.sqrt(6.0 / (kh * kw * (cin + cout)))
            arr = r.uniform(-lim, lim, (kh, kw, cin, cout))
            tree.setdefault(group, {}).setdefault(layer, {})["w"] = arr.astype(np.float32)
        else:
            arr = 0.01 * r.standard_normal(shape)
            tree.setdefault(group, {}).setdefault(layer, {})["b"] = arr.astype(np.float32)
    return tree


def make_frames(n: int, seed: int):
    """Textured left image, right = left shifted by a known disparity d
    (left(x) = right(x - d)), target = d with the first d columns invalid."""
    r = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        d = 8 + 4 * i
        base = (r.random((1, H // 4, (W + d) // 4 + 1, 3)) * 255).astype(np.float32)
        base = np.repeat(np.repeat(base, 4, axis=1), 4, axis=2)[:, :, : W + d]  # 4-pixel texture
        target = np.full((1, H, W, 1), float(d), np.float32)
        target[:, :, :d] = 0.0
        frames.append({"left": base[:, :, :W].copy(), "right": base[:, :, d:].copy(), "target": target})
    return frames


def run_session(n_frames: int, profile_dir):
    from real_time_self_adaptive_deep_stereo_torch.adapt import AdaptationEngine, OnlineAdaptationSession
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib
    from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import params_from_jax

    state = params_from_jax(seeded_jax_params(0))
    model = get_stereo_net("MADNet")  # device cuda, corr/warp modes 'auto' -> the kernels
    model.load_state_dict(state)
    session = OnlineAdaptationSession(AdaptationEngine(model), mode="NONE")
    frames = make_frames(n_frames, 1)

    cuda_lib.reset_launches()
    step_ms, results = [], []
    for f in frames:
        t0 = time.perf_counter()
        results.append(session.step(f))  # ends in the one host sync of the frame
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(cuda_lib.LAUNCHES)
    log(f"session launches {launches} over {n_frames} frames")
    want = {"corr_fwd": 5 * n_frames, "warp_image_fwd": n_frames, "warp_features_fwd": 4 * n_frames}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, want {want}")

    for i, res in enumerate(results):
        vals = [res[k] for k in ("loss", "epe", "bad3", "d1")]
        log(f"frame {i}: ms {step_ms[i]:.3f} loss {vals[0]:.6f} epe {vals[1]:.4f} "
            f"bad3 {vals[2]:.4f} d1 {vals[3]:.3f}")
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"frame {i}: non-finite result {vals}")
        if tuple(res["disp"].shape) != (1, H, W, 1) or not torch.isfinite(res["disp"]).all():
            raise AssertionError(f"frame {i}: bad disparity {tuple(res['disp'].shape)}")
    steady = step_ms[1:]  # frame 0 carries cuDNN's first-call set-up
    ms = statistics.median(steady)
    log(f"session NONE {H}x{W}: median {ms:.3f} ms/frame over frames 1..{n_frames - 1}, "
        f"{1e3 / ms:.2f} frames/s; frame 0 {step_ms[0]:.3f} ms; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # the same frame with the plain modes on the card
    plain = get_stereo_net("MADNet", corr_mode="torch", warp_mode="clamped")
    plain.load_state_dict(state)
    plain_engine = AdaptationEngine(plain, warp_mode="clamped")
    frame = frames[-1]
    with torch.no_grad():
        fast_out = model(*(torch.from_numpy(frame[k]).cuda() for k in ("left", "right")))
        plain_out = plain(*(torch.from_numpy(frame[k]).cuda() for k in ("left", "right")))
    for i, (a, b) in enumerate(zip(fast_out["disparities"], plain_out["disparities"])):
        scale = max(float(b.abs().max()), 1e-6)
        err = float((a - b).abs().max())
        log(f"disparities[{i}] kernels vs plain: max {scale:.4f}, "
            f"share > 0 {float((b > 0).float().mean()):.3f}, max abs err {err:.3g}")
        torch.testing.assert_close(a, b, rtol=MODEL_RTOL, atol=MODEL_RTOL * scale)
    plain_res = plain_engine.infer(frame)
    torch.testing.assert_close(
        torch.tensor(results[-1]["loss"]), plain_res["loss"].cpu(), rtol=1e-4, atol=0.0
    )
    log(f"loss kernels {results[-1]['loss']:.6f} plain {float(plain_res['loss']):.6f}")

    if profile_dir:
        profile_frame(session, frame, Path(profile_dir))
    return launches, ms


def profile_frame(session, frame, out: Path):
    """Kernel time by name over 3 steady frames (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            session.step(frame)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    (out / "profile_none_frame.txt").write_text(table)
    prof.export_chrome_trace(str(out / "profile_none_frame.json"))
    log(table)


# ------------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", default=None, help="write a torch.profiler table and trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from real_time_self_adaptive_deep_stereo_torch import ops
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib
    from real_time_self_adaptive_deep_stereo_torch.utils.device import resolve_device

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    resolve_device("cuda")  # sets TF32 off for cuDNN and cuBLAS
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; tf32 matmul/cudnn {tf32}")
    if any(tf32):
        raise AssertionError("TF32 must be off")

    t0 = time.perf_counter()
    cuda_lib.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(cuda_lib.BUILD_LOGS) or 'cached'}")
    for name, text in cuda_lib.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    rows = check_kernels(ops)
    launches, frame_ms = run_session(N_FRAMES, args.profile)

    kernels = []
    for name, rs in rows.items():
        lib_ms = [r["library_ms"] for r in rs]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max(r["err"] for r in rs),
            # one frame's work: the sums over the main-path shapes
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rs) else "operations",
            "library_ms": None if None in lib_ms else sum(lib_ms),
            "shapes": [{k: r[k] for k in ("shape", "ms", "call_ms", "plain_ms", "bound_ms", "library_ms")} for r in rs],
        })
    log(f"session NONE ms/frame {frame_ms!r}")
    log(card)  # name, power limit
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
