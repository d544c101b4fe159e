#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its main paths on one GPU.

    python3 chip_smoke.py [--profile DIR] [--kernels-only]

Phases, each of which raises on failure (nothing is caught):

1. The card's name and power limit (``nvidia-smi``) and the TF32 flags,
   which must be off: the port runs the JAX package's ``highest``
   precision, fp32.
2. Build every CUDA kernel from ``csrc/`` (one ``nvcc`` per source, all
   started together) and print the build time and the ptxas report.
3. Each of the six kernels at every shape the main paths give it, against
   its plain PyTorch version on the card, with offsets outside the clamp
   windows: the three forward kernels, and the three backward kernels
   (``dx``, ``dy``; ``dimg``, ``ddisp``; ``dfeats``, ``ddx``), each of
   which must also give bit-identical outputs in two runs. Prints its
   time (median of CUDA-event-timed replays of a CUDA graph), its bound
   (bytes over 3.35 TB/s, or fp32 operations over 67 TFLOP/s, whichever
   is larger), the plain version's time and, for the warps, the time of
   ``F.grid_sample`` (forward) or of its backward on the same sampling,
   as a yardstick that the port never calls.
4. The NONE-mode online session of full-width MADNet at 320x1216, the
   ``cli/adapt.py`` default frame size: seeded weights made with numpy in
   the JAX layout and carried over with ``params_from_jax``, synthetic
   frames whose right image is the left one shifted by a known
   disparity. The launch counters are set to 0 just before the session
   and must read 5 / 1 / 4 forward launches per frame after it, and no
   backward launch. Then one frame runs again with the plain modes on
   the card, and the disparities must agree within 1e-4 of the largest.
5. MAD adaptation as ``cli/adapt.py`` runs it: MADNet with the bulkhead,
   momentum, lr 1e-4, ``block_config/MadNet_full.json``, the SEQUENTIAL
   sampler so that every block is trained, 15 frames. Per frame: 5 / 2 / 4
   forward launches (the image warp runs in the block loss and in the
   full loss) and, for block i, 1 correlation backward, 1 image-warp
   backward and 1 feature-warp backward (none for block 0); finite loss
   and disparity; exactly the sampled block's parameters change; the
   scores move. Then FULL adaptation without the bulkhead, 5 frames:
   5 / 1 / 4 forward and 5 / 1 / 4 backward launches per frame, a
   gradient reaches every parameter. Then one MAD step (block 4) and one FULL step from
   the same weights with the kernels and with the plain modes on the
   card: the parameter changes must agree within 1e-4 of the largest.
   Last, one frame with a loss threshold below every loss: the reset
   safeguard must restore the pristine weights.

Prints the card line, the ms/frame of NONE, MAD and FULL, a JSON line of
the six kernels, and as the last line
``{"ok": true, "device": {"platform": "gpu", ...}}``. Exits non-zero,
with no result, when no CUDA device is available or the port is missing.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

H, W = 320, 1216  # cli/adapt.py default frame size
N_FRAMES_NONE = 5
N_FRAMES_MAD = 15  # three SEQUENTIAL rounds; the first carries cuDNN's set-up of each block's backward
N_FRAMES_FULL = 5
LR = 1e-4
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
# backward kernels: of the largest entry of each gradient. They add in a
# fixed order; the plain versions (autograd, whose scatter uses atomics on
# the card) in another.
BWD_RTOL = 1e-5
# one step, kernels vs plain modes: the gradient and the parameter change,
# each of its largest entry
STEP_RTOL = 5e-4

_JAX_OPS = "real_time_self_adaptive_deep_stereo_tpu/ops"
REPLACES = {
    "corr_fwd": f"{_JAX_OPS}/correlation.py:53",
    "warp_image_fwd": f"{_JAX_OPS}/warp_pallas.py:69",
    "warp_features_fwd": f"{_JAX_OPS}/warp_pallas.py:247",
    # no Pallas kernel: the plain-jnp backward of the custom_vjp around _corr_fwd_kernel
    "corr_bwd": f"{_JAX_OPS}/correlation.py:117",
    "warp_image_bwd": f"{_JAX_OPS}/warp_pallas.py:99",
    "warp_features_bwd": f"{_JAX_OPS}/warp_pallas.py:271",
}
_CSRC = "real_time_self_adaptive_deep_stereo_torch/csrc"
SOURCES = {
    name: f"{_CSRC}/correlation.cu" if name.startswith("corr") else f"{_CSRC}/warp.cu"
    for name in REPLACES
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
def assert_grad_close(got, want, what):
    scale = float(want.abs().max())
    if not scale > 0:
        raise AssertionError(f"{what}: the plain gradient is all zero")
    err = float((got - want).abs().max())
    if not err <= BWD_RTOL * scale:
        raise AssertionError(f"{what}: max abs err {err:.3g} > {BWD_RTOL} * {scale:.3g}")
    return err


def assert_same_bits(first, second, what):
    for a, b in zip(first, second):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: two runs on the same input differ")


def check_kernels(ops):
    """Every kernel at its main-path shapes against its plain version."""
    import torch.nn.functional as F

    rows = {name: [] for name in REPLACES}
    k = 2 * RADIUS + 1
    for i, (c, f) in enumerate(CORR_LEVELS):
        shape = (1, c, H // f, W // f)
        n = shape[2] * shape[3]
        x, y = seeded(shape, 10 + i), seeded(shape, 20 + i)
        got, want = ops.correlation_cuda(x, y, RADIUS), ops.correlation_torch(x, y, RADIUS)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **CORR_TOL)
        rows["corr_fwd"].append(dict(
            shape=list(shape), err=float((got - want).abs().max()), tol=CORR_TOL,
            ms=time_ms(lambda: ops.correlation_cuda(x, y, RADIUS)),
            call_ms=call_ms(lambda: ops.correlation_cuda(x, y, RADIUS)),
            plain_ms=time_ms(lambda: ops.correlation_torch(x, y, RADIUS)),
            library_ms=None,
            bound=bound(4.0 * n * (2 * c + k), 2.0 * n * c * k),
        ))

        g = seeded((1, k, *shape[2:]), 60 + i)
        got = ops.correlation_bwd_cuda(x, y, g, RADIUS)
        again = ops.correlation_bwd_cuda(x, y, g, RADIUS)
        want = ops.correlation_torch_bwd(x, y, g, RADIUS)
        torch.cuda.synchronize()
        errs = [assert_grad_close(a, b, f"corr_bwd {shape} {nm}") for a, b, nm in zip(got, want, ("dx", "dy"))]
        assert_same_bits(got, again, f"corr_bwd {shape}")
        rows["corr_bwd"].append(dict(
            shape=list(shape), err=max(errs), tol=f"{BWD_RTOL} of the largest entry",
            ms=time_ms(lambda: ops.correlation_bwd_cuda(x, y, g, RADIUS)),
            call_ms=call_ms(lambda: ops.correlation_bwd_cuda(x, y, g, RADIUS)),
            plain_ms=time_ms(lambda: ops.correlation_torch_bwd(x, y, g, RADIUS)),
            library_ms=None,
            # reads x, y, g once, writes dx, dy; 3 flops per (element, shift) and output
            bound=bound(4.0 * n * (4 * c + k), 6.0 * n * c * k),
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
    rows["warp_image_bwd"].append(check_warp_bwd(
        "warp_image_bwd", img, disp, 70, grid, "border",
        lambda s, o, g, **kw: ops.warp_image_bwd_cuda(s, o, g, MAX_DISP, **kw),
        lambda s, o: ops.warp_image_clamped(s, o, MAX_DISP),
        main_path=dict(need_img=False),  # the right image takes no gradient
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
        rows["warp_features_bwd"].append(check_warp_bwd(
            "warp_features_bwd", feats, dx, 80 + i, grid, "zeros",
            lambda s, o, g, neg=neg, **kw: ops.warp_features_bwd_cuda(s, o, g, neg, MAX_POS, **kw),
            lambda s, o, neg=neg: ops.warp_features_clamped(s, o, neg, MAX_POS),
            main_path=dict(need_dx=False),  # with the bulkhead the offset takes no gradient
        ))

    for name, rs in rows.items():
        for r in rs:
            r["bound_ms"], r["bound_by"] = r.pop("bound")
            log(f"kernel {name} {r}")
    return rows


def check_warp_bwd(name, src, off, seed, grid, padding, kernel, plain_fwd, main_path):
    """One warp backward kernel at one shape: both gradients against
    autograd through the plain version, two runs bit-identical, times."""
    import torch.nn.functional as F

    _, c, h, w = src.shape
    g = seeded(tuple(src.shape), seed)
    got = kernel(src, off, g)
    again = kernel(src, off, g)
    src_g, off_g = src.clone().requires_grad_(), off.clone().requires_grad_()
    plain_out = plain_fwd(src_g, off_g)
    plain = lambda: torch.autograd.grad(plain_out, (src_g, off_g), g, retain_graph=True)  # noqa: E731
    want = plain()
    torch.cuda.synchronize()
    errs = [assert_grad_close(a, b, f"{name} {tuple(src.shape)} {nm}")
            for a, b, nm in zip(got, want, ("dsrc", "doff"))]
    assert_same_bits(got, again, f"{name} {tuple(src.shape)}")
    # the variant the main path runs most: one gradient only
    part = kernel(src, off, g, **main_path)
    for a, b in zip(part, got):
        if a is not None and not torch.equal(a, b):
            raise AssertionError(f"{name}: one gradient alone differs from both together")
    # yardstick: grid_sample's backward (source and grid) on the same sampling
    grid_g = grid.clone().requires_grad_()
    lib_out = F.grid_sample(src_g, grid_g, "bilinear", padding, align_corners=True)
    lib = lambda: torch.autograd.grad(lib_out, (src_g, grid_g), g, retain_graph=True)  # noqa: E731
    n = h * w
    return dict(
        shape=list(src.shape), err=max(errs), tol=f"{BWD_RTOL} of the largest entry",
        ms=time_ms(lambda: kernel(src, off, g)),
        call_ms=call_ms(lambda: kernel(src, off, g)),
        main_path_ms=time_ms(lambda: kernel(src, off, g, **main_path)),
        main_path_variant=main_path,
        # autograd's backward alone (its graph is built once beforehand),
        # timed eagerly: time_ms's CUDA graph does not capture autograd
        plain_ms=call_ms(plain, 50),
        library_ms=call_ms(lib, 50),
        # reads source, offset, g once, writes both gradients; per pixel and
        # channel 4 flops in the offset gradient, 4 in the source gradient
        bound=bound(4.0 * n * (3 * c + 2), 8.0 * c * n),
    )


# ------------------------------------------------------------- phases 4 and 5
def seeded_jax_params(seed: int):
    """MADNet weights in the JAX layout (HWIO ``w``, ``b``), Xavier-uniform
    from a numpy seed, with small non-zero biases. The last conv of every
    estimator gets a bias of -1 (a disparity of 20 px) and, like the last
    conv of the context net, weights scaled by 0.02, so that the random
    part moves the prediction by a few pixels around it. Untamed, these
    random weights predict disparities of thousands of pixels: the final
    relu or the warps' clip then zeroes the gradient of most pixels, a
    block may get none at all, and the few pixels left make the gradient
    so rough that a rounding difference in the forward changes it by
    percents, which no comparison of kernels could see through."""
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
            if layer in ("disp6", "context7"):
                arr *= 0.02
            tree.setdefault(group, {}).setdefault(layer, {})["w"] = arr.astype(np.float32)
        else:
            arr = 0.01 * r.standard_normal(shape) - (1.0 if layer == "disp6" else 0.0)
            tree.setdefault(group, {}).setdefault(layer, {})["b"] = arr.astype(np.float32)
    return tree


def make_frames(n: int, seed: int):
    """Textured left image, right = left shifted by a known disparity d
    (left(x) = right(x - d)), target = d with the first d columns invalid."""
    h, w = H, W
    r = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        d = 8 + 4 * i
        base = (r.random((1, h // 4, (w + d) // 4 + 1, 3)) * 255).astype(np.float32)
        base = np.repeat(np.repeat(base, 4, axis=1), 4, axis=2)[:, :, : w + d]  # 4-pixel texture
        target = np.full((1, h, w, 1), float(d), np.float32)
        target[:, :, :d] = 0.0
        frames.append({"left": base[:, :, :w].copy(), "right": base[:, :, d:].copy(), "target": target})
    return frames


def make_smooth_frame(seed: int, d: int = 12):
    """A stereo pair of smooth texture (six sinusoids per channel), right =
    left shifted by ``d``. The warp's gradient with respect to the disparity,
    v0 - v1, jumps wherever a sample crosses a pixel; on the blocky frames
    of :func:`make_frames` a forward that differs in the seventh digit moves
    enough samples across to change a step's gradient by parts in a
    thousand. On a smooth image neighbouring pixel pairs differ little, and
    a comparison of two backward paths sees the paths."""
    r = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0 : W + d].astype(np.float32)
    base = np.zeros((H, W + d, 3), np.float32)
    for c in range(3):
        for _ in range(6):
            fx, fy = r.uniform(0.005, 0.06, 2)
            px, py = r.uniform(0, 2 * np.pi, 2)
            base[..., c] += r.uniform(10, 40) * np.sin(2 * np.pi * fx * xs + px) * np.cos(
                2 * np.pi * fy * ys + py
            )
    base = np.clip(base + 128, 0, 255).astype(np.float32)[None]
    target = np.full((1, H, W, 1), float(d), np.float32)
    target[:, :, :d] = 0.0
    return {"left": base[:, :, :W].copy(), "right": base[:, :, d:].copy(), "target": target}


def make_session(state, mode, plain=False, **session_kw):
    """A session on the card from the weights ``state``, built through the
    entry points a user calls. MAD gets the bulkhead, as ``cli/adapt.py``
    builds it. ``plain`` swaps the kernels for their plain versions."""
    from real_time_self_adaptive_deep_stereo_torch.adapt import (
        AdaptationEngine,
        OnlineAdaptationSession,
        default_block_config_path,
        load_block_config,
        make_blocks,
    )
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net

    modes = dict(corr_mode="torch", warp_mode="clamped") if plain else {}
    model = get_stereo_net("MADNet", bulkhead=(mode == "MAD"), **modes)  # device cuda
    model.load_state_dict(state)
    blocks = make_blocks(load_block_config(default_block_config_path("MADNet")), model)
    engine = AdaptationEngine(
        model, blocks, lr=LR, optimizer="momentum", warp_mode="clamped" if plain else "auto"
    )
    return OnlineAdaptationSession(engine, mode=mode, **session_kw)


def snapshot(session):
    return {k: v.detach().clone() for k, v in session.engine.model.named_parameters()}


def changed_names(session, before):
    return {k for k, v in session.engine.model.named_parameters() if not torch.equal(v, before[k])}


def check_results(mode, results, step_ms):
    for i, res in enumerate(results):
        vals = [res[k] for k in ("loss", "epe", "bad3", "d1")]
        log(f"{mode} frame {i}: ms {step_ms[i]:.3f} loss {vals[0]:.6f} epe {vals[1]:.4f} "
            f"bad3 {vals[2]:.4f} d1 {vals[3]:.3f}")
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"{mode} frame {i}: non-finite result {vals}")
        if tuple(res["disp"].shape) != (1, H, W, 1) or not torch.isfinite(res["disp"]).all():
            raise AssertionError(f"{mode} frame {i}: bad disparity {tuple(res['disp'].shape)}")


def drive(session, frames, per_frame_launches, after_step=None, warm=1):
    """Step ``session`` over ``frames`` with the launch counters set to 0
    just before and read just after; ``per_frame_launches(i)`` is what
    frame i must add. The first ``warm`` frames carry cuDNN's first-call
    set-up and stay out of the median. Returns (results, ms per step,
    total launches, median ms per steady frame)."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    mode = session.mode
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    results, step_ms, want_total = [], [], dict.fromkeys(cuda_lib.LAUNCHES, 0)
    for i, f in enumerate(frames):
        before_counts = dict(cuda_lib.LAUNCHES)
        before_params = snapshot(session) if after_step else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(session.step(f))  # ends in the one host sync of the frame
        step_ms.append((time.perf_counter() - t0) * 1e3)
        added = {k: cuda_lib.LAUNCHES[k] - before_counts[k] for k in cuda_lib.LAUNCHES}
        want = {**dict.fromkeys(cuda_lib.LAUNCHES, 0), **per_frame_launches(i)}
        if added != want:
            raise AssertionError(f"{mode} frame {i}: launches {added}, want {want}")
        for k, v in want.items():
            want_total[k] += v
        if after_step:
            after_step(i, before_params)
    launches = dict(cuda_lib.LAUNCHES)
    if launches != want_total:
        raise AssertionError(f"{mode}: launch counts {launches}, want {want_total}")
    log(f"session {mode} launches {launches} over {len(frames)} frames")
    check_results(mode, results, step_ms)
    ms = statistics.median(step_ms[warm:])
    log(f"session {mode} {H}x{W}: median {ms:.3f} ms/frame over frames {warm}..{len(frames) - 1}, "
        f"{1e3 / ms:.2f} frames/s; frame 0 {step_ms[0]:.3f} ms; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return results, step_ms, launches, ms


FWD = {"corr_fwd": 5, "warp_image_fwd": 1, "warp_features_fwd": 4}


def run_none(state, profile_dir):
    from real_time_self_adaptive_deep_stereo_torch.adapt import AdaptationEngine
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net

    session = make_session(state, "NONE")
    frames = make_frames(N_FRAMES_NONE, 1)
    results, _, launches, ms = drive(session, frames, lambda i: FWD)

    # the same frame with the plain modes on the card
    model = session.engine.model
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
        profile_frames(session, [frame] * 3, Path(profile_dir), "none")
    return launches, ms


def run_mad(state, profile_dir):
    session = make_session(state, "MAD", sample_mode="SEQUENTIAL", ssim_th=1e9, seed=0)
    blocks = session.engine.blocks
    frames = make_frames(N_FRAMES_MAD, 2)

    def per_frame(i):
        k = i % len(blocks)  # SEQUENTIAL: block i mod 5
        return {
            "corr_fwd": 5, "warp_image_fwd": 2, "warp_features_fwd": 4,  # block loss + full loss
            "corr_bwd": 1, "warp_image_bwd": 1, "warp_features_bwd": 0 if k == 0 else 1,
        }

    def after_step(i, before):
        k = i % len(blocks)
        changed = changed_names(session, before)
        if not changed or not changed <= set(blocks[k].names):
            raise AssertionError(
                f"MAD frame {i}: block {k} was trained but {sorted(changed) or 'nothing'} changed"
            )

    _, step_ms, launches, ms = drive(session, frames, per_frame, after_step, warm=len(blocks))
    if session.stats.fetch_counter != [N_FRAMES_MAD // len(blocks)] * len(blocks):
        raise AssertionError(f"MAD: fetch counter {session.stats.fetch_counter}")
    if not np.all(session.scores[:-1] != 0.0):
        raise AssertionError(f"MAD: the scores did not move: {session.scores}")
    log(f"MAD scores {session.scores.tolist()}")
    by_block = {k: statistics.median(step_ms[k + len(blocks) :: len(blocks)]) for k in range(len(blocks))}
    log(f"MAD ms/frame by block trained (after the first round): {by_block}")
    if profile_dir:
        profile_frames(session, make_frames(len(blocks), 5), Path(profile_dir), "mad")
    return launches, ms


def run_full(state, profile_dir):
    session = make_session(state, "FULL", ssim_th=1e9)
    names = set(dict(session.engine.model.named_parameters()))
    frames = make_frames(N_FRAMES_FULL, 3)

    def per_frame(i):
        return {**FWD, "corr_bwd": 5, "warp_image_bwd": 1, "warp_features_bwd": 4}

    def after_step(i, before):
        # a gradient reaches every parameter; some tensors (scale 6, far from
        # the loss, and the biases of -1) take a step below their float32 spacing
        acc = session.engine.opt["acc"]
        dead = sorted(k for k in names if not bool(acc[k].any()))
        changed = changed_names(session, before)
        log(f"FULL frame {i}: {len(changed)} of {len(names)} tensors changed; "
            f"unchanged {sorted(names - changed)}")
        if dead or len(changed) < 0.5 * len(names):
            raise AssertionError(f"FULL frame {i}: no gradient for {dead}; changed {len(changed)}")

    _, _, launches, ms = drive(session, frames, per_frame, after_step)
    if profile_dir:
        profile_frames(session, frames[:3], Path(profile_dir), "full")
    return launches, ms


def check_steps_against_plain(state):
    """One MAD step (block 4) and one FULL step from the same weights, with
    the kernels and with the plain modes on the card: the parameter
    changes agree within STEP_RTOL of the largest."""
    frame = make_smooth_frame(4)
    for mode, kw in (("MAD", dict(sample_mode="FIXED", fixed_id=4)), ("FULL", {})):
        deltas = []
        for plain in (False, True, False):
            session = make_session(state, mode, plain=plain, ssim_th=1e9, **kw)
            before = snapshot(session)
            res = session.step(frame)
            deltas.append((
                {k: v.detach() - before[k] for k, v in session.engine.model.named_parameters()},
                session.engine.opt["acc"],  # after one momentum step: the gradient
                res["loss"],
            ))
        (fast, fast_acc, fast_loss), (plain_d, plain_acc, plain_loss), (_, again_acc, _) = deltas
        scale = max(float(v.abs().max()) for v in plain_d.values())
        # the change old - lr*acc is rounded to the parameter's float32
        # spacing in each run; the accumulator (the gradient) is not
        err = max(
            float(((fast[k] - plain_d[k]).abs() - torch.finfo(torch.float32).eps * before[k].abs())
                  .clamp(min=0).max())
            for k in plain_d
        )
        g_scale = max(float(v.abs().max()) for v in plain_acc.values())
        g_err = max(float((fast_acc[k] - plain_acc[k]).abs().max()) for k in plain_acc)
        n_moved = sum(bool(v.any()) for v in plain_d.values())
        # what two runs of the same path differ by (cuDNN's backward is not
        # run-to-run deterministic), and where the two paths differ most
        rerun = max(float((fast_acc[k] - again_acc[k]).abs().max()) for k in fast_acc)
        worst = sorted(fast_acc, key=lambda k: -float((fast_acc[k] - plain_acc[k]).abs().max()))[:3]
        log(f"{mode} step: two runs with the kernels differ by {rerun:.3g}; largest "
            f"kernels-vs-plain differences in {worst}")
        log(f"{mode} step kernels vs plain: largest gradient {g_scale:.3g}, max abs err "
            f"{g_err:.3g} ({g_err / g_scale:.3g} of it); largest parameter change {scale:.3g}, "
            f"max abs err beyond one rounding {err:.3g} ({err / scale:.3g} of it); "
            f"{n_moved} tensors moved, loss {fast_loss:.6f} vs {plain_loss:.6f}")
        if not (scale > 0 and err <= STEP_RTOL * scale and g_err <= STEP_RTOL * g_scale):
            raise AssertionError(f"{mode} step: kernels and plain modes disagree")


def check_reset(state):
    """A loss threshold below every loss: the step trains, then the reset
    restores the pristine weights in place and keeps the optimizer state."""
    session = make_session(state, "MAD", sample_mode="SEQUENTIAL", ssim_th=-1.0, seed=0)
    pristine = snapshot(session)
    session.step(make_frames(1, 6)[0])
    if session.stats.reset_counter != 1 or changed_names(session, pristine):
        raise AssertionError("reset: the pristine weights were not restored")
    if not any(bool(a.any()) for a in session.engine.opt["acc"].values()):
        raise AssertionError("reset: the step before it left no optimizer state")
    log("reset safeguard: weights restored, optimizer state kept")


def profile_frames(session, frames, out: Path, tag: str):
    """Kernel time by name over a few steady frames (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for f in frames:
            session.step(f)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=45)
    (out / f"profile_{tag}_frame.txt").write_text(table)
    trace = out / f"profile_{tag}_frame.json"
    prof.export_chrome_trace(str(trace))
    log(f"profile of {len(frames)} {tag} frames")
    log(table)
    summarise_trace(trace, tag, len(frames))


_GROUPS = (  # first match wins
    ("the port's kernels", r"corr_fwd|corr_bwd|warp_fwd_kernel|warp_bwd_"),
    ("cuDNN backward (dgrad, wgrad)", r"dgrad|wgrad"),
    ("cuDNN/cuBLAS convolutions and matmuls, incl. FFT and layout transforms",
     r"fprop|convolve|region_transform|fft|DSE::|gemm|gemv|cudnn|flip_filter"),
    ("PyTorch elementwise, reduce, pad, cat, copy", r"."),
)


def summarise_trace(trace: Path, tag: str, n_frames: int):
    """Device time a frame by kind of kernel, and the host's side, from the
    Chrome trace that torch.profiler wrote."""
    events = [e for e in json.loads(trace.read_text())["traceEvents"] if e.get("ph") == "X"]
    groups = {}
    for e in events:
        if e.get("cat") in ("gpu_memcpy", "gpu_memset"):
            name = "memcpy and memset (the frame's upload from pageable memory)"
        elif e.get("cat") == "kernel":
            name = next(g for g, pat in _GROUPS if re.search(pat, e["name"]))
        else:
            continue
        n, dur = groups.get(name, (0, 0.0))
        groups[name] = (n + 1, dur + e["dur"])
    total = sum(dur for _, dur in groups.values())
    log(f"profile {tag}: device time {total / 1e3 / n_frames:.3f} ms/frame in "
        f"{sum(n for n, _ in groups.values()) / n_frames:.0f} launches/frame")
    for name, (n, dur) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        log(f"profile {tag}: {dur / 1e3 / n_frames:8.3f} ms/frame {100 * dur / total:5.1f}% "
            f"{n / n_frames:7.1f} launches/frame  {name}")
    cpu = [e for e in events if e.get("cat") == "cpu_op"]
    span = max(e["ts"] + e["dur"] for e in cpu) - min(e["ts"] for e in cpu)
    by_thread = {}
    for e in cpu:
        by_thread.setdefault(e["tid"], []).append(e)
    busy = []  # per thread: time inside top-level ops (the autograd thread is the second)
    for es in by_thread.values():
        end = t = 0.0
        for e in sorted(es, key=lambda e: (e["ts"], -e["dur"])):
            if e["ts"] >= end:
                t += e["dur"]
                end = e["ts"] + e["dur"]
        busy.append(t / 1e3 / n_frames)
    log(f"profile {tag}: host span under the profiler {span / 1e3 / n_frames:.2f} ms/frame, "
        f"{len(cpu) / n_frames:.0f} PyTorch ops/frame, busy per thread {sorted(busy, reverse=True)} ms/frame")


# ------------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", default=None, help="write torch.profiler tables and traces here")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernels' checks (phase 3), without the result lines")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from real_time_self_adaptive_deep_stereo_torch import ops
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib
    from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import params_from_jax
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
    if args.kernels_only:
        log("kernels checked; stopping before the sessions (--kernels-only)")
        return 0

    state = params_from_jax(seeded_jax_params(0))
    launches, frame_ms = {}, {}
    for mode, run in (("NONE", run_none), ("MAD", run_mad), ("FULL", run_full)):
        launches[mode], frame_ms[mode] = run(state, args.profile)
    check_steps_against_plain(state)
    check_reset(state)

    kernels = []
    for name, rs in rows.items():
        lib_ms = [r["library_ms"] for r in rs]
        shape_keys = ("shape", "ms", "call_ms", "plain_ms", "bound_ms", "library_ms", "main_path_ms")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            # the flagship path: the MAD session, counters set to 0 before it
            "launches": launches["MAD"][name],
            "launches_by_path": {mode: launches[mode][name] for mode in launches},
            "max_abs_err": max(r["err"] for r in rs),
            # one call at each main-path shape: the sums over the shapes
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rs) else "operations",
            "library_ms": None if None in lib_ms else sum(lib_ms),
            "shapes": [{k: r[k] for k in shape_keys if k in r} for r in rs],
        })
    for mode, ms in frame_ms.items():
        log(f"session {mode} ms/frame {ms!r}")
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
