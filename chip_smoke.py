#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its main paths on one GPU.

    python3 chip_smoke.py [--profile DIR] [--kernels-only | --fused-only]

Phases, each of which raises on failure (nothing is caught):

1. The card's name and power limit (``nvidia-smi``) and the TF32 flags,
   which must be off: the port runs the JAX package's ``highest``
   precision, fp32.
2. Build every CUDA kernel from ``csrc/`` (one ``nvcc`` per source, all
   started together) and print the build time and the ptxas report, and
   apart the registers and spills of the two tiled forwards.
3. Each of the ten kernels at every shape the main paths give it, against
   its plain PyTorch version on the card, with offsets outside the clamp
   windows: the five forward kernels, and the five backward kernels
   (``dx``, ``dy``; ``dimg``, ``ddisp``; ``dfeats``, ``ddx``), each of
   which must also give bit-identical outputs in two runs. The tiled
   one-hot warps (``csrc/warp_tile.cu``) are held against the one-hot
   products and against the clamped-window kernels, which compute the
   same function (the image warps bit for bit). Prints each kernel's
   time (median of CUDA-event-timed replays of a CUDA graph), its bound
   (bytes over 3.35 TB/s, or fp32 operations over 67 TFLOP/s, whichever
   is larger), the plain version's time and, for the warps, a yardstick
   that the port never calls, timed from a CUDA graph too:
   ``F.grid_sample`` (forward) or its backward op
   ``aten.grid_sampler_2d_backward`` on the same sampling. A warp backward
   is timed twice, with both gradients and with the one the main path
   asks for, each beside the op with the same output mask. Per kernel it
   prints its time summed over its shapes as a ratio to that yardstick's
   sum, for a backward kernel also the main path's variant's.
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
   sampler so that every block is trained, 10 frames. Per frame: 5 / 2 / 4
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
6. The fused device session (``adapt/fused.py``: flat arena, controller
   on the device, one CUDA graph per branch) at 320x1216 with
   ``warp_mode='mxu'`` in model and loss, on smooth stereo pairs. MAD with
   the bulkhead, SEQUENTIAL, 20 frames: the first two rounds are checked
   frame by frame (5 correlation, 2 + 4 tiled forward, 1 correlation
   backward and 1 + 1 tiled backward launches, none of the latter for
   block 0, and none of the clamped-window kernels; exactly the sampled
   block's arena range moves; each graph holds its block's launches), the
   last two run with ``torch.cuda.set_sync_debug_mode("error")``, so a host
   sync in the steady state raises. ``finalize()``'s loss, EPE, fetch
   counter and scores and the adapted weights must agree with the host
   session over the same frames, weights and warp mode, and with the same
   fused session run eagerly (``use_graphs=False``); ``step_chunk`` over
   two chunks of 5 must equal 10 steps, and the ``shared_forward`` session
   (one graph) must follow the same trajectory. Then 8 frames of PROBABILITY,
   FULL (5 / 1 + 4 / 5 / 1 + 4 launches a frame) against the host
   session, NONE with metrics (1 + 4) and NONE without through ``serve``
   (0 + 4; each served disparity is its own frame's), and the reset on the
   device under a threshold below every loss.

Prints the card line, the ms/frame of the host and the fused sessions by
mode, a JSON line of the ten kernels, and as the last line
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
N_FRAMES_MAD = 10  # two SEQUENTIAL rounds; the first carries cuDNN's set-up of each block's backward
N_FRAMES_FUSED = 20  # four rounds: two checked frame by frame, two free-running
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
# tiled kernels against the one-hot product, whose matmul may fuse the
# second product into the sum (one rounding of w1*b less): an ulp of the
# largest source value, which for unit-normal sources stays under 5
ONEHOT_TOL = dict(rtol=0.0, atol=2e-6)
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
    # one Pallas kernel each way serves both samplings; the port gives each its entry point
    "warp_tile_image_fwd": f"{_JAX_OPS}/warp_pallas.py:460",
    "warp_tile_features_fwd": f"{_JAX_OPS}/warp_pallas.py:460",
    "warp_tile_image_bwd": f"{_JAX_OPS}/warp_pallas.py:495",
    "warp_tile_features_bwd": f"{_JAX_OPS}/warp_pallas.py:495",
}
_CSRC = "real_time_self_adaptive_deep_stereo_torch/csrc"
SOURCES = {
    name: f"{_CSRC}/{'correlation' if name.startswith('corr') else 'warp_tile' if 'tile' in name else 'warp'}.cu"
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


PADDING_MODES = {"zeros": 0, "border": 1}  # aten's codes of grid_sample's padding_mode


def grid_sample_bwd(g, src, grid, padding: str, mask):
    """The backward of ``F.grid_sample(src, grid, "bilinear", padding,
    align_corners=True)`` for the output gradient ``g``, as the one op that
    autograd runs for it: ``(dsrc, dgrid)``, where ``mask`` says which are
    asked for. Unlike ``torch.autograd.grad``, a CUDA graph captures it
    like any kernel. A gradient that is not asked for is None; the op
    computes the grid's all the same, on the CPU and on the card."""
    dsrc, dgrid = torch.ops.aten.grid_sampler_2d_backward(
        g, src, grid, 0, PADDING_MODES[padding], True, list(mask)
    )
    return (dsrc if mask[0] else None), (dgrid if mask[1] else None)


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
        lambda s, o, g, need=(True, True): ops.warp_image_bwd_cuda(s, o, g, MAX_DISP, *need),
        lambda s, o: ops.warp_image_clamped(s, o, MAX_DISP),
        main_path=(False, True),  # ddisp alone: the right image takes no gradient
    ))

    # the tiled one-hot image warp: against its plain version (the one-hot
    # product over the padded row) and against warp_image_fwd / warp_image_bwd,
    # which compute the same function
    got = ops.warp_image_mxu(img, disp, MAX_DISP)
    want = ops.warp_image_onehot(img, disp, MAX_DISP, align=128)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **ONEHOT_TOL)
    if not torch.equal(got, ops.warp_image_cuda(img, disp, MAX_DISP)):
        raise AssertionError("warp_tile_image_fwd: differs from warp_image_fwd, a gather of the same taps")
    rows["warp_tile_image_fwd"].append(dict(
        shape=list(img.shape), err=float((got - want).abs().max()), tol=ONEHOT_TOL,
        lib_err=float((lib() - want).abs().max()),
        ms=time_ms(lambda: ops.warp_image_mxu(img, disp, MAX_DISP)),
        call_ms=call_ms(lambda: ops.warp_image_mxu(img, disp, MAX_DISP)),
        plain_ms=time_ms(lambda: ops.warp_image_onehot(img, disp, MAX_DISP, align=128), inner=2),
        library_ms=time_ms(lib),
        bound=bound(4.0 * H * W * (3 + 1 + 3), 3.0 * 3 * H * W),
    ))
    rows["warp_tile_image_bwd"].append(check_warp_bwd(
        "warp_tile_image_bwd", img, disp, 70, grid, "border",
        lambda s, o, g, need=(True, True): ops.warp_image_mxu_bwd(s, o, g, MAX_DISP, *need),
        lambda s, o: ops.warp_image_onehot(s, o, MAX_DISP, align=128),
        main_path=(False, True),
        same_as=lambda s, o, g: ops.warp_image_bwd_cuda(s, o, g, MAX_DISP),
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
            lambda s, o, g, need=(True, True), neg=neg: ops.warp_features_bwd_cuda(
                s, o, g, neg, MAX_POS, *need),
            lambda s, o, neg=neg: ops.warp_features_clamped(s, o, neg, MAX_POS),
            main_path=(True, False),  # dfeats alone: with the bulkhead the offset takes no gradient
        ))

        got = ops.warp_features_mxu(feats, dx, neg, MAX_POS)
        want = ops.warp_features_onehot(feats, dx, neg, MAX_POS, align=128)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **ONEHOT_TOL)
        torch.testing.assert_close(got, ops.warp_features_cuda(feats, dx, neg, MAX_POS), **WARP_TOL)
        rows["warp_tile_features_fwd"].append(dict(
            shape=list(shape), max_neg=neg, err=float((got - want).abs().max()), tol=ONEHOT_TOL,
            lib_err=float((lib() - want).abs().max()),
            ms=time_ms(lambda: ops.warp_features_mxu(feats, dx, neg, MAX_POS)),
            call_ms=call_ms(lambda: ops.warp_features_mxu(feats, dx, neg, MAX_POS)),
            plain_ms=time_ms(lambda: ops.warp_features_onehot(feats, dx, neg, MAX_POS, align=128)),
            library_ms=time_ms(lib),
            bound=bound(4.0 * n * (2 * c + 1), 3.0 * c * n),
        ))
        rows["warp_tile_features_bwd"].append(check_warp_bwd(
            "warp_tile_features_bwd", feats, dx, 80 + i, grid, "zeros",
            lambda s, o, g, need=(True, True), neg=neg: ops.warp_features_mxu_bwd(
                s, o, g, neg, MAX_POS, *need),
            lambda s, o, neg=neg: ops.warp_features_onehot(s, o, neg, MAX_POS, align=128),
            main_path=(True, False),
            same_as=lambda s, o, g, neg=neg: ops.warp_features_bwd_cuda(s, o, g, neg, MAX_POS),
        ))

    for name, rs in rows.items():
        for r in rs:
            r["bound_ms"], r["bound_by"] = r.pop("bound")
            log(f"kernel {name} {r}")
    for name, rs in rows.items():  # summed over the main-path shapes
        ms, lib_ms = sum(r["ms"] for r in rs), [r["library_ms"] for r in rs]
        ratio = "no library call" if None in lib_ms else f"{ms / sum(lib_ms):.3f} of the library's {sum(lib_ms):.5f} ms"
        if "main_path_ms" in rs[0]:
            mp, mp_lib = sum(r["main_path_ms"] for r in rs), sum(r["main_path_library_ms"] for r in rs)
            ratio += (f"; the main path's variant {rs[0]['main_path_mask']} {mp:.5f} ms, "
                      f"{mp / mp_lib:.3f} of the library's {mp_lib:.5f} ms")
        log(f"kernel {name}: {ms:.5f} ms over {len(rs)} shape(s), {ratio}")
    return rows


def check_warp_bwd(name, src, off, seed, grid, padding, kernel, plain_fwd, main_path, same_as=None):
    """One warp backward kernel at one shape: both gradients against
    autograd through the plain version (and against ``same_as``, another
    kernel of the same function, where given), two runs bit-identical,
    times. ``kernel(src, off, g, need)`` takes the pair (dsrc, doff) of
    gradients asked for; ``main_path`` is the pair the main path asks for,
    and the yardstick ``grid_sample_bwd`` is timed with the same mask."""
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
    if same_as is not None:
        for a, b, nm in zip(got, same_as(src, off, g), ("dsrc", "doff")):
            assert_grad_close(a, b, f"{name} {tuple(src.shape)} {nm} against the other kernel")
    # the variant the main path runs: one gradient only
    part = kernel(src, off, g, main_path)
    for a, b, asked in zip(part, got, main_path):
        if (a is not None) != asked or (a is not None and not torch.equal(a, b)):
            raise AssertionError(f"{name}: one gradient alone differs from both together")
    # whether the yardstick's op skips the grid's gradient that is not asked for
    unasked_grid = torch.ops.aten.grid_sampler_2d_backward(
        g, src, grid, 0, PADDING_MODES[padding], True, [True, False])[1] is not None
    n = h * w
    return dict(
        shape=list(src.shape), err=max(errs), tol=f"{BWD_RTOL} of the largest entry",
        ms=time_ms(lambda: kernel(src, off, g)),
        call_ms=call_ms(lambda: kernel(src, off, g)),
        main_path_ms=time_ms(lambda: kernel(src, off, g, main_path)),
        main_path_mask=list(main_path),  # (dsrc, doff) asked for
        plain_ms=call_ms(plain, 50),
        library_ms=time_ms(lambda: grid_sample_bwd(g, src, grid, padding, (True, True))),
        main_path_library_ms=time_ms(lambda: grid_sample_bwd(g, src, grid, padding, main_path)),
        library_grid_grad_unasked=unasked_grid,
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


def make_session(state, mode, plain=False, warp="auto", fused=False, **session_kw):
    """A session on the card from the weights ``state``, built through the
    entry points a user calls. MAD gets the bulkhead, as ``cli/adapt.py``
    builds it. ``plain`` swaps the kernels for their plain versions;
    ``warp`` is the warp mode of model and loss; ``fused`` gives the
    device-resident session instead of the host one."""
    from real_time_self_adaptive_deep_stereo_torch.adapt import (
        AdaptationEngine,
        FusedOnlineSession,
        OnlineAdaptationSession,
        default_block_config_path,
        load_block_config,
        make_blocks,
    )
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net

    warp = "clamped" if plain else warp
    modes = dict(corr_mode="torch") if plain else {}
    model = get_stereo_net("MADNet", bulkhead=(mode == "MAD"), warp_mode=warp, **modes)  # device cuda
    model.load_state_dict(state)
    blocks = make_blocks(load_block_config(default_block_config_path("MADNet")), model)
    engine = AdaptationEngine(model, blocks, lr=LR, optimizer="momentum", warp_mode=warp)
    if fused:
        return FusedOnlineSession(engine, mode=mode, max_steps=64, **session_kw)
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


# ------------------------------------------------------------------ phase 6
TILE_FWD_MAD = {"corr_fwd": 5, "warp_tile_image_fwd": 2, "warp_tile_features_fwd": 4}
# host and fused sessions, and replayed and eager fused sessions, run the
# same ops in the same order; cuDNN's backward is not run-to-run
# deterministic, so two runs of one path differ by 1e-6 of the loss after
# a step, and the difference is carried along the trajectory
TRAJ_LOSS_RTOL = 1e-4
TRAJ_EPE_RTOL = 1e-3
TRAJ_SCORE_ATOL = 1e-6  # a score is uf (0.01) times a difference of such losses


def smooth_frames(n: int, seed: int):
    return [make_smooth_frame(seed + i, d=8 + 2 * i) for i in range(n)]


def mad_tile_launches(k: int):
    return {**TILE_FWD_MAD, "corr_bwd": 1, "warp_tile_image_bwd": 1,
            "warp_tile_features_bwd": 0 if k == 0 else 1}


def step_counted(session, frame, want, what):
    """One fused step whose launch counts must be exactly ``want``."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    before = dict(cuda_lib.LAUNCHES)
    session.step(frame)
    added = {k: cuda_lib.LAUNCHES[k] - before[k] for k in cuda_lib.LAUNCHES}
    want = {**dict.fromkeys(cuda_lib.LAUNCHES, 0), **want}
    if added != want:
        raise AssertionError(f"{what}: launches {added}, want {want}")


def assert_trajectory(got, want, what, frames=None):
    """``finalize()`` of a fused session against another's, or against the
    per-frame results of a host session."""
    n = len(want["loss"]) if frames is None else frames
    worst = {}
    for key, rtol in (("loss", TRAJ_LOSS_RTOL), ("epe", TRAJ_EPE_RTOL)):
        a, b = np.asarray(got[key][:n], np.float64), np.asarray(want[key][:n], np.float64)
        if a.shape != b.shape or not np.isfinite(a).all():
            raise AssertionError(f"{what}: {key} {a} against {b}")
        worst[key] = float(np.max(np.abs(a - b) / np.abs(b)))
        if not worst[key] <= rtol:
            raise AssertionError(f"{what}: {key} differs by {worst[key]:.3g} > {rtol}: {a} against {b}")
    log(f"{what}: over {n} frames loss within {worst['loss']:.3g}, epe within {worst['epe']:.3g} (relative)")


def host_stats(session):
    st = session.stats
    return {"loss": st.loss, "epe": st.epe, "fetch_counter": st.fetch_counter, "scores": session.scores}


def assert_controller(got, want, what):
    got = {**got, "fetch_counter": [int(c) for c in got["fetch_counter"]]}
    if got["fetch_counter"] != [int(c) for c in want["fetch_counter"]]:
        raise AssertionError(f"{what}: fetch counter {got['fetch_counter']} against {want['fetch_counter']}")
    err = float(np.max(np.abs(np.asarray(got["scores"], np.float64) - np.asarray(want["scores"], np.float64))))
    log(f"{what}: fetch counter {got['fetch_counter']}, scores within {err:.3g}")
    if not err <= TRAJ_SCORE_ATOL:
        raise AssertionError(f"{what}: scores {got['scores']} against {want['scores']}")


def timed_host(session, frames, warm):
    """ms/frame of a host session (each step ends in its host sync)."""
    ms = []
    for f in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.step(f)
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms[warm:])


def device_activities(session, frame) -> int:
    """Kernels and copies the device runs for one step of ``session``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        session.step(frame)
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def run_fused(state, profile_dir):
    """Phase 6: the fused device session at 320x1216 with the tiled one-hot
    warps in model and loss. Returns (launches by path, ms/frame by path)."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    launches, frame_ms = {}, {}
    frames = smooth_frames(N_FRAMES_FUSED, 100)
    mad_kw = dict(sample_mode="SEQUENTIAL", ssim_th=1e9, seed=0)

    # --- MAD, SEQUENTIAL: two rounds checked frame by frame, then two rounds
    # free-running with every host sync turned into an error
    session = make_session(state, "MAD", warp="mxu", fused=True, **mad_kw)
    if not session.use_graphs:
        raise AssertionError("the fused session must replay graphs on the card")
    n_blocks = len(session.engine.blocks)
    checked = 2 * n_blocks
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    first_ms = []
    for i, f in enumerate(frames[:checked]):
        k = i % n_blocks
        before = session.arena.flat.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_counted(session, f, mad_tile_launches(k), f"fused MAD frame {i}")
        torch.cuda.synchronize()
        first_ms.append((time.perf_counter() - t0) * 1e3)
        moved = (session.arena.flat != before).nonzero().flatten()
        start, end = session.arena.block_ranges[k]
        if moved.numel() == 0 or int(moved.min()) < start or int(moved.max()) >= end:
            raise AssertionError(f"fused MAD frame {i}: block {k} owns [{start}, {end}) but the "
                                 f"arena moved in [{int(moved.min()) if moved.numel() else None}, "
                                 f"{int(moved.max()) if moved.numel() else None}]")
    # one graph per block, each holding exactly that block's launches
    want_graphs = {("mad", (k,)): {n: c for n, c in mad_tile_launches(k).items() if c}
                   for k in range(n_blocks)}
    if session.graph_launches != want_graphs:
        raise AssertionError(f"fused MAD: graphs hold {session.graph_launches}, want {want_graphs}")
    log(f"fused MAD first round (eager step + capture) ms/frame {first_ms[:n_blocks]}")
    log(f"fused MAD second round (replay, fenced by a sync) ms/frame {first_ms[n_blocks:]}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        for f in frames[checked:]:
            session.step(f)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / (N_FRAMES_FUSED - checked)
    torch.cuda.synchronize()
    frame_ms["FUSED_MAD"] = (time.perf_counter() - t0) * 1e3 / (N_FRAMES_FUSED - checked)
    log(f"fused MAD steady: {frame_ms['FUSED_MAD']:.3f} ms/frame over {N_FRAMES_FUSED - checked} frames "
        f"with no host sync (the host took {enqueue_ms:.3f} ms/frame to enqueue them); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    launches["FUSED_MAD"] = dict(cuda_lib.LAUNCHES)
    want_total = dict.fromkeys(cuda_lib.LAUNCHES, 0)
    for i in range(N_FRAMES_FUSED):
        for name, c in mad_tile_launches(i % n_blocks).items():
            want_total[name] += c
    if launches["FUSED_MAD"] != want_total:
        raise AssertionError(f"fused MAD: launches {launches['FUSED_MAD']}, want {want_total}")
    fused = session.finalize()
    fused_flat = session.arena.flat.clone()
    fused_disp = session.last_disp.clone()
    if fused["steps"] != N_FRAMES_FUSED or int(fused["reset_count"]) != 0:
        raise AssertionError(f"fused MAD: {fused['steps']} steps, {fused['reset_count']} resets")

    # the host session over the same frames and weights with the same warps
    host = make_session(state, "MAD", warp="mxu", **mad_kw)
    frame_ms["HOST_MAD_MXU"] = timed_host(host, frames, warm=n_blocks)
    assert_trajectory(fused, host_stats(host), "fused MAD against the host session")
    assert_controller(fused, host_stats(host), "fused MAD against the host session")
    host_flat = torch.cat([dict(host.engine.model.named_parameters())[name].detach().flatten()
                           for name, *_ in session.arena.entries])
    moved = float((fused_flat - session.arena.flat0).abs().max())
    err = float((fused_flat - host_flat).abs().max())
    log(f"fused MAD against the host session: weights moved by up to {moved:.3g}, differ by {err:.3g}")
    if not (moved > 0 and err <= 1e-2 * moved):
        raise AssertionError("fused MAD: adapted weights differ from the host session's")

    # replay against eager: the same session class without graphs
    eager = make_session(state, "MAD", warp="mxu", fused=True, use_graphs=False, **mad_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in frames:
        eager.step(f)
    torch.cuda.synchronize()
    frame_ms["FUSED_MAD_EAGER"] = (time.perf_counter() - t0) * 1e3 / len(frames)
    if eager._graphs:
        raise AssertionError("use_graphs=False captured a graph")
    assert_trajectory(fused, eager.finalize(), "fused MAD replayed against eager")
    assert_controller(fused, eager.finalize(), "fused MAD replayed against eager")
    err = float((fused_flat - eager.arena.flat).abs().max())
    d_err = float((fused_disp - eager.last_disp).abs().max()) / float(eager.last_disp.abs().max())
    log(f"fused MAD replayed against eager: weights differ by {err:.3g} of {moved:.3g} moved, "
        f"last disparity by {d_err:.3g} of its largest")
    # 20 steps of weights that differ in the seventh digit: measured 1.6e-4
    if not (err <= 1e-2 * moved and d_err <= TRAJ_EPE_RTOL):
        raise AssertionError("fused MAD: a replayed trajectory differs from the eager one")

    # the same session on the clamped-window kernels (warp_mode 'cuda'), for
    # the in-model comparison of the two warp routes: first round captures,
    # then both run the same steady frames, turn and turn about
    other = make_session(state, "MAD", warp="cuda", fused=True, **mad_kw)
    for f in frames[:n_blocks]:
        other.step(f)
    by_route = {"mxu": [], "cuda": []}
    launches["FUSED_MAD_CUDA_WARPS"] = dict.fromkeys(cuda_lib.LAUNCHES, 0)
    for _ in range(2):
        for route, sess in (("mxu", session), ("cuda", other)):
            cuda_lib.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for f in frames[n_blocks : 3 * n_blocks]:
                sess.step(f)
            torch.cuda.synchronize()
            by_route[route].append((time.perf_counter() - t0) * 1e3 / (2 * n_blocks))
            if route == "cuda":
                for k, v in cuda_lib.LAUNCHES.items():
                    launches["FUSED_MAD_CUDA_WARPS"][k] += v
    got = launches["FUSED_MAD_CUDA_WARPS"]
    if any(v for k, v in got.items() if "tile" in k) or not all(
        got[k] for k in ("warp_image_fwd", "warp_features_fwd", "warp_image_bwd", "warp_features_bwd")
    ):
        raise AssertionError(f"fused MAD with warp_mode 'cuda': launches {got}")
    frame_ms["FUSED_MAD_CUDA_WARPS"] = min(by_route["cuda"])
    log(f"fused MAD steady ms/frame by warp route, two passes each: {by_route}")
    del other

    # what each block's graph holds: device activities of one replay
    per_graph = [device_activities(session, frames[k]) for k in range(n_blocks)]
    log(f"fused MAD kernels and copies in one replay, by block trained: {per_graph}")

    # the one-graph alternative: shared forward, block loss selected on the
    # device, full backward, update masked by block ownership
    shared = make_session(state, "MAD", warp="mxu", fused=True, shared_forward=True, **mad_kw)
    for f in frames[:checked]:
        shared.step(f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in frames[checked:]:
        shared.step(f)
    torch.cuda.synchronize()
    frame_ms["FUSED_MAD_SHARED_FORWARD"] = (time.perf_counter() - t0) * 1e3 / (N_FRAMES_FUSED - checked)
    if set(shared._graphs) != {("shared",)}:
        raise AssertionError(f"shared_forward captured {set(shared._graphs)}")
    assert_trajectory(shared.finalize(), fused, "fused MAD shared_forward against per-block graphs")
    assert_controller(shared.finalize(), fused, "fused MAD shared_forward against per-block graphs")
    log(f"fused MAD shared_forward: {frame_ms['FUSED_MAD_SHARED_FORWARD']:.3f} ms/frame, "
        f"{device_activities(shared, frames[0])} kernels and copies in its one graph")
    del shared

    # step_chunk over K frames equals K steps
    chunked = make_session(state, "MAD", warp="mxu", fused=True, **mad_kw)
    for c in range(2):
        chunk = frames[c * n_blocks : (c + 1) * n_blocks]
        chunked.step_chunk({k: np.stack([f[k] for f in chunk]) for k in chunk[0]})
    if tuple(chunked.last_disp.shape) != (n_blocks, 1, H, W, 1):
        raise AssertionError(f"step_chunk: last_disp {tuple(chunked.last_disp.shape)}")
    assert_trajectory(chunked.finalize(), fused, "step_chunk against steps", frames=checked)
    del chunked, eager, host

    # --- MAD, PROBABILITY: the block is read back each frame
    session = make_session(state, "MAD", warp="mxu", fused=True, sample_mode="PROBABILITY",
                           ssim_th=1e9, seed=3)
    cuda_lib.reset_launches()
    picked = []
    for i, f in enumerate(frames[:8]):
        before = dict(cuda_lib.LAUNCHES)
        session.step(f)
        (k,) = session._host_blocks
        added = {n: cuda_lib.LAUNCHES[n] - before[n] for n in cuda_lib.LAUNCHES}
        if added != {**dict.fromkeys(cuda_lib.LAUNCHES, 0), **mad_tile_launches(k)}:
            raise AssertionError(f"fused PROBABILITY frame {i}: block {k}, launches {added}")
        picked.append(k)
    stats = session.finalize()
    log(f"fused MAD PROBABILITY: blocks {picked}, fetch counter {stats['fetch_counter'].tolist()}, "
        f"loss {stats['loss'].tolist()}")
    if stats["fetch_counter"].tolist() != [picked.count(k) for k in range(n_blocks)] or not np.isfinite(
        stats["loss"]
    ).all():
        raise AssertionError("fused PROBABILITY: the fetch counter does not follow the sampled blocks")
    launches["FUSED_MAD_PROBABILITY"] = dict(cuda_lib.LAUNCHES)
    del session

    # --- FULL
    full_kw = dict(ssim_th=1e9)
    full_launches = {"corr_fwd": 5, "warp_tile_image_fwd": 1, "warp_tile_features_fwd": 4,
                     "corr_bwd": 5, "warp_tile_image_bwd": 1, "warp_tile_features_bwd": 4}
    session = make_session(state, "FULL", warp="mxu", fused=True, **full_kw)
    cuda_lib.reset_launches()
    for i, f in enumerate(frames[:2]):
        step_counted(session, f, full_launches, f"fused FULL frame {i}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in frames[2:N_FRAMES_FULL + 3]:
        session.step(f)
    torch.cuda.synchronize()
    frame_ms["FUSED_FULL"] = (time.perf_counter() - t0) * 1e3 / (N_FRAMES_FULL + 1)
    launches["FUSED_FULL"] = dict(cuda_lib.LAUNCHES)
    if launches["FUSED_FULL"] != {**dict.fromkeys(cuda_lib.LAUNCHES, 0),
                                  **{k: v * (N_FRAMES_FULL + 3) for k, v in full_launches.items()}}:
        raise AssertionError(f"fused FULL: launches {launches['FUSED_FULL']}")
    host = make_session(state, "FULL", warp="mxu", **full_kw)
    frame_ms["HOST_FULL_MXU"] = timed_host(host, frames[:N_FRAMES_FULL + 3], warm=1)
    assert_trajectory(session.finalize(), host_stats(host), "fused FULL against the host session")
    del session, host

    # --- NONE: with metrics (the loss runs), then serving without
    none_launches = {"corr_fwd": 5, "warp_tile_image_fwd": 1, "warp_tile_features_fwd": 4}
    session = make_session(state, "NONE", warp="mxu", fused=True)
    cuda_lib.reset_launches()
    for i, f in enumerate(frames[:3]):
        step_counted(session, f, none_launches, f"fused NONE frame {i}")
    host = make_session(state, "NONE", warp="mxu")
    for f in frames[:3]:
        host.step(f)
    assert_trajectory(session.finalize(), host_stats(host), "fused NONE against the host session")
    del session, host
    session = make_session(state, "NONE", warp="mxu", fused=True, compute_metrics=False)
    serve_frames = [{k: f[k] for k in ("left", "right")} for f in frames[:N_FRAMES_NONE + 3]]
    cuda_lib.reset_launches()
    disps = list(session.serve(serve_frames[:2]))  # eager and capture, then a replay
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    disps += list(session.serve(serve_frames[2:]))
    frame_ms["FUSED_NONE_SERVE"] = (time.perf_counter() - t0) * 1e3 / (len(serve_frames) - 2)
    launches["FUSED_NONE"] = dict(cuda_lib.LAUNCHES)
    want = {**dict.fromkeys(cuda_lib.LAUNCHES, 0), "corr_fwd": 5 * len(serve_frames),
            "warp_tile_features_fwd": 4 * len(serve_frames)}
    if launches["FUSED_NONE"] != want:
        raise AssertionError(f"fused NONE serving: launches {launches['FUSED_NONE']}, want {want}")
    if len(disps) != len(serve_frames) or any(
        d.shape != (1, H, W, 1) or not np.isfinite(d).all() for d in disps
    ):
        raise AssertionError("fused NONE serving: bad disparities")
    # each served disparity is its own frame's: the host session's, frame by frame
    host = make_session(state, "NONE", warp="mxu")
    for i in (0, len(serve_frames) - 1):
        ref = host.step(frames[i])["disp"].cpu().numpy()
        err = float(np.abs(disps[i] - ref).max()) / float(np.abs(ref).max())
        log(f"fused NONE served disparity {i} against the host session: {err:.3g} of the largest")
        if not err <= MODEL_RTOL:
            raise AssertionError(f"fused NONE serving: disparity {i} is not frame {i}'s")
    del session, host

    # --- the reset, on the device: a threshold below every loss
    session = make_session(state, "MAD", warp="mxu", fused=True, sample_mode="FIXED", fixed_id=2,
                           ssim_th=-1.0)
    for f in frames[:3]:  # eager, then two replays
        session.step(f)
    stats = session.finalize()
    if int(stats["reset_count"]) != 3 or not torch.equal(session.arena.flat, session.arena.flat0):
        raise AssertionError("fused reset: the pristine arena was not restored")
    if not bool(session.opt["acc"][0].any()):
        raise AssertionError("fused reset: the steps before it left no optimizer state")
    log("fused reset safeguard: arena restored on the device, optimizer state kept")

    if profile_dir:
        for mode, kw in (("MAD", mad_kw), ("FULL", full_kw), ("NONE", {})):
            session = make_session(state, mode, warp="mxu", fused=True, **kw)
            for f in frames[:n_blocks]:
                session.step(f)  # every branch captured
            torch.cuda.synchronize()
            profile_frames(session, frames[n_blocks : 2 * n_blocks], Path(profile_dir), f"fused_{mode.lower()}")
    return launches, frame_ms


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
    ("the port's kernels", r"corr_fwd|corr_bwd|warp_fwd_kernel|feat_gather_fwd|warp_bwd_|tile_image_fwd|tile_feat_fwd|tile_bwd_"),
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
    ap.add_argument("--fused-only", action="store_true",
                    help="run the fused-session phase (6) alone, without the result lines")
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
    for kernel in ("tile_image_fwd_kernel", "tile_feat_fwd_kernel"):
        usage = cuda_lib.ptxas_usage(cuda_lib.BUILD_LOGS.get("warp_tile", ""), kernel) or ["cached build, no report"]
        log(f"ptxas {kernel} (redesigned tiled forward): {'; '.join(usage)}")

    if args.fused_only:
        run_fused(params_from_jax(seeded_jax_params(0)), args.profile)
        log("fused session checked; no result lines (--fused-only)")
        return 0
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
    fused_launches, fused_ms = run_fused(state, args.profile)
    launches.update(fused_launches)
    frame_ms.update(fused_ms)

    kernels = []
    for name, rs in rows.items():
        lib_ms = [r["library_ms"] for r in rs]
        shape_keys = ("shape", "ms", "call_ms", "plain_ms", "bound_ms", "library_ms", "main_path_ms",
                      "main_path_library_ms")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            # the flagship paths: the host MAD session (clamped-window warps)
            # and the fused MAD session (tiled warps), counters set to 0
            # before each
            "launches": launches["MAD"][name] + launches["FUSED_MAD"][name],
            "launches_by_path": {mode: launches[mode][name] for mode in launches},
            "max_abs_err": max(r["err"] for r in rs),
            # one call at each main-path shape: the sums over the shapes
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rs) else "operations",
            "library_ms": None if None in lib_ms else sum(lib_ms),
            # backward kernels: the gradients the main path asks for alone
            **({k: sum(r[k] for r in rs) for k in ("main_path_ms", "main_path_library_ms")}
               if "main_path_ms" in rs[0] else {}),
            "shapes": [{k: r[k] for k in shape_keys if k in r} for r in rs],
        })
    idle = [k["name"] for k in kernels if not k["launches"] > 0]
    if idle:
        raise AssertionError(f"no main path launched {idle}")
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
