#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its main paths on one GPU.

    python3 chip_smoke.py [--profile DIR] [--kernels-only | --fused-only | --dispnet-only | --precision-only]

Phases, each of which raises on failure (nothing is caught):

1. The card's name and power limit (``nvidia-smi``) and the TF32 flags,
   which must be off: phases 3-7 run the JAX package's default precision,
   ``highest``, fp32.
2. Build every CUDA kernel from ``csrc/`` (one ``nvcc`` per source, all
   started together) and print the build time and the ptxas report, and
   apart the registers and spills of ``corr_fwd``, the two tiled forwards,
   the tiled offset and source gradients, K5's offset and source gradients
   (``feat_bwd_offset_kernel``, ``feat_bwd_source_kernel``) and the wide
   correlation pair.
3. Each of the sixteen kernels at every shape the main paths give it, against
   its plain PyTorch version on the card, with offsets outside the clamp
   windows: the six forward kernels, and the six backward kernels
   (``dx``, ``dy``; ``dimg``, ``ddisp``; ``dfeats``, ``ddx``), each of
   which must also give bit-identical outputs in two runs. The wide
   correlation kernels (any radius) run at DispNet-Corr1D's call,
   [1,128,80,304] at radius 40, and are also checked where W < 2R+1
   ([1,128,5,19]) and at a width that is no multiple of their 64-column
   tile; for the record, the wide forward is also timed at MADNet's five
   radius-2 shapes beside ``corr_fwd``. The tiled
   one-hot warps (``csrc/warp_tile.cu``) are held against the one-hot
   products and against the clamped-window kernels, which compute the
   same function (the image warps bit for bit). Prints each kernel's
   time (median of CUDA-event-timed replays of a CUDA graph), its bound
   (bytes over 3.35 TB/s, or fp32 operations over 67 TFLOP/s, whichever
   is larger), the plain version's time and, for the warps, a yardstick
   that the port never calls, timed from a CUDA graph too. K1
   (``corr_fwd``, ``corr_fwd_bf16``), the tiled backward (every variant
   of ``warp_tile_*_bwd``, the source gradient's included) and K5 (every
   variant of ``warp_features_bwd``) are also timed
   with the L2 cold (``cold_ms``): each call in the graph follows a write
   over a buffer twice the card's 50 MB L2, whose own time, taken the same
   way, is subtracted. The yardsticks are
   ``F.grid_sample`` (forward) or its backward op
   ``aten.grid_sampler_2d_backward`` on the same sampling. A warp backward
   is timed in each variant, the gradients it is asked for: both, the
   offset's alone, and each mode's (MAD's and FULL's), each beside the op
   with the same output mask and its own byte bound, and each bit-identical
   to both gradients together. Per kernel it prints its time summed over
   its shapes as a ratio to that yardstick's sum, for a backward kernel
   that of every variant.
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
7. DispNet-Corr1D at full width (every width of the JAX model) at
   320x1216, seeded weights in the JAX layout carried over with
   ``params_from_jax``: the host NONE session, MAD as ``cli/adapt.py``
   runs it (momentum, lr 1e-4, ``block_config/dispnet_full_6.json``,
   SEQUENTIAL, no bulkhead: DispNet has none), FULL, the fused MAD session
   (``warp_mode='mxu'``) against the host session, and fused NONE serving.
   Launch counts are asserted frame by frame: one ``corr_fwd_wide`` a
   frame, one ``corr_bwd_wide`` for FULL and for MAD blocks 3 and 4 (conv2
   and conv1, before the correlation) and none for the other blocks, and
   the loss's image-warp kernels as in MADNet. One frame of NONE, of MAD
   (blocks 3 and 5) and of FULL also runs with the plain modes on the card:
   the disparities before and after the step agree within 1e-4 of the
   largest, a step's gradient within 5e-4 of its largest entry.
8. The precision modes ``default``, ``bf16`` and ``bf16_act``
   (``ops/conv.py``). Phase 3 also holds the four bf16 instances of the
   correlation kernels (``corr_fwd_bf16``, ``corr_bwd_bf16``,
   ``corr_fwd_wide_bf16``, ``corr_bwd_wide_bf16``) against their plain
   versions at the main-path shapes, on seeded values rounded to bf16:
   every entry within one bf16 ulp, the backward bit-identical in two runs,
   each timed beside its bound and the fp32 instance. Then, for each mode
   against ``highest`` on the same smooth frames and weights: the first
   frame's full-resolution disparity within a median relative error of
   0.05 (the bound of the JAX package's own drift test), fused MAD
   (SEQUENTIAL, bulkhead, ``mxu``, 15 frames, the first round counted frame
   by frame) with the first round's EPE within 5% of ``highest``'s a frame
   (every frame's printed), and fused NONE serving. Under ``bf16_act`` every correlation launches a bf16
   instance and none an fp32 one; under ``default`` and ``bf16`` none a
   bf16 one. Under ``bf16_act`` also host MAD against fused MAD (loss 1e-3,
   EPE 1e-2 a frame: cuDNN's bf16 weight gradients), fused FULL, and
   DispNet-Corr1D's host MAD over ``dispnet_full_6.json`` (blocks 3-4 run
   ``corr_bwd_wide_bf16``) and fused NONE serving, whose disparities must
   be bf16, as the reference's are. The TF32 flags must be on for cuDNN
   under ``default`` only, and off again after the phase.

Prints the card line, the ms/frame of the host and the fused sessions by
mode and precision, a JSON line of the sixteen kernels, and as the last line
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
# H100 SXM bf16 tensor cores, dense, fp32 accumulate, published: the peak for
# products of bf16 operands summed in fp32, which the bf16 instances compute
BF16_FLOPS = 989e12
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
# DispNet-Corr1D: its correlation's radius and the shape of that call
# (conv2's features at 1/4 resolution); two shapes that only check the
# wide kernels: W < 2R+1, and a width that is no multiple of the tile
DN_RADIUS = 40
DN_CORR_SHAPE = (1, 128, H // 4, W // 4)
WIDE_CHECK_SHAPES = [(1, 128, 5, 19), (1, 128, 12, 150)]
DN_BLOCK_CONFIG = str(Path(__file__).resolve().parent / "block_config" / "dispnet_full_6.json")

_JAX_OPS = "real_time_self_adaptive_deep_stereo_tpu/ops"
REPLACES = {
    "corr_fwd": f"{_JAX_OPS}/correlation.py:53",
    # the same Pallas kernel at any radius (DispNet's 40)
    "corr_fwd_wide": f"{_JAX_OPS}/correlation.py:53",
    "warp_image_fwd": f"{_JAX_OPS}/warp_pallas.py:69",
    "warp_features_fwd": f"{_JAX_OPS}/warp_pallas.py:247",
    # no Pallas kernel: the plain-jnp backward of the custom_vjp around _corr_fwd_kernel
    "corr_bwd": f"{_JAX_OPS}/correlation.py:117",
    "corr_bwd_wide": f"{_JAX_OPS}/correlation.py:117",
    "warp_image_bwd": f"{_JAX_OPS}/warp_pallas.py:99",
    "warp_features_bwd": f"{_JAX_OPS}/warp_pallas.py:271",
    # one Pallas kernel each way serves both samplings; the port gives each its entry point
    "warp_tile_image_fwd": f"{_JAX_OPS}/warp_pallas.py:460",
    "warp_tile_features_fwd": f"{_JAX_OPS}/warp_pallas.py:460",
    "warp_tile_image_bwd": f"{_JAX_OPS}/warp_pallas.py:495",
    "warp_tile_features_bwd": f"{_JAX_OPS}/warp_pallas.py:495",
    # the bf16 instances of K1 and of its backward: the features under the
    # JAX package's bf16_act precision mode
    "corr_fwd_bf16": f"{_JAX_OPS}/correlation.py:53",
    "corr_bwd_bf16": f"{_JAX_OPS}/correlation.py:117",
    "corr_fwd_wide_bf16": f"{_JAX_OPS}/correlation.py:53",
    "corr_bwd_wide_bf16": f"{_JAX_OPS}/correlation.py:117",
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


L2_FLUSH_BYTES = 100 * 2**20  # twice the H100's 50 MB L2


def cold_ms(fn) -> float:
    """Device time of one call of ``fn`` with the L2 cold, as a call in a
    frame finds it after other kernels: :func:`time_ms` of a write over
    ``L2_FLUSH_BYTES`` followed by the call, less :func:`time_ms` of the
    write alone."""
    buf = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    flush = lambda: buf.fill_(1.0)  # noqa: E731
    return time_ms(lambda: (flush(), fn())) - time_ms(flush)


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


def bound(n_bytes: float, n_flops: float, peak_flops: float = FP32_FLOPS):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_flops / peak_flops * 1e3
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
# the variants of a warp backward: the gradients (dsrc, doff) asked for
VARIANTS = {"both": (True, True), "doff": (False, True), "dsrc": (True, False)}
# the variant each mode that runs a backward asks of a warp (NONE runs
# none): the right image never takes a gradient; the feature warp's offset
# takes none with MAD's bulkhead, and one in FULL, which has no bulkhead
IMAGE_MODES = {"MAD": "doff", "FULL": "doff"}
FEATURE_MODES = {"MAD": "dsrc", "FULL": "both"}


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
            cold_ms=cold_ms(lambda: ops.correlation_cuda(x, y, RADIUS)),
            call_ms=call_ms(lambda: ops.correlation_cuda(x, y, RADIUS)),
            plain_ms=time_ms(lambda: ops.correlation_torch(x, y, RADIUS)),
            library_ms=None,
            bound=bound(4.0 * n * (2 * c + k), 2.0 * n * c * k),
            # for the record: the wide kernel forced at this radius
            wide_ms=time_ms(lambda: ops.correlation_cuda(x, y, RADIUS, wide=True)),
        ))
        torch.testing.assert_close(ops.correlation_cuda(x, y, RADIUS, wide=True), want, **CORR_TOL)

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

    check_wide_kernels(ops, rows)
    check_bf16_kernels(ops, rows)

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
        IMAGE_MODES,
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
        IMAGE_MODES,
        same_as=lambda s, o, g: ops.warp_image_bwd_cuda(s, o, g, MAX_DISP),
        cold=True,
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
            FEATURE_MODES,
            cold=True,
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
            FEATURE_MODES,
            same_as=lambda s, o, g, neg=neg: ops.warp_features_bwd_cuda(s, o, g, neg, MAX_POS),
            cold=True,
        ))

    for name, rs in rows.items():
        for r in rs:
            r["bound_ms"], r["bound_by"] = r.pop("bound")
            log(f"kernel {name} {r}")
    for name, rs in rows.items():  # summed over the main-path shapes
        ms, lib_ms = sum(r["ms"] for r in rs), [r["library_ms"] for r in rs]
        ratio = "no library call" if None in lib_ms else f"{ms / sum(lib_ms):.3f} of the library's {sum(lib_ms):.5f} ms"
        if rs and "cold_ms" in rs[0]:
            ratio += f"; cold {sum(r['cold_ms'] for r in rs):.5f} ms"
        for v, var in summed_variants(rs).items():
            modes = [m for m, mv in rs[0]["modes"].items() if mv == v]
            ratio += (f"; {v}{' (' + ', '.join(modes) + ')' if modes else ''} {var['ms']:.5f} ms"
                      f"{(' (cold ' + format(var['cold_ms'], '.5f') + ')') if 'cold_ms' in var else ''}, "
                      f"{var['ms'] / var['library_ms']:.3f} of the library's {var['library_ms']:.5f} ms, "
                      f"bound {var['bound_ms']:.5f}")
        log(f"kernel {name}: {ms:.5f} ms over {len(rs)} shape(s), {ratio}")
    return rows


def check_wide_kernels(ops, rows):
    """``corr_fwd_wide`` and ``corr_bwd_wide`` at DispNet-Corr1D's call
    (timed, into ``rows``) and at the shapes that only check them: forward
    within CORR_TOL, backward within BWD_RTOL of each gradient's largest
    entry and bit-identical in two runs."""
    k = 2 * DN_RADIUS + 1
    for i, shape in enumerate([DN_CORR_SHAPE, *WIDE_CHECK_SHAPES]):
        x, y = seeded(shape, 110 + i), seeded(shape, 120 + i)
        g = seeded((shape[0], k, *shape[2:]), 130 + i)
        got, want = ops.correlation_cuda(x, y, DN_RADIUS), ops.correlation_torch(x, y, DN_RADIUS)
        grads = ops.correlation_bwd_cuda(x, y, g, DN_RADIUS)
        again = ops.correlation_bwd_cuda(x, y, g, DN_RADIUS)
        want_grads = ops.correlation_torch_bwd(x, y, g, DN_RADIUS)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **CORR_TOL)
        errs = [assert_grad_close(a, b, f"corr_bwd_wide {shape} {nm}")
                for a, b, nm in zip(grads, want_grads, ("dx", "dy"))]
        assert_same_bits(grads, again, f"corr_bwd_wide {shape}")
        fwd = dict(shape=list(shape), radius=DN_RADIUS, err=float((got - want).abs().max()), tol=CORR_TOL)
        bwd = dict(shape=list(shape), radius=DN_RADIUS, err=max(errs), tol=f"{BWD_RTOL} of the largest entry")
        if i:
            log(f"kernel corr_fwd_wide check {fwd}")
            log(f"kernel corr_bwd_wide check {bwd}")
            continue
        n = shape[2] * shape[3]
        c = shape[1]
        rows["corr_fwd_wide"].append(dict(
            fwd,
            ms=time_ms(lambda: ops.correlation_cuda(x, y, DN_RADIUS)),
            call_ms=call_ms(lambda: ops.correlation_cuda(x, y, DN_RADIUS)),
            plain_ms=time_ms(lambda: ops.correlation_torch(x, y, DN_RADIUS), inner=2),
            library_ms=None,
            bound=bound(4.0 * n * (2 * c + k), 2.0 * n * c * k),
        ))
        rows["corr_bwd_wide"].append(dict(
            bwd,
            ms=time_ms(lambda: ops.correlation_bwd_cuda(x, y, g, DN_RADIUS)),
            call_ms=call_ms(lambda: ops.correlation_bwd_cuda(x, y, g, DN_RADIUS)),
            plain_ms=time_ms(lambda: ops.correlation_torch_bwd(x, y, g, DN_RADIUS), inner=2),
            library_ms=None,
            # reads x, y, g once, writes dx, dy; a multiply-add per
            # (element, shift) for each of the two gradients
            bound=bound(4.0 * n * (4 * c + k), 4.0 * n * c * k),
        ))


def bf16_tol(got, want, abs_terms, n_terms):
    """What a bf16 instance may differ from its plain version by, entry by
    entry: one bf16 ulp (both round an fp32 sum once), plus what two fp32
    sums of the same ``n_terms`` terms in other orders may differ by,
    2 (n_terms + 2) 2^-24 times the sum of the terms' magnitudes
    (``abs_terms``, the plain version on |inputs|). Where a sum cancels,
    that second part is more than a bf16 ulp of the small result; elsewhere
    it is a few hundredths of one."""
    mag = torch.maximum(got.float().abs(), want.float().abs()).clamp(min=2.0**-126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7) + 2.0 * (n_terms + 2) * 2.0**-24 * abs_terms


def bf16_err(got, want, abs_terms, n_terms, what):
    """Max abs error of bf16 ``got`` against bf16 ``want``; raises unless
    every entry is within :func:`bf16_tol`. Logs how many entries are
    beyond one bf16 ulp of their value (the cancelling sums)."""
    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16:
        raise AssertionError(f"{what}: dtypes {got.dtype}, {want.dtype}, want bfloat16")
    g, w = got.float(), want.float()
    err = (g - w).abs()
    tol = bf16_tol(got, want, abs_terms, n_terms)
    if not bool((err <= tol).all()):
        raise AssertionError(f"{what}: {int((err > tol).sum())} entries beyond the tolerance")
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs()).clamp(min=2.0**-126))) - 7)
    beyond = int((err > ulp).sum())
    if beyond:
        log(f"{what}: {beyond} of {err.numel()} entries beyond one bf16 ulp, all within the fp32 reordering bound")
    return float(err.max())


def check_bf16_kernels(ops, rows):
    """The four bf16 instances at the main-path shapes (MADNet's five
    radius-2 calls, DispNet's radius-40 call; the wide pair also at the
    shapes that only check them) on seeded fp32 values rounded to bf16,
    against their plain versions: every entry within one bf16 ulp (both
    sum in fp32 and round once, in another order) but where the sum
    cancels (:func:`bf16_tol`), the backward bit-identical in two runs.
    Timed beside the fp32 instance on the fp32 values; the bound counts 2
    bytes an element and the fp32 rows' multiply-adds at the bf16 tensor
    cores' rate, the card's peak for bf16 products summed in fp32."""
    from real_time_self_adaptive_deep_stereo_torch.ops.correlation import MAX_REGISTER_RADIUS

    cases = [((1, c, H // f, W // f), RADIUS, True) for c, f in CORR_LEVELS]
    cases += [(DN_CORR_SHAPE, DN_RADIUS, True)] + [(sh, DN_RADIUS, False) for sh in WIDE_CHECK_SHAPES]
    for i, (shape, radius, timed) in enumerate(cases):
        wide = radius > MAX_REGISTER_RADIUS
        fwd_name, bwd_name = (("corr_fwd_wide_bf16", "corr_bwd_wide_bf16") if wide
                              else ("corr_fwd_bf16", "corr_bwd_bf16"))
        k = 2 * radius + 1
        xf, yf = seeded(shape, 140 + i), seeded(shape, 150 + i)
        gf = seeded((shape[0], k, *shape[2:]), 160 + i)
        x, y, g = xf.bfloat16(), yf.bfloat16(), gf.bfloat16()
        got, want = ops.correlation_cuda(x, y, radius), ops.correlation_torch(x, y, radius)
        grads = ops.correlation_bwd_cuda(x, y, g, radius)
        again = ops.correlation_bwd_cuda(x, y, g, radius)
        want_grads = ops.correlation_torch_bwd(x, y, g, radius)
        # the sums of the terms' magnitudes, for the tolerance
        xa, ya, ga = x.float().abs(), y.float().abs(), g.float().abs()
        abs_fwd = ops.correlation_torch(xa, ya, radius)
        abs_grads = ops.correlation_torch_bwd(xa, ya, ga, radius)
        torch.cuda.synchronize()
        tol = "one bf16 ulp of each entry, plus 2 (n + 2) 2^-24 of its terms' magnitudes (n terms)"
        fwd = dict(shape=list(shape), radius=radius, tol=tol,
                   err=bf16_err(got, want, abs_fwd, shape[1], f"{fwd_name} {shape}"))
        errs = [bf16_err(a, b, t, k, f"{bwd_name} {shape} {nm}")
                for a, b, t, nm in zip(grads, want_grads, abs_grads, ("dx", "dy"))]
        assert_same_bits(grads, again, f"{bwd_name} {shape}")
        bwd = dict(shape=list(shape), radius=radius, err=max(errs), tol=tol)
        if not timed:
            log(f"kernel {fwd_name} check {fwd}")
            log(f"kernel {bwd_name} check {bwd}")
            continue
        n, c = shape[2] * shape[3], shape[1]
        inner = 2 if wide else 20  # the plain versions at radius 40 are slow
        rows[fwd_name].append(dict(
            fwd,
            ms=time_ms(lambda: ops.correlation_cuda(x, y, radius)),
            **({} if wide else {"cold_ms": cold_ms(lambda: ops.correlation_cuda(x, y, radius))}),
            call_ms=call_ms(lambda: ops.correlation_cuda(x, y, radius)),
            fp32_ms=time_ms(lambda: ops.correlation_cuda(xf, yf, radius)),
            plain_ms=time_ms(lambda: ops.correlation_torch(x, y, radius), inner=inner),
            library_ms=None,
            bound=bound(2.0 * n * (2 * c + k), 2.0 * n * c * k, BF16_FLOPS),
        ))
        rows[bwd_name].append(dict(
            bwd,
            ms=time_ms(lambda: ops.correlation_bwd_cuda(x, y, g, radius)),
            call_ms=call_ms(lambda: ops.correlation_bwd_cuda(x, y, g, radius)),
            fp32_ms=time_ms(lambda: ops.correlation_bwd_cuda(xf, yf, gf, radius)),
            plain_ms=time_ms(lambda: ops.correlation_torch_bwd(x, y, g, radius), inner=inner),
            library_ms=None,
            bound=bound(2.0 * n * (4 * c + k), (4.0 if wide else 6.0) * n * c * k, BF16_FLOPS),
        ))


def check_warp_bwd(name, src, off, seed, grid, padding, kernel, plain_fwd, modes, same_as=None, cold=False):
    """One warp backward kernel at one shape: both gradients against
    autograd through the plain version (and against ``same_as``, another
    kernel of the same function, where given), two runs bit-identical,
    times. ``kernel(src, off, g, need)`` takes the pair (dsrc, doff) of
    gradients asked for; ``modes`` names the variant (``VARIANTS``) each
    mode asks for. Every variant (both gradients, the offset's alone and
    each mode's) must give the bits of both gradients together in two
    runs, and is timed beside the yardstick ``grid_sample_bwd`` with the
    same mask and beside its own bound; with ``cold``, also with the L2
    cold (:func:`cold_ms`)."""
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
    n = h * w
    variants = {}
    for v in dict.fromkeys(["both", "doff", *modes.values()]):
        mask = VARIANTS[v]
        for _ in range(2):
            part = kernel(src, off, g, mask)
            for a, b, asked in zip(part, got, mask):
                if (a is not None) != asked or (a is not None and not torch.equal(a, b)):
                    raise AssertionError(f"{name} {tuple(src.shape)}: variant {v} differs from both gradients together")
        # reads source (doff only), g and the offset once, writes what is
        # asked; per pixel and channel 4 flops in each gradient
        var_bound = bound(4.0 * n * ((mask[1] + 1) * c + mask[0] * c + 1 + mask[1]),
                          4.0 * c * n * (mask[0] + mask[1]))
        variants[v] = dict(
            ms=time_ms(lambda: kernel(src, off, g, mask)),
            **({"cold_ms": cold_ms(lambda: kernel(src, off, g, mask))} if cold else {}),
            library_ms=time_ms(lambda: grid_sample_bwd(g, src, grid, padding, mask)),
            bound_ms=var_bound[0], bound_by=var_bound[1],
        )
    # whether the yardstick's op skips the grid's gradient that is not asked for
    unasked_grid = torch.ops.aten.grid_sampler_2d_backward(
        g, src, grid, 0, PADDING_MODES[padding], True, [True, False])[1] is not None
    both = variants["both"]
    return dict(
        shape=list(src.shape), err=max(errs), tol=f"{BWD_RTOL} of the largest entry",
        ms=both["ms"],
        **({"cold_ms": both["cold_ms"]} if cold else {}),
        call_ms=call_ms(lambda: kernel(src, off, g)),
        plain_ms=call_ms(plain, 50),
        library_ms=both["library_ms"],
        variants=variants,
        modes=dict(modes),  # the variant each mode asks for
        library_grid_grad_unasked=unasked_grid,
        bound=(both["bound_ms"], both["bound_by"]),
    )


def summed_variants(rs):
    """A warp backward's variants, each summed over the shapes of ``rs``;
    {} for any other kernel."""
    if "variants" not in rs[0]:
        return {}
    keys = [k for k in ("ms", "cold_ms", "library_ms", "bound_ms") if k in next(iter(rs[0]["variants"].values()))]
    return {v: {k: sum(r["variants"][v][k] for r in rs) for k in keys} for v in rs[0]["variants"]}


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


def make_session(state, mode, plain=False, warp="auto", fused=False, model_name="MADNet", **session_kw):
    """A session on the card from the weights ``state``, built through the
    entry points a user calls. MADNet's MAD gets the bulkhead, as
    ``cli/adapt.py`` builds it; DispNet takes ``dispnet_full_6.json``, as
    the JAX package's DispNet MAD runs. ``plain`` swaps the kernels for
    their plain versions; ``warp`` is the warp mode of model and loss;
    ``fused`` gives the device-resident session instead of the host one."""
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
    if model_name == "MADNet":
        model = get_stereo_net("MADNet", bulkhead=(mode == "MAD"), warp_mode=warp, **modes)  # device cuda
        config = default_block_config_path("MADNet")
    else:
        model = get_stereo_net(model_name, **modes)
        config = DN_BLOCK_CONFIG
    model.load_state_dict(state)
    blocks = make_blocks(load_block_config(config), model)
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


def assert_trajectory(got, want, what, frames=None, loss_rtol=TRAJ_LOSS_RTOL, epe_rtol=TRAJ_EPE_RTOL):
    """``finalize()`` of a fused session against another's, or against the
    per-frame results of a host session."""
    n = len(want["loss"]) if frames is None else frames
    worst = {}
    for key, rtol in (("loss", loss_rtol), ("epe", epe_rtol)):
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


def assert_controller(got, want, what, score_atol=TRAJ_SCORE_ATOL):
    got = {**got, "fetch_counter": [int(c) for c in got["fetch_counter"]]}
    if got["fetch_counter"] != [int(c) for c in want["fetch_counter"]]:
        raise AssertionError(f"{what}: fetch counter {got['fetch_counter']} against {want['fetch_counter']}")
    err = float(np.max(np.abs(np.asarray(got["scores"], np.float64) - np.asarray(want["scores"], np.float64))))
    log(f"{what}: fetch counter {got['fetch_counter']}, scores within {err:.3g}")
    if not err <= score_atol:
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


MAD_KW = dict(sample_mode="SEQUENTIAL", ssim_th=1e9, seed=0)
TILE_FULL = {"corr_fwd": 5, "warp_tile_image_fwd": 1, "warp_tile_features_fwd": 4,
             "corr_bwd": 5, "warp_tile_image_bwd": 1, "warp_tile_features_bwd": 4}
TILE_SERVE = {"corr_fwd": 5, "warp_tile_features_fwd": 4}  # no loss: no image warp


def fused_mad_in(session, frames, per_frame, checked, what, after_step=None):
    """A fused MAD session over ``frames``: the first ``checked`` frames (a
    round or more) one by one, frame i adding exactly ``per_frame(i)``
    launches, ``after_step(i)`` after each; then one graph per block,
    holding that block's launches; the rest replayed with every host sync
    an error, and timed. Returns (finalize(), launches, steady ms/frame)."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    n_blocks = len(session.engine.blocks)
    cuda_lib.reset_launches()
    first_ms = []
    for i, f in enumerate(frames[:checked]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_counted(session, f, per_frame(i), f"{what} frame {i}")
        torch.cuda.synchronize()
        first_ms.append((time.perf_counter() - t0) * 1e3)
        if after_step:
            after_step(i)
    want_graphs = {("mad", (k,)): {n: c for n, c in per_frame(k).items() if c} for k in range(n_blocks)}
    if session.graph_launches != want_graphs:
        raise AssertionError(f"{what}: graphs hold {session.graph_launches}, want {want_graphs}")
    log(f"{what} first round (eager step + capture) ms/frame {first_ms[:n_blocks]}")
    if checked > n_blocks:
        log(f"{what} checked replays (fenced by a sync) ms/frame {first_ms[n_blocks:]}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        for f in frames[checked:]:
            session.step(f)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / (len(frames) - checked)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (len(frames) - checked)
    log(f"{what} steady: {ms:.3f} ms/frame over {len(frames) - checked} frames with no host sync "
        f"(the host took {enqueue_ms:.3f} ms/frame to enqueue them)")
    launches = dict(cuda_lib.LAUNCHES)
    want = dict.fromkeys(cuda_lib.LAUNCHES, 0)
    for i in range(len(frames)):
        for name, c in per_frame(i).items():
            want[name] += c
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, want {want}")
    stats = session.finalize()
    if stats["steps"] != len(frames) or int(stats["reset_count"]) != 0 or not np.isfinite(stats["loss"]).all():
        raise AssertionError(f"{what}: {stats['steps']} steps, {stats['reset_count']} resets, loss {stats['loss']}")
    return stats, launches, ms


def fused_full_in(state, frames, per_frame, what):
    """A fused FULL session over ``frames``: two frames (eager step and
    capture, then a replay) each adding exactly ``per_frame`` launches, the
    rest timed. Returns (finalize(), launches, ms/frame)."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    session = make_session(state, "FULL", warp="mxu", fused=True, ssim_th=1e9)
    cuda_lib.reset_launches()
    for i, f in enumerate(frames[:2]):
        step_counted(session, f, per_frame, f"{what} frame {i}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in frames[2:]:
        session.step(f)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (len(frames) - 2)
    launches = dict(cuda_lib.LAUNCHES)
    if launches != {**dict.fromkeys(cuda_lib.LAUNCHES, 0), **{k: v * len(frames) for k, v in per_frame.items()}}:
        raise AssertionError(f"{what}: launches {launches}")
    stats = session.finalize()
    if stats["steps"] != len(frames) or not np.isfinite(stats["loss"]).all():
        raise AssertionError(f"{what}: {stats['steps']} steps, loss {stats['loss']}")
    return stats, launches, ms


def fused_serve_in(state, frames, per_frame, what, model_name="MADNet"):
    """Fused NONE serving without metrics over ``frames``, each adding
    ``per_frame`` launches. Returns (launches, ms/frame, the served
    disparities, the session)."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    session = make_session(state, "NONE", warp="mxu", fused=True, model_name=model_name, compute_metrics=False)
    serve = [{k: f[k] for k in ("left", "right")} for f in frames]
    cuda_lib.reset_launches()
    disps = list(session.serve(serve[:2]))  # eager and capture, then a replay
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    disps += list(session.serve(serve[2:]))
    ms = (time.perf_counter() - t0) * 1e3 / (len(serve) - 2)
    launches = dict(cuda_lib.LAUNCHES)
    want = {**dict.fromkeys(cuda_lib.LAUNCHES, 0), **{k: v * len(serve) for k, v in per_frame.items()}}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, want {want}")
    if len(disps) != len(serve) or any(
        d.shape != (1, H, W, 1) or d.dtype != np.float32 or not np.isfinite(d).all() for d in disps
    ):
        raise AssertionError(f"{what}: bad served disparities")
    return launches, ms, disps, session


def assert_served(state, frames, disps, what, model_name="MADNet", rtol=MODEL_RTOL):
    """Each served disparity is its own frame's: the host session's, for
    the first frame and the last, within ``rtol`` of the largest."""
    host = make_session(state, "NONE", warp="mxu", model_name=model_name)
    for i in (0, len(disps) - 1):
        ref = host.step(frames[i])["disp"].float().cpu().numpy()
        err = float(np.abs(disps[i] - ref).max()) / float(np.abs(ref).max())
        log(f"{what}: served disparity {i} against the host session: {err:.3g} of the largest")
        if not err <= rtol:
            raise AssertionError(f"{what}: disparity {i} is not frame {i}'s")


def run_fused(state, profile_dir):
    """Phase 6: the fused device session at 320x1216 with the tiled one-hot
    warps in model and loss. Returns (launches by path, ms/frame by path)."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    launches, frame_ms = {}, {}
    frames = smooth_frames(N_FRAMES_FUSED, 100)

    # --- MAD, SEQUENTIAL: two rounds checked frame by frame, then two rounds
    # free-running with every host sync turned into an error
    session = make_session(state, "MAD", warp="mxu", fused=True, **MAD_KW)
    if not session.use_graphs:
        raise AssertionError("the fused session must replay graphs on the card")
    n_blocks = len(session.engine.blocks)
    checked = 2 * n_blocks
    prev = [session.arena.flat.clone()]

    def owns_block(i):
        # the step moved the sampled block's arena range and nothing else
        k = i % n_blocks
        moved = (session.arena.flat != prev[0]).nonzero().flatten()
        prev[0] = session.arena.flat.clone()
        start, end = session.arena.block_ranges[k]
        if moved.numel() == 0 or int(moved.min()) < start or int(moved.max()) >= end:
            raise AssertionError(f"fused MAD frame {i}: block {k} owns [{start}, {end}) but the "
                                 f"arena moved in [{int(moved.min()) if moved.numel() else None}, "
                                 f"{int(moved.max()) if moved.numel() else None}]")

    torch.cuda.reset_peak_memory_stats()
    fused, launches["FUSED_MAD"], frame_ms["FUSED_MAD"] = fused_mad_in(
        session, frames, lambda i: mad_tile_launches(i % n_blocks), checked, "fused MAD", owns_block)
    log(f"fused MAD peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    fused_flat = session.arena.flat.clone()
    fused_disp = session.last_disp.clone()

    # the host session over the same frames and weights with the same warps
    host = make_session(state, "MAD", warp="mxu", **MAD_KW)
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
    eager = make_session(state, "MAD", warp="mxu", fused=True, use_graphs=False, **MAD_KW)
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
    other = make_session(state, "MAD", warp="cuda", fused=True, **MAD_KW)
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
    shared = make_session(state, "MAD", warp="mxu", fused=True, shared_forward=True, **MAD_KW)
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
    chunked = make_session(state, "MAD", warp="mxu", fused=True, **MAD_KW)
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
    fused, launches["FUSED_FULL"], frame_ms["FUSED_FULL"] = fused_full_in(
        state, frames[:N_FRAMES_FULL + 3], TILE_FULL, "fused FULL")
    host = make_session(state, "FULL", warp="mxu", **full_kw)
    frame_ms["HOST_FULL_MXU"] = timed_host(host, frames[:N_FRAMES_FULL + 3], warm=1)
    assert_trajectory(fused, host_stats(host), "fused FULL against the host session")
    del host

    # --- NONE: with metrics (the loss runs), then serving without
    none_launches = {**TILE_SERVE, "warp_tile_image_fwd": 1}
    session = make_session(state, "NONE", warp="mxu", fused=True)
    cuda_lib.reset_launches()
    for i, f in enumerate(frames[:3]):
        step_counted(session, f, none_launches, f"fused NONE frame {i}")
    host = make_session(state, "NONE", warp="mxu")
    for f in frames[:3]:
        host.step(f)
    assert_trajectory(session.finalize(), host_stats(host), "fused NONE against the host session")
    del session, host
    launches["FUSED_NONE"], frame_ms["FUSED_NONE_SERVE"], disps, session = fused_serve_in(
        state, frames[:N_FRAMES_NONE + 3], TILE_SERVE, "fused NONE serving")
    assert_served(state, frames, disps, "fused NONE serving")
    del session

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
        # the tiled warps (K6/K7), and FULL once more on the default route,
        # warp_mode 'auto': the clamped-window warps (K2-K5) on the card
        for mode, kw, warp, tag in (("MAD", MAD_KW, "mxu", "fused_mad"), ("FULL", full_kw, "mxu", "fused_full"),
                                    ("NONE", {}, "mxu", "fused_none"),
                                    ("FULL", full_kw, "auto", "fused_full_auto")):
            session = make_session(state, mode, warp=warp, fused=True, **kw)
            for f in frames[:n_blocks]:
                session.step(f)  # every branch captured
            torch.cuda.synchronize()
            profile_frames(session, frames[n_blocks : 2 * n_blocks], Path(profile_dir), tag)
    return launches, frame_ms


# ------------------------------------------------------------------ phase 7
N_FRAMES_DN = 12  # two SEQUENTIAL rounds of the six blocks
DN_CORR_BLOCKS = (3, 4)  # conv2 and conv1: the blocks before the correlation
DN_DISP = 20.0  # px that each tamed prediction layer predicts


def seeded_dispnet_params(seed: int):
    """DispNet-Corr1D weights in the JAX layout (``w`` HWIO, transposed
    kernels ``[kh, kw, out, in]``), Xavier-uniform from a numpy seed, with
    small non-zero biases. Each prediction layer (the five blocks'
    ``predict`` and the final ``prediction``) is tamed as MADNet's last
    estimator convs are: weights x0.02 and a bias that predicts DN_DISP px
    once ``_make_disp`` has scaled it by the padded width over its own. With
    Xavier weights alone the relu there zeroes a prediction everywhere and
    its block gets no gradient."""
    from real_time_self_adaptive_deep_stereo_torch.models import DispNet

    shapes = {k: tuple(v.shape) for k, v in DispNet(device="cpu").state_dict().items()}
    scale = {"prediction": 2, **{f"up{i}": 2 ** (i + 1) for i in range(1, 6)}}
    r = np.random.default_rng(seed)
    tree = {}
    for key, shape in sorted(shapes.items()):
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        tamed = path[-1] in ("predict", "prediction")
        if leaf == "weight":  # OIHW or [in, out, kh, kw]: the JAX layout reverses the axes
            s0, s1, kh, kw = shape
            lim = math.sqrt(6.0 / (kh * kw * (s0 + s1)))
            node["w"] = (r.uniform(-lim, lim, (kh, kw, s1, s0)) * (0.02 if tamed else 1.0)).astype(np.float32)
        else:
            bias = 0.01 * r.standard_normal(shape) + (DN_DISP / scale[path[0]] if tamed else 0.0)
            node["b"] = bias.astype(np.float32)
    return tree


def dn_launches(mode: str, k: int = 0, tiled: bool = False):
    """What one DispNet frame must launch: the wide correlation forward,
    and the loss's image warp (the tiled kernels on the fused route)."""
    img_fwd, img_bwd = ("warp_tile_image_fwd", "warp_tile_image_bwd") if tiled else (
        "warp_image_fwd", "warp_image_bwd")
    if mode == "NONE":
        return {"corr_fwd_wide": 1, img_fwd: 1}
    if mode == "FULL":
        return {"corr_fwd_wide": 1, "corr_bwd_wide": 1, img_fwd: 1, img_bwd: 1}
    # MAD: block loss + full loss; a gradient back through the correlation
    # for the blocks before it only
    return {"corr_fwd_wide": 1, img_fwd: 2, img_bwd: 1, **({"corr_bwd_wide": 1} if k in DN_CORR_BLOCKS else {})}


def check_dispnet_against_plain(state):
    """One frame of NONE, MAD (block 3, through the correlation, and block
    5) and FULL with the kernels and with the plain modes on the card: the
    disparities of the frame's forward and of a forward after the step
    within MODEL_RTOL of the largest, the gradient within STEP_RTOL of its
    largest entry; the plain sessions launch no kernel."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    frame = make_smooth_frame(8)
    images = [torch.from_numpy(frame[k]).cuda() for k in ("left", "right")]
    for mode, kw in (("NONE", {}), ("MAD", dict(sample_mode="FIXED", fixed_id=3)),
                     ("MAD", dict(sample_mode="FIXED", fixed_id=5)), ("FULL", {})):
        what = f"DispNet {mode}{' block %d' % kw['fixed_id'] if kw else ''}"
        runs = []
        for plain in (False, True):
            session = make_session(state, mode, plain=plain, model_name="Dispnet", ssim_th=1e9, **kw)
            cuda_lib.reset_launches()
            disp = session.step(frame)["disp"]
            launched = {n: c for n, c in cuda_lib.LAUNCHES.items() if c}
            want = {} if plain else dn_launches(mode, kw.get("fixed_id", 0))
            if launched != want:
                raise AssertionError(f"{what} {'plain' if plain else 'kernels'}: launches {launched}, want {want}")
            with torch.no_grad():
                after = session.engine.model(*images)["disparities"]
            acc = session.engine.opt["acc"] if mode != "NONE" else {}
            runs.append(([disp, *after], acc))
        (fast, fast_acc), (plain_d, plain_acc) = runs
        worst = 0.0
        for i, (a, b) in enumerate(zip(fast, plain_d)):
            scale = max(float(b.abs().max()), 1e-6)
            worst = max(worst, float((a - b).abs().max()) / scale)
            torch.testing.assert_close(a, b, rtol=MODEL_RTOL, atol=MODEL_RTOL * scale,
                                       msg=lambda m, i=i: f"{what} disparity {i}: {m}")
        msg = f"{what}, kernels vs plain modes: disparities within {worst:.3g} of the largest"
        if fast_acc:
            g_scale = max(float(v.abs().max()) for v in plain_acc.values())
            g_err = max(float((fast_acc[k] - plain_acc[k]).abs().max()) for k in plain_acc)
            msg += f"; gradient within {g_err / g_scale:.3g} of its largest entry {g_scale:.3g}"
            if not (g_scale > 0 and g_err <= STEP_RTOL * g_scale):
                raise AssertionError(msg)
        log(msg)


def run_dispnet(profile_dir):
    """Phase 7: DispNet-Corr1D's sessions at 320x1216. Returns (launches
    by path, ms/frame by path)."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib
    from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import params_from_jax

    state = params_from_jax(seeded_dispnet_params(1))
    launches, frame_ms = {}, {}

    session = make_session(state, "NONE", model_name="Dispnet")
    _, _, launches["DISPNET_NONE"], frame_ms["DISPNET_NONE"] = drive(
        session, make_frames(N_FRAMES_NONE, 11), lambda i: dn_launches("NONE"))
    if profile_dir:
        profile_frames(session, make_frames(3, 12), Path(profile_dir), "dispnet_none")

    session = make_session(state, "MAD", model_name="Dispnet", sample_mode="SEQUENTIAL", ssim_th=1e9, seed=0)
    blocks = session.engine.blocks
    if len(blocks) != 6:
        raise AssertionError(f"DispNet MAD: {len(blocks)} blocks")

    def after_step(i, before):
        k = i % len(blocks)
        changed = changed_names(session, before)
        if not changed or not changed <= set(blocks[k].names):
            raise AssertionError(f"DispNet MAD frame {i}: block {k} was trained but "
                                 f"{sorted(changed) or 'nothing'} changed")

    _, step_ms, launches["DISPNET_MAD"], frame_ms["DISPNET_MAD"] = drive(
        session, make_frames(N_FRAMES_DN, 13), lambda i: dn_launches("MAD", i % len(blocks)),
        after_step, warm=len(blocks))
    by_block = {k: statistics.median(step_ms[k + len(blocks) :: len(blocks)]) for k in range(len(blocks))}
    log(f"DispNet MAD ms/frame by block trained (second round): {by_block}")
    if profile_dir:
        profile_frames(session, make_frames(len(blocks), 14), Path(profile_dir), "dispnet_mad")

    session = make_session(state, "FULL", model_name="Dispnet", ssim_th=1e9)
    _, _, launches["DISPNET_FULL"], frame_ms["DISPNET_FULL"] = drive(
        session, make_frames(N_FRAMES_FULL, 15), lambda i: dn_launches("FULL"))
    if profile_dir:
        profile_frames(session, make_frames(3, 16), Path(profile_dir), "dispnet_full")
    del session

    check_dispnet_against_plain(state)

    # the fused session, tiled warps in the loss: a round checked frame by
    # frame (eager step and capture), then replays, against the host session
    frames = smooth_frames(N_FRAMES_DN + 6, 200)
    session = make_session(state, "MAD", warp="mxu", fused=True, model_name="Dispnet", **MAD_KW)
    fused, launches["DISPNET_FUSED_MAD"], frame_ms["DISPNET_FUSED_MAD"] = fused_mad_in(
        session, frames, lambda i: dn_launches("MAD", i % len(blocks), tiled=True), N_FRAMES_DN, "DispNet fused MAD")
    host = make_session(state, "MAD", warp="mxu", model_name="Dispnet", **MAD_KW)
    frame_ms["DISPNET_HOST_MAD_MXU"] = timed_host(host, frames, warm=len(blocks))
    assert_trajectory(fused, host_stats(host), "DispNet fused MAD against the host session")
    assert_controller(fused, host_stats(host), "DispNet fused MAD against the host session")
    if profile_dir:
        profile_frames(session, frames[:len(blocks)], Path(profile_dir), "dispnet_fused_mad")
    del session, host

    # fused NONE serving: no loss, so the correlation alone
    launches["DISPNET_FUSED_NONE"], frame_ms["DISPNET_FUSED_NONE_SERVE"], disps, _ = fused_serve_in(
        state, frames[:N_FRAMES_NONE + 3], {"corr_fwd_wide": 1}, "DispNet fused NONE serving", model_name="Dispnet")
    assert_served(state, frames, disps, "DispNet fused NONE serving", model_name="Dispnet")
    return launches, frame_ms


# ------------------------------------------------------------------ phase 8
PRECISIONS = ("default", "bf16", "bf16_act")
N_FRAMES_PREC = 15  # three SEQUENTIAL rounds; the first runs eagerly and captures
# JAX tests/test_adapt.py::test_bf16_act_forward_drift_bounded: the median
# of |d - d_highest| / max(|d_highest|, 1) over the first frame's full-res
# disparity
DRIFT_MEDIAN = 0.05
# the per-frame EPE of the first MAD round (each block trained once from
# the same weights) against highest's, relative: the same class of bound as
# the disparity's drift. Later rounds are printed, not bounded: on these
# random-weight trajectories each second step of block 0 moves the EPE by
# some 110 px in every mode (34 to 280 px over 15 frames at highest, with a
# flat loss), and a divergent trajectory amplifies any rounding difference
PREC_EPE_RTOL = 0.05
# fused against host MAD in a mode: the same ops on the same frames (under
# bf16_act they agreed exactly); cuDNN's bf16 backward rounds its weight
# gradient to bf16 and is not run to run deterministic, so a step's weights
# may differ in the last bf16 digit of a gradient where fp32 differs in the
# seventh decimal. Under default the two sessions' TF32 convolutions do not
# round alike (frame 0's loss, before any step, differed by 1.2e-5) and the
# random-weight trajectory amplifies that (1.5e-3 by frame 7), so there the
# first round (each block trained once) is bounded, in the bf16 modes every
# frame
PREC_TRAJ_LOSS_RTOL = 1e-3
PREC_TRAJ_EPE_RTOL = 1e-2
PREC_SCORE_ATOL = 1e-4
# a served disparity against the host session's, of the largest: one bf16
# ulp in the bf16 modes; under default 1e-2, as the two sessions' TF32
# convolutions round apart and 49 layers add it up (measured 1.3e-3). A
# frame served out of order is whole pixels off
PREC_SERVE_RTOL = {"default": 1e-2, "bf16": 2.0**-8, "bf16_act": 2.0**-8}
# bf16_act steps, kernels against plain modes: at least this share of the
# entries where the plain modes' bf16_act and highest results differ lies
# closer to the bf16_act one; the kernels run at highest (the control)
# score about 0
PREC_SHARE = 0.5


def in_precision(table, mode):
    """A launch table as ``mode`` runs it: the correlation's bf16 instances
    under bf16_act (the features are bf16), the fp32 ones otherwise."""
    if mode != "bf16_act":
        return dict(table)
    return {(f"{k}_bf16" if k.startswith("corr") else k): v for k, v in table.items()}


def assert_tf32(mode):
    got = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if got != (False, mode == "default"):
        raise AssertionError(f"{mode}: tf32 matmul/cudnn {got}, want (False, {mode == 'default'})")


def drift(got, want):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    return float(np.median(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))


def closer_share(got, want, highest):
    """Among the entries where ``want`` (a mode's reference) and
    ``highest`` differ, the share at which ``got`` lies closer to ``want``."""
    differ = want != highest
    if not bool(differ.any()):
        raise AssertionError("the mode's reference equals highest's")
    return float(((got - want).abs()[differ] < (got - highest).abs()[differ]).float().mean())


def check_bf16_act_against_plain(mad_state, dn_state):
    """One bf16_act MAD step of MADNet (block 4) and of DispNet (block 3,
    back through the wide bf16 correlation) with the kernels and with the
    plain modes on the card. The plain modes' steps at bf16_act and at
    highest are the references: at the entries where the two differ, the
    kernels' disparity (the frame's forward) and gradient lie closer to the
    bf16_act one at PREC_SHARE of them or more, and the kernels run at
    highest, the control, at fewer. The plain runs launch no kernel; the
    kernels' runs launch the bf16 correlation under bf16_act only."""
    from real_time_self_adaptive_deep_stereo_torch.ops import conv_precision, cuda_lib

    frame = make_smooth_frame(4)
    for model_name, state, block in (("MADNet", mad_state, 4), ("Dispnet", dn_state, 3)):
        runs = {}
        for mode, plain in (("bf16_act", False), ("bf16_act", True), ("highest", True), ("highest", False)):
            with conv_precision(mode):
                session = make_session(state, "MAD", plain=plain, model_name=model_name, ssim_th=1e9,
                                       sample_mode="FIXED", fixed_id=block)
                cuda_lib.reset_launches()
                disp = session.step(frame)["disp"].float().flatten()
            launched = {n for n, c in cuda_lib.LAUNCHES.items() if c}
            corr = {n for n in launched if n.startswith("corr")}
            if (plain and launched) or (not plain and (not corr or any(
                    n.endswith("_bf16") != (mode == "bf16_act") for n in corr))):
                raise AssertionError(f"{model_name} {mode} {'plain' if plain else 'kernels'}: launched {launched}")
            acc = session.engine.opt["acc"]
            runs[mode, plain] = (disp, torch.cat([acc[k].flatten() for k in sorted(acc)]))
        ref, highest = runs["bf16_act", True], runs["highest", True]
        for i, what in enumerate(("disparity", "gradient")):
            scale = float(ref[i].abs().max())
            kernels = [runs[mode, False][i] for mode in ("bf16_act", "highest")]
            share, control = (closer_share(k, ref[i], highest[i]) for k in kernels)
            err, gap = (float((k - ref[i]).abs().max()) / scale for k in kernels)
            log(f"{model_name} bf16_act MAD block {block} {what}, kernels vs plain modes: within {err:.3g} of the "
                f"largest, closer to the plain bf16_act result at {share:.3f} of the entries where it differs from "
                f"highest's; the kernels at highest (control): {gap:.3g}, {control:.3f} (bound {PREC_SHARE})")
            if not (share >= PREC_SHARE > control):
                raise AssertionError(f"{model_name} bf16_act {what}: the kernels do not follow the plain modes")


def run_precision(state, profile_dir):
    """Phase 8: the precision modes on the card. MADNet's fused MAD, host
    MAD and fused NONE serving in every mode against highest on the same
    frames and weights, fused against host; under bf16_act also fused FULL,
    DispNet's host MAD (blocks 3-4 run the wide bf16 backward) and fused
    NONE serving, and one step of each model with the kernels against the
    plain modes. Returns (launches by path, ms/frame by path)."""
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.ops import conv_precision
    from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import params_from_jax
    from real_time_self_adaptive_deep_stereo_torch.utils.device import resolve_device

    launches, frame_ms = {}, {}
    dn_state = params_from_jax(seeded_dispnet_params(1))
    frames = smooth_frames(N_FRAMES_PREC, 300)
    first = [torch.from_numpy(frames[0][k]).cuda() for k in ("left", "right")]

    def first_frame_disp():
        model = get_stereo_net("MADNet", bulkhead=True, warp_mode="mxu")
        model.load_state_dict(state)
        with torch.no_grad():
            return model(*first)["full_res_disp"]

    def fused_mad(mode):
        session = make_session(state, "MAD", warp="mxu", fused=True, **MAD_KW)
        assert_tf32(mode)
        n = len(session.engine.blocks)
        stats, counts, ms = fused_mad_in(session, frames, lambda i: in_precision(mad_tile_launches(i % n), mode),
                                         n, f"{mode} fused MAD")
        return stats, counts, ms, session

    ref_disp = first_frame_disp()
    ref, _, frame_ms["PREC_HIGHEST_FUSED_MAD"], session = fused_mad("highest")
    n_blocks = len(session.engine.blocks)
    del session
    for mode in PRECISIONS:
        tag = f"PREC_{mode.upper()}"
        with conv_precision(mode):
            disp = first_frame_disp()
            if disp.dtype != torch.float32 or not bool(torch.isfinite(disp).all()):
                raise AssertionError(f"{mode}: first frame's disparity {disp.dtype}")
            d = drift(disp, ref_disp)
            log(f"{mode}: first frame's full-res disparity against highest: median relative error {d:.4g} "
                f"(bound {DRIFT_MEDIAN})")
            if not d < DRIFT_MEDIAN:
                raise AssertionError(f"{mode}: drift {d} from highest")

            stats, launches[f"{tag}_FUSED_MAD"], frame_ms[f"{tag}_FUSED_MAD"], session = fused_mad(mode)
            rel = np.abs(stats["epe"] - ref["epe"]) / ref["epe"]
            log(f"{mode} fused MAD EPE per frame {np.round(stats['epe'], 4).tolist()}; highest "
                f"{np.round(ref['epe'], 4).tolist()}; largest relative difference over the first round "
                f"{float(rel[:n_blocks].max()):.4g} (bound {PREC_EPE_RTOL}), over all {len(rel)} frames "
                f"{float(rel.max()):.4g} (not bounded); loss {np.round(stats['loss'], 6).tolist()}")
            if not float(rel[:n_blocks].max()) <= PREC_EPE_RTOL:
                raise AssertionError(f"{mode} fused MAD: EPE departs from highest's")
            if profile_dir and mode == "bf16_act":
                profile_frames(session, frames[:5], Path(profile_dir), "fused_mad_bf16_act")
            del session

            # host MAD over the same frames, against the fused trajectory
            host = make_session(state, "MAD", warp="mxu", **MAD_KW)
            _, _, launches[f"{tag}_HOST_MAD"], frame_ms[f"{tag}_HOST_MAD"] = drive(
                host, frames, lambda i: in_precision(mad_tile_launches(i % n_blocks), mode), warm=n_blocks)
            assert_trajectory(stats, host_stats(host), f"{mode} fused MAD against the host session",
                              frames=n_blocks if mode == "default" else None,
                              loss_rtol=PREC_TRAJ_LOSS_RTOL, epe_rtol=PREC_TRAJ_EPE_RTOL)
            assert_controller(stats, host_stats(host), f"{mode} fused MAD against the host session",
                              score_atol=PREC_SCORE_ATOL)
            del host

            serve_rtol = PREC_SERVE_RTOL[mode]
            launches[f"{tag}_FUSED_NONE"], frame_ms[f"{tag}_FUSED_NONE_SERVE"], disps, session = fused_serve_in(
                state, frames[:N_FRAMES_NONE + 3], in_precision(TILE_SERVE, mode), f"{mode} fused NONE serving")
            assert_served(state, frames, disps, f"{mode} fused NONE serving", rtol=serve_rtol)
            if profile_dir and mode == "bf16_act":
                profile_frames(session, [{k: f[k] for k in ("left", "right")} for f in frames[:5]],
                               Path(profile_dir), "fused_none_bf16_act")
            del session
            if mode != "bf16_act":
                continue

            _, launches[f"{tag}_FUSED_FULL"], frame_ms[f"{tag}_FUSED_FULL"] = fused_full_in(
                state, frames[:N_FRAMES_FULL + 3], in_precision(TILE_FULL, mode), "bf16_act fused FULL")
            if profile_dir:
                session = make_session(state, "FULL", warp="mxu", fused=True, ssim_th=1e9)
                for f in frames[:2]:
                    session.step(f)  # the branch captured and replayed once
                torch.cuda.synchronize()
                profile_frames(session, frames[2:7], Path(profile_dir), "fused_full_bf16_act")
                del session

            # DispNet-Corr1D: host MAD over dispnet_full_6.json, fused NONE serving
            session = make_session(dn_state, "MAD", model_name="Dispnet", **MAD_KW)
            results, _, launches[f"{tag}_DISPNET_HOST_MAD"], frame_ms[f"{tag}_DISPNET_HOST_MAD"] = drive(
                session, make_frames(N_FRAMES_DN, 13), lambda i: in_precision(dn_launches("MAD", i % 6), mode), warm=6)
            if any(r["disp"].dtype != torch.bfloat16 for r in results):
                raise AssertionError("DispNet under bf16_act: the disparities must be bf16, as the reference's")
            del session
            launches[f"{tag}_DISPNET_FUSED_NONE"], frame_ms[f"{tag}_DISPNET_FUSED_NONE_SERVE"], disps, session = (
                fused_serve_in(dn_state, frames[:N_FRAMES_NONE + 3], in_precision({"corr_fwd_wide": 1}, mode),
                               "bf16_act DispNet fused NONE serving", model_name="Dispnet"))
            if session.last_disp.dtype != torch.bfloat16:
                raise AssertionError(f"DispNet fused serving under bf16_act: {session.last_disp.dtype}")
            assert_served(dn_state, frames, disps, "bf16_act DispNet fused NONE serving", model_name="Dispnet",
                          rtol=serve_rtol)
            del session

    check_bf16_act_against_plain(state, dn_state)
    resolve_device("cuda")
    assert_tf32("highest")
    log("precision phase done; back under highest, TF32 off")
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
    ("the port's kernels",
     r"corr_fwd|corr_bwd|warp_fwd_kernel|feat_gather_fwd|warp_bwd_|feat_bwd_|tile_image_fwd|tile_feat_fwd|tile_bwd_"),
    ("cuDNN backward (dgrad, wgrad)", r"dgrad|wgrad"),
    ("cuDNN/cuBLAS convolutions and matmuls, incl. FFT and layout transforms",
     r"fprop|convolve|region_transform|fft|DSE::|gemm|gemv|cudnn|flip_filter|xmma|cutlass"),
    ("PyTorch elementwise, reduce, pad, cat, copy", r"."),
)


def summarise_trace(trace: Path, tag: str, n_frames: int):
    """Device time a frame by kind of kernel, and the host's side, from the
    Chrome trace that torch.profiler wrote."""
    events = [e for e in json.loads(trace.read_text())["traceEvents"] if e.get("ph") == "X"]
    groups, ours = {}, {}
    for e in events:
        if e.get("cat") in ("gpu_memcpy", "gpu_memset"):
            name = "memcpy and memset (the frame's upload from pageable memory)"
        elif e.get("cat") == "kernel":
            name = next(g for g, pat in _GROUPS if re.search(pat, e["name"]))
            if name == _GROUPS[0][0]:  # the port's kernels, by kernel and instance
                m = re.search(r"(\w+_kernel)(<[^(]*>)?", e["name"])
                kernel = m.group(0) if m else e["name"]
                n, dur = ours.get(kernel, (0, 0.0))
                ours[kernel] = (n + 1, dur + e["dur"])
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
    for name, (n, dur) in sorted(ours.items(), key=lambda kv: -kv[1][1]):
        log(f"profile {tag}:   {dur / 1e3 / n_frames:8.4f} ms/frame {n / n_frames:5.1f} launches/frame  {name}")
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
    ap.add_argument("--dispnet-only", action="store_true",
                    help="run the DispNet phase (7) alone, without the result lines")
    ap.add_argument("--precision-only", action="store_true",
                    help="check the bf16 kernels and run the precision phase (8) alone, "
                         "without the result lines")
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
    for lib, kernel in (("correlation", "corr_fwd_kernel"),
                        ("warp_tile", "tile_image_fwd_kernel"), ("warp_tile", "tile_feat_fwd_kernel"),
                        ("warp_tile", "tile_bwd_offset_kernel"), ("warp_tile", "tile_bwd_source_kernel"),
                        ("warp", "feat_bwd_offset_kernel"), ("warp", "feat_bwd_source_kernel"),
                        ("correlation", "corr_fwd_wide_kernel"), ("correlation", "corr_bwd_wide_kernel")):
        usage = cuda_lib.ptxas_usage(cuda_lib.BUILD_LOGS.get(lib, ""), kernel) or ["cached build, no report"]
        log(f"ptxas {kernel}: {'; '.join(usage)}")

    if args.precision_only:
        rows = {name: [] for name in REPLACES}
        check_bf16_kernels(ops, rows)
        for name, rs in rows.items():
            for r in rs:
                log(f"kernel {name} {r}")
        _, frame_ms = run_precision(params_from_jax(seeded_jax_params(0)), args.profile)
        for mode, ms in frame_ms.items():
            log(f"session {mode} ms/frame {ms!r}")
        log(card)
        log("precision checked; no result lines (--precision-only)")
        return 0
    if args.fused_only or args.dispnet_only:
        if args.fused_only:
            _, frame_ms = run_fused(params_from_jax(seeded_jax_params(0)), args.profile)
        else:
            _, frame_ms = run_dispnet(args.profile)
        for mode, ms in frame_ms.items():
            log(f"session {mode} ms/frame {ms!r}")
        log("sessions checked; no result lines (--fused-only, --dispnet-only)")
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
    for phase in (run_fused, lambda _, profile: run_dispnet(profile), run_precision):
        phase_launches, phase_ms = phase(state, args.profile)
        launches.update(phase_launches)
        frame_ms.update(phase_ms)

    kernels = []
    for name, rs in rows.items():
        lib_ms = [r["library_ms"] for r in rs]
        shape_keys = ("shape", "radius", "ms", "cold_ms", "call_ms", "fp32_ms", "plain_ms", "bound_ms",
                      "library_ms", "variants", "wide_ms")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            # every path driven, MADNet's and DispNet's, host and fused, the
            # counters set to 0 before each and read after it
            "launches": sum(launches[path][name] for path in launches),
            "launches_by_path": {path: launches[path][name] for path in launches},
            "max_abs_err": max(r["err"] for r in rs),
            # one call at each main-path shape: the sums over the shapes
            "ms": sum(r["ms"] for r in rs),
            # K1 and the tiled backward: the same with the L2 cold
            **({"cold_ms": sum(r["cold_ms"] for r in rs)} if "cold_ms" in rs[0] else {}),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rs) else "operations",
            "library_ms": None if None in lib_ms else sum(lib_ms),
            # warp backward kernels: each variant (the gradients asked for)
            # summed over the shapes, and the variant each mode runs
            **({"variants": summed_variants(rs), "modes": rs[0]["modes"]} if "variants" in rs[0] else {}),
            # bf16 instances: the fp32 instance's time at the same shapes
            **({"fp32_ms": sum(r["fp32_ms"] for r in rs)} if "fp32_ms" in rs[0] else {}),
            "shapes": [{k: r[k] for k in shape_keys if k in r} for r in rs],
        })
    idle = [k["name"] for k in kernels if not any(k["launches_by_path"].values())]
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
