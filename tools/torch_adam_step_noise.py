#!/usr/bin/env python3
"""How far the live demo's MAD gradients are from float64, by route, and
what that does to Adam's first step.

    python tools/torch_adam_step_noise.py [--device cuda|cpu] [--frames N] [--out FILE]

On the first ``--frames`` frames of ``chip_smoke.py`` phase 11 (scenes 2-3
of ``tests/fixtures/realworld``, 320x1216, ``weights_scene01.npz``, MADNet
with the bulkhead, ``block_config/MadNet_full.json``), for every MAD block:
the gradient of the block's loss with respect to its own parameters, from
one forward, as ``AdaptationEngine.adapt_blocks`` takes it, in each route:

* ``fp64``: the plain modes (``corr_mode="torch"``, ``warp_mode="clamped"``)
  in float64, the yardstick;
* ``plain``: the plain modes in float32;
* on a GPU also ``kernels`` (the CUDA kernels, the demo's route; twice, to
  show what two runs of one route differ by), ``corr_kernel`` (the
  correlation kernels alone; ``corr_kernel_fwd`` and ``corr_kernel_bwd``
  with the plain version on the card the other way), ``feat_warp_kernel``
  (the feature warp kernels alone) and ``image_warp_kernel`` (the loss's
  image warp kernels alone).

Per route and block, against ``fp64``: ``rel``, the largest error over the
largest entry; ``adam``, Adam's first step in units of lr,
``g / (|g| + 1e-8 / sqrt(1 - 0.999))`` (TF-form Adam, ``utils/optim.py``),
and of it ``off``, the share of entries whose step is off by more than
half an lr, and ``rms``, the root mean square of the difference. On a GPU
also the cost volumes of the first frame, the correlation kernel's and
its plain version's, against float64. Prints one line a route and block
and writes them all to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# TF-form Adam's first step: lr * g / (|g| + eps / sqrt(1 - b2))
ADAM_EPS_1 = 1e-8 / math.sqrt(1 - 0.999)


def frames(n: int):
    """The first ``n`` frames of phase 11's list: NHWC float32 0-255."""
    import chip_smoke
    from real_time_self_adaptive_deep_stereo_torch.data.readers import load_image

    scenes = chip_smoke.CLI_SCENES["scene"]
    out = []
    for i in range(n):
        s = scenes[i % len(scenes)]
        left, right = (load_image(str(chip_smoke.FIXTURE_DIR / f"{s}_{p}.png")) for p in ("left", "right"))
        out.append((np.asarray(left, np.float32)[None], np.asarray(right, np.float32)[None]))
    return out


def block_grads(device, dtype, corr_mode, feat_warp, image_warp, pairs):
    """Per frame, per block: the flattened gradient (float64 numpy)."""
    import torch

    import chip_smoke
    from real_time_self_adaptive_deep_stereo_torch.adapt import AdaptationEngine, load_block_config, make_blocks
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.ops import resize
    from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import (
        params_from_jax,
        params_to_jax,
        restore_or_init,
    )

    model = get_stereo_net("MADNet", bulkhead=True, corr_mode=corr_mode, warp_mode=feat_warp, device=device)
    params, restored, _ = restore_or_init("", params_to_jax(model.state_dict()), str(chip_smoke.CLI_WEIGHTS), model)
    assert restored
    model.load_state_dict(params_from_jax(params))
    blocks = make_blocks(load_block_config(str(ROOT / "block_config" / "MadNet_full.json")), model)
    engine = AdaptationEngine(model, blocks, lr=1e-4, optimizer="adam", warp_mode=image_warp, device=device)
    model.to(dtype)
    if dtype != torch.float64:
        return [frame_grads(engine, model, dtype, left, right) for left, right in pairs]
    # the yardstick: the model's fp32 casts (inputs, heads) keep float64,
    # and the resize's interpolation matrices (fp32 weights, exact in
    # float64) are widened
    float32, interp = torch.Tensor.float, resize._interp_tensor
    torch.Tensor.float = lambda t, *a, **kw: t if t.dtype == torch.float64 else float32(t, *a, **kw)
    resize._interp_tensor = lambda *a: interp(*a).double()
    try:
        return [frame_grads(engine, model, dtype, left, right) for left, right in pairs]
    finally:
        torch.Tensor.float, resize._interp_tensor = float32, interp


def frame_grads(engine, model, dtype, left, right):
    """One forward; per block, its loss's gradient (flattened, float64 numpy)."""
    import torch

    frame = {k: torch.from_numpy(v).to(engine.device, dtype) for k, v in (("left", left), ("right", right))}
    engine._set_trainable([p for b in engine.blocks for p in b.params])
    disparities = model(frame["left"], frame["right"])["disparities"]
    per_block = []
    for i, block in enumerate(engine.blocks):
        loss = engine._block_loss(disparities, block.index, frame)
        grads = torch.autograd.grad(loss, block.params, retain_graph=i + 1 < len(engine.blocks), allow_unused=True)
        per_block.append(np.concatenate([
            (torch.zeros_like(p) if g is None else g).detach().double().cpu().numpy().ravel()
            for p, g in zip(block.params, grads)
        ]))
    engine._set_trainable()
    return per_block


@contextlib.contextmanager
def plain_corr_half(route: str):
    """Under ``corr_kernel_fwd`` the correlation's backward, under
    ``corr_kernel_bwd`` its forward, runs the plain version on the card."""
    corr = importlib.import_module("real_time_self_adaptive_deep_stereo_torch.ops.correlation")

    fwd, bwd = corr._corr_fwd_launch, corr._corr_bwd_launch
    if route == "corr_kernel_fwd":
        corr._corr_bwd_launch = lambda x, y, g, max_disp, wide: corr.correlation_torch_bwd(x, y, g, max_disp)
    elif route == "corr_kernel_bwd":
        corr._corr_fwd_launch = lambda x, y, max_disp, wide: corr.correlation_torch(x, y, max_disp)
    try:
        yield
    finally:
        corr._corr_fwd_launch, corr._corr_bwd_launch = fwd, bwd


def compare(g, ref):
    """``rel``, ``off`` and ``rms`` of gradient ``g`` against ``ref``."""
    scale = float(np.abs(ref).max())
    u, u_ref = g / (np.abs(g) + ADAM_EPS_1), ref / (np.abs(ref) + ADAM_EPS_1)
    d = np.abs(u - u_ref)
    return {"rel": float(np.abs(g - ref).max()) / scale, "off": float((d > 0.5).mean()),
            "rms": float(np.sqrt(np.mean(d * d))), "entries": int(g.size)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default where there is one) or cpu")
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    pairs = frames(args.frames)
    routes = {"fp64": (torch.float64, "torch", "clamped", "clamped"),
              "plain": (torch.float32, "torch", "clamped", "clamped")}
    if device == "cuda":
        routes.update({
            "kernels": (torch.float32, "cuda", "cuda", "cuda"),
            "kernels_again": (torch.float32, "cuda", "cuda", "cuda"),
            "corr_kernel": (torch.float32, "cuda", "clamped", "clamped"),
            # the correlation kernel one way, its plain version the other
            "corr_kernel_fwd": (torch.float32, "cuda", "clamped", "clamped"),
            "corr_kernel_bwd": (torch.float32, "cuda", "clamped", "clamped"),
            "feat_warp_kernel": (torch.float32, "torch", "cuda", "clamped"),
            "image_warp_kernel": (torch.float32, "torch", "clamped", "cuda"),
        })
    grads = {}
    for name, route in routes.items():
        with plain_corr_half(name):
            grads[name] = block_grads(device, *route, pairs)
    rows = []
    for name, per_frame in grads.items():
        if name == "fp64":
            continue
        for f, per_block in enumerate(per_frame):
            for k, g in enumerate(per_block):
                row = {"route": name, "frame": f, "block": k, **compare(g, grads["fp64"][f][k])}
                rows.append(row)
                print(f"{name:18s} frame {f} block {k}: rel {row['rel']:.3g}, Adam step off by > lr/2 "
                      f"{100 * row['off']:.4f}% of {row['entries']}, rms {row['rms']:.4g}", flush=True)
    volumes = cost_volume_errors(pairs[:1]) if device == "cuda" else []
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"device": name, "rows": rows, "cost_volumes": volumes}, indent=1) + "\n")
    return 0


def cost_volume_errors(pairs):
    """The correlation kernel's forward and its plain version in float32
    against float64, on the inputs the kernels route gives it at each
    scale: the mean error over the mean magnitude of the terms
    ``|x * y| / C``, and the signed mean error likewise."""
    import torch

    corr = importlib.import_module("real_time_self_adaptive_deep_stereo_torch.ops.correlation")
    seen, launch = [], corr._corr_fwd_launch

    def record(x, y, max_disp, wide):
        seen.append((x.detach().clone(), y.detach().clone(), max_disp))
        return launch(x, y, max_disp, wide)

    corr._corr_fwd_launch = record
    try:
        block_grads("cuda", torch.float32, "cuda", "cuda", "cuda", pairs)
    finally:
        corr._corr_fwd_launch = launch
    out = []
    for x, y, r in seen:
        exact = corr.correlation_torch(x.double(), y.double(), r)
        terms = corr.correlation_torch(x.double().abs(), y.double().abs(), r).mean()
        row = {"shape": list(x.shape), "radius": r}
        for name, got in (("kernel", launch(x, y, r, False)), ("plain", corr.correlation_torch(x, y, r))):
            err = got.double() - exact
            row[name] = {"mean_err": float(err.abs().mean() / terms), "signed_mean_err": float(err.mean() / terms)}
        out.append(row)
        print(f"cost volume {row['shape']}: mean error over the terms' mean, kernel "
              f"{row['kernel']['mean_err']:.3g} (signed {row['kernel']['signed_mean_err']:+.3g}), plain "
              f"{row['plain']['mean_err']:.3g} (signed {row['plain']['signed_mean_err']:+.3g})", flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
