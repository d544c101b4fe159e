#!/usr/bin/env python3
"""End-to-end adaptation validation on synthetic stereo sequences, on the
PyTorch/CUDA port.

The counterpart of ``tools/validate_adaptation.py``. The system's core
claim (CVPR 2019) is that a *pretrained* network adapts online to a new
domain. This tool pretrains MADNet briefly (supervised) on scene A, then
streams a different scene B through the port's fused session in NONE, MAD
and FULL modes and reports the EPE and D1 over the first and the last
fifth of the frames. MAD and FULL must end below NONE; the tool exits
non-zero otherwise.

    python tools/torch_validate_adaptation.py [--height 192 --width 640 --frames 60]
        [--lr 1e-4] [--pretrainSteps 400] [--precision highest] [--device cuda|cpu]

Runs on the card unless ``--device cpu``. It imports the port, numpy and
torch, never JAX. The scenes are made in memory from seeds, as the JAX
tool makes them, but for one difference: the JAX tool smooths the base
texture with ``cv2.filter2D`` only where ``cv2`` imports, and this one
always smooths it, with numpy and cv2's default border (``make_sequence``),
so the scenes are the same on every machine.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

BLOCK_CONFIG = ROOT / "block_config" / "MadNet_full.json"
MODES = ("NONE", "MAD", "FULL")


def box5(a: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(a, -1, np.ones((5, 5), np.float32) / 25)`` on a 2-D
    float32 array: a 5x5 mean with cv2's default border,
    ``BORDER_REFLECT_101`` (numpy's ``"reflect"``, scipy's ``"mirror"``)."""
    h, w = a.shape
    p = np.pad(a, 2, mode="reflect")
    rows = sum(p[i : i + h] for i in range(5))
    return (sum(rows[:, j : j + w] for j in range(5)) * np.float32(1.0 / 25.0)).astype(np.float32)


def make_sequence(h: int, w: int, frames: int, seed: int = 0, d_bg=6.0, d_fg=14.0):
    """Textured drifting scene with two disparity planes: ``frames`` tuples
    of (left [h,w,3], right [h,w,3], ground truth [h,w]) float32 arrays,
    images in 0..255. ``tools/validate_adaptation.py::make_sequence`` with
    the base texture always smoothed (:func:`box5`)."""
    rng = np.random.default_rng(seed)
    base = box5(rng.random((h, w * 2)).astype(np.float32))
    xs = np.arange(w * 2, dtype=np.float32)
    tex = 0.5 * base + 0.25 * np.sin(xs / 7.0)[None, :] + 0.25 * np.cos(
        np.arange(h, dtype=np.float32) / 5.0
    )[:, None]
    tex = (tex - tex.min()) / (tex.max() - tex.min()) * 255.0
    tex3 = np.stack([tex, np.roll(tex, 3, 1), np.roll(tex, 7, 0)], -1)

    gt = np.full((h, w), d_bg, np.float32)
    gt[h // 4 : 3 * h // 4, w // 4 : 3 * w // 4] = d_fg

    seq = []
    for t in range(frames):
        off = t % (w // 2)
        left = tex3[:, off : off + w]
        right = np.empty_like(left)
        # per-row gather: right[x] = left[x + d] -> left warped by gt
        for dval in (d_bg, d_fg):
            mask = gt == dval
            shifted = np.roll(left, -int(dval), axis=1)
            right[mask] = shifted[mask]
        seq.append((left.copy(), right.copy(), gt.copy()))
    return seq


def _frame(left, right, gt, device):
    import torch

    return {
        "left": torch.from_numpy(np.ascontiguousarray(left[None])).to(device),
        "right": torch.from_numpy(np.ascontiguousarray(right[None])).to(device),
        "target": torch.from_numpy(np.ascontiguousarray(gt[None, ..., None])).to(device),
    }


def pretrain(h: int, w: int, steps: int = 400, seed: int = 0, lr: float = 3e-4,
             params: Optional[Dict] = None, device=None) -> Tuple[Dict, np.ndarray]:
    """Short supervised pretraining of MADNet on scene A, as the JAX tool's
    ``pretrain``: the port's seeded MADNet, or ``params`` (a ``state_dict``,
    e.g. ``utils/checkpoint.py::params_from_jax`` of JAX weights); every
    ``estimator_k.disp6`` bias shifted by -0.3 first (a fresh net's heads
    start alive); multi-scale ``mean_l1`` on the coarse scales (weights
    finest-first); the gradient clipped to a global norm of 5; TF-form
    Adam. One eager step a frame of scene A's 8. Returns (the weights as a
    ``state_dict`` of fresh tensors, each step's loss)."""
    import torch

    from real_time_self_adaptive_deep_stereo_torch.losses import get_supervised_loss
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.utils import optim

    model = get_stereo_net("MADNet", device=device, seed=seed)
    if params is not None:
        model.load_state_dict(params)
    # start the disparity heads alive: internal predictions are negative
    # (output = relu(-20 V)) and pixels with V > 0 have no gradient, so a
    # fresh net can collapse dead; a small negative bias (~6 px at full
    # resolution) keeps them alive
    with torch.no_grad():
        for k in (6, 5, 4, 3, 2):
            getattr(model, f"estimator_{k}").disp6.bias.sub_(0.3)
    # the coarse scales only: on one toy scene the finest head overshoots
    # through the relu(-20 V) dead zone, so it stays at its bias
    loss_fn = get_supervised_loss("mean_l1", multiScale=True, max_disp=192, weights=[0, 0, 1, 1, 1, 1])
    weights = list(model.parameters())
    opt = optim.adam_init(weights)
    device = weights[0].device
    batches = [_frame(*f, device) for f in make_sequence(h, w, 8, seed=seed + 100, d_bg=4.0, d_fg=10.0)]
    losses = []
    for i in range(steps):
        batch = batches[i % len(batches)]
        loss = loss_fn(model(batch["left"], batch["right"])["disparities"], batch)
        grads = torch.autograd.grad(loss, weights)
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        clip = torch.clamp(5.0 / (gnorm + 1e-9), max=1.0)
        opt["t"] += 1
        optim.adam_update(weights, opt["m"], opt["v"], [g * clip for g in grads], lr, opt["t"])
        losses.append(loss.detach())
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return state, torch.stack(losses).cpu().numpy()


def run_mode(mode: str, seq, params0: Dict, h: int, w: int, lr: float, seed: int = 0,
             sample_mode: str = "PROBABILITY", device=None) -> Dict[str, np.ndarray]:
    """Scene ``seq`` through the port's fused session in ``mode`` from the
    weights ``params0``, as the JAX tool's ``run_mode``: MADNet (with the
    bulkhead for MAD), ``block_config/MadNet_full.json``, momentum at
    ``lr``, ``ssim_th`` 10, one step a frame, then ``finalize()`` (per
    frame ``epe``, ``bad3``, ``d1``, ``loss``). ``sample_mode`` is the MAD
    sampler (the JAX tool's PROBABILITY by default)."""
    del h, w  # the frames carry the size
    from real_time_self_adaptive_deep_stereo_torch.adapt import (
        AdaptationEngine,
        FusedOnlineSession,
        load_block_config,
        make_blocks,
    )
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net

    model = get_stereo_net("MADNet", bulkhead=(mode == "MAD"), device=device)
    blocks = make_blocks(load_block_config(str(BLOCK_CONFIG)), model)
    engine = AdaptationEngine(model, blocks, lr=lr, device=device)
    sess = FusedOnlineSession(
        engine, {k: v.clone() for k, v in params0.items()}, mode=mode, sample_mode=sample_mode,
        ssim_th=10.0, max_steps=len(seq) + 4, seed=seed,
    )
    for left, right, gt in seq:
        sess.step({"left": left[None], "right": right[None], "target": gt[None, ..., None]})
    return sess.finalize()


def summarize(mode: str, st: Dict[str, np.ndarray]) -> Dict[str, float]:
    """A mode's row: EPE and D1 over the first and the last fifth of the
    frames, and the loss over the last fifth."""
    k = max(1, len(st["epe"]) // 5)
    return {
        "mode": mode,
        "epe_first": float(np.mean(st["epe"][:k])),
        "epe_last": float(np.mean(st["epe"][-k:])),
        "d1_first": float(np.mean(st["d1"][:k])),
        "d1_last": float(np.mean(st["d1"][-k:])),
        "loss_last": float(np.mean(st["loss"][-k:])),
    }


def validate(height: int = 192, width: int = 640, frames: int = 60, lr: float = 1e-4,
             pretrain_steps: int = 400, modes: Sequence[str] = MODES, device=None,
             log=print) -> List[Dict[str, float]]:
    """Pretrain on scene A, then adapt on scene B (seed 7, planes at 8 and
    20 px) in each of ``modes``, under the convolution precision in force.
    Returns the rows of :func:`summarize`, each printed through ``log``."""
    log(f"pretraining on scene A @ {height}x{width} ...")
    params0, losses = pretrain(height, width, steps=pretrain_steps, device=device)
    log(f"pretrain done ({pretrain_steps} steps), final loss {float(losses[-1]):.3f}")
    # scene B: another texture and other disparity planes (the domain shift)
    seq = make_sequence(height, width, frames, seed=7, d_bg=8.0, d_fg=20.0)
    log(f"adapting on scene B: {frames} frames @ {height}x{width}")
    rows = []
    for mode in modes:
        row = summarize(mode, run_mode(mode, seq, params0, height, width, lr, device=device))
        rows.append(row)
        log(f"{mode:5s}  EPE first/last: {row['epe_first']:7.2f} -> {row['epe_last']:7.2f}"
            f"   D1 first/last: {row['d1_first']:6.2f}% -> {row['d1_last']:6.2f}%"
            f"   loss(last): {row['loss_last']:.4f}")
    return rows


def failures(rows: Sequence[Dict[str, float]]) -> List[str]:
    """The adapting modes whose last-fifth EPE is not below NONE's."""
    none_last = next(r["epe_last"] for r in rows if r["mode"] == "NONE")
    return [f"{r['mode']} adaptation did not improve over NONE ({r['epe_last']} vs {none_last})"
            for r in rows if r["mode"] != "NONE" and not r["epe_last"] < none_last]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--pretrainSteps", type=int, default=400)
    ap.add_argument("--precision", default="highest",
                    help="convolution precision: highest, default, bf16 or bf16_act")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from real_time_self_adaptive_deep_stereo_torch.ops import conv_precision

    with conv_precision(args.precision):
        rows = validate(args.height, args.width, args.frames, args.lr, args.pretrainSteps, device=args.device)
    bad = failures(rows)
    for line in bad:
        print(f"FAIL: {line}", file=sys.stderr)
    if bad:
        return 1
    print("OK: both adaptation modes improve EPE over pure inference")
    return 0


if __name__ == "__main__":
    sys.exit(main())
