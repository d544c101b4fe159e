"""Batched offline evaluation CLI — port of the JAX package's
``cli/evaluate.py``: inference-only evaluation over a frame list, the
workload the reference serves by running ``Stereo_Online_Adaptation.py
--mode NONE`` (inference + metrics, no training).

Frames are batched (default 4); each frame's disparity and metrics are
those of a batch-1 run, since the metrics are taken frame by frame. The
remainder is padded up to ``--batch`` with copies of its last frame, whose
metrics are dropped. Nothing is read back until the end: one host fetch of
every frame's metrics fences the run, so decoding overlaps the device.

Emits the same artifacts as ``adapt --mode NONE``: ``stats.csv`` /
``series.csv`` / ``params.sh``, optional 16-bit disparity PNGs.

Run:  python -m real_time_self_adaptive_deep_stereo_torch.cli.evaluate \\
        -l list.csv -o out/ --weights w.npz --modelName MADNet --batch 4
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

MAX_DISP = 256  # clip for serialized disparities (reference static param)


def build_argparser() -> argparse.ArgumentParser:
    from real_time_self_adaptive_deep_stereo_torch.models import STEREO_FACTORY

    p = argparse.ArgumentParser(
        description="Batched offline evaluation of a deep stereo network (PyTorch/CUDA)"
    )
    p.add_argument("-l", "--list", required=True, help="frame list file")
    p.add_argument("-o", "--output", required=True, help="output folder")
    p.add_argument("--weights", required=True, help="weights (.npz, JAX layout)")
    p.add_argument("--modelName", default="MADNet", choices=list(STEREO_FACTORY))
    p.add_argument("--imageShape", type=int, nargs="+", default=[320, 1216])
    p.add_argument(
        "--batch",
        type=int,
        default=4,
        help="frames per forward. Per-frame results are batch-size independent.",
    )
    p.add_argument(
        "--corrMode",
        default="auto",
        choices=["auto", "cuda", "torch"],
        help="correlation: the CUDA kernels, the plain PyTorch version, or "
        "auto (the kernels on the GPU)",
    )
    p.add_argument(
        "--precision",
        default="bf16_act",
        choices=["default", "bf16", "bf16_act", "highest"],
        help="conv precision policy; bf16_act is the serving default "
        "(drift-gated against highest), 'highest' for exact-parity runs",
    )
    p.add_argument(
        "--logDispStep",
        type=int,
        default=-1,
        help="dump a 16-bit disparity PNG every N frames (-1 = never)",
    )
    return p


def main(args, device=None) -> dict:
    """Evaluate ``args`` (``build_argparser``) on ``device``: ``cuda``
    unless ``device="cpu"``; raises where no GPU is available. Sets the
    conv precision of ``--precision`` for the process, as the JAX CLI does."""
    import torch

    from real_time_self_adaptive_deep_stereo_torch.adapt.engine import (
        d1_metric,
        disparity_metrics,
    )
    from real_time_self_adaptive_deep_stereo_torch.cli.adapt import load_model
    from real_time_self_adaptive_deep_stereo_torch.data import (
        StereoDataset,
        prefetch_to_device,
    )
    from real_time_self_adaptive_deep_stereo_torch.ops.conv import set_conv_precision
    from real_time_self_adaptive_deep_stereo_torch.utils.device import resolve_device
    from real_time_self_adaptive_deep_stereo_torch.utils.visual import save_disparity_png

    # before the device: resolve_device sets the TF32 flags from the mode
    set_conv_precision(args.precision)
    device = resolve_device(device)
    os.makedirs(args.output, exist_ok=True)
    if args.logDispStep != -1:
        os.makedirs(os.path.join(args.output, "disparities"), exist_ok=True)

    dataset = StereoDataset(
        args.list,
        batch_size=args.batch,
        crop_shape=args.imageShape,
        num_epochs=1,
        augment=False,
        is_training=False,
        shuffle=False,
    )
    print(f"Decoding frames with {dataset.decoding()}", flush=True)
    n_frames = len(dataset)
    model = load_model(args, device)

    @torch.no_grad()
    def step(left, right, gt):
        disp = model(left, right)["full_res_disp"].float()
        rows = []
        for j in range(disp.shape[0]):  # the metrics reduce over their input: one frame each
            epe, bad3 = disparity_metrics(disp[j : j + 1], gt[j : j + 1])
            _, d1 = d1_metric(disp[j : j + 1], gt[j : j + 1])
            rows.append(torch.stack([epe, bad3, d1]))
        return disp, torch.stack(rows)

    def batches():
        """Pad the eval remainder up to --batch on host so every forward
        has one shape; the padded frames' metrics are dropped below."""
        for b in dataset:
            n = b["left"].shape[0]
            if n < args.batch:
                reps = args.batch - n
                b = {
                    k: np.concatenate([v] + [v[-1:]] * reps, axis=0)
                    for k, v in b.items()
                }
            yield b

    pending = []  # [batch, 3] device tensors of (epe, bad3, d1), fetched after the loop
    frame_idx = 0
    t0 = time.perf_counter()
    for batch in prefetch_to_device(batches(), size=2, device=device):
        disp, metrics = step(batch["left"], batch["right"], batch["target"])
        pending.append(metrics)
        if args.logDispStep != -1:
            # fetching disparities syncs; only pay it at the dump stride
            for j in range(args.batch):
                fi = frame_idx + j
                if fi < n_frames and fi % args.logDispStep == 0:
                    save_disparity_png(
                        os.path.join(args.output, "disparities", f"disparity_{fi}.png"),
                        disp[j].cpu().numpy(),
                        MAX_DISP,
                    )
        frame_idx += args.batch
    # drain: one host fetch of every frame's metrics fences everything
    fetched = torch.cat(pending).cpu().numpy().astype(np.float64)[:n_frames]
    exec_time = time.perf_counter() - t0
    epe, bad3, d1 = fetched[:, 0], fetched[:, 1], fetched[:, 2]

    from real_time_self_adaptive_deep_stereo_torch.adapt.runner import SessionStats
    from real_time_self_adaptive_deep_stereo_torch.cli.adapt import write_stats

    stats = SessionStats(
        epe=list(epe),
        bad3=list(bad3),
        d1=list(d1),
        steps=n_frames,
        exec_time=exec_time,
    )
    write_stats(args.output, stats)
    print(
        f"{n_frames} frames in {exec_time:.2f}s -> {stats.fps:.4g} FPS "
        f"(batch {args.batch}, {args.precision})  "
        f"avg EPE {epe.mean():.3f}  bad3 {bad3.mean():.3f}  D1 {d1.mean():.2f}"
    )
    print(f"Result saved in {args.output}")
    return {
        "fps": stats.fps,
        "avg_epe": float(epe.mean()),
        "avg_bad3": float(bad3.mean()),
        "avg_d1": float(d1.mean()),
    }


def cli() -> None:
    args = build_argparser().parse_args()
    os.makedirs(args.output, exist_ok=True)
    with open(os.path.join(args.output, "params.sh"), "w") as f:
        argv = list(sys.argv)
        argv[0] = os.path.join(os.getcwd(), argv[0])
        f.write("#!/bin/bash\npython3 " + " ".join(argv) + "\n")
    main(args)


if __name__ == "__main__":
    cli()
