"""Continual adaptation CLI — port of the JAX package's
``cli/adapt_continual.py``, itself the counterpart of reference
``Stereo_Continual_Adaptation.py`` (TPAMI 2021): adaptation against
precomputed *proxy* disparity labels (the list's 4th column) instead of
the photometric loss, the KITTI D1 metric, the ``--dilation`` training
stride, the tunable reward ``--decay``/``--uf``, and the overall.csv /
series.csv / histogram.csv outputs, on the port's engine and sessions.

Run:  python -m real_time_self_adaptive_deep_stereo_torch.cli.adapt_continual \\
        -l list.csv -o out/ --weights w.npz --modelName MADNet \\
        --blockConfig block_config/MadNet_full.json --mode MAD

Weights are a JAX-layout ``.npz`` or a reference TF1 checkpoint
(``utils/checkpoint.py``); a ``weights-N.npz`` in the output folder is
resumed first. It runs on the GPU; ``main(args, device="cpu")`` runs the
plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

import numpy as np

MAX_DISP = 256  # clip for serialized disparities (reference static param)


def build_argparser() -> argparse.ArgumentParser:
    from real_time_self_adaptive_deep_stereo_torch.adapt.samplers import AVAILABLE_SAMPLER
    from real_time_self_adaptive_deep_stereo_torch.models import STEREO_FACTORY

    p = argparse.ArgumentParser(
        description="Continual adaptation of a deep stereo network (PyTorch/CUDA)"
    )
    p.add_argument("-l", "--list", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--weights", required=True)
    p.add_argument("--modelName", default="MADNet", choices=list(STEREO_FACTORY))
    p.add_argument("--numBlocks", type=int, default=1)
    p.add_argument("--lr", type=float, default=0.0001)
    p.add_argument("--blockConfig", required=True)
    p.add_argument("--sampleMode", default="PROBABILITY", choices=AVAILABLE_SAMPLER)
    p.add_argument("--fixedID", type=int, nargs="+", default=[0])
    p.add_argument("--reprojectionScale", type=int, default=1)
    p.add_argument("--summary", action="store_true")
    p.add_argument("--imageShape", type=int, nargs="+", default=[320, 1216])
    p.add_argument("--SSIMTh", type=float, default=0.5)
    p.add_argument("--sampleFrequency", type=int, default=1)
    p.add_argument("--mode", default="MAD", choices=["NONE", "FULL", "MAD"])
    p.add_argument("--logDispStep", type=int, default=-1)
    p.add_argument("--saveWeights", action="store_true")
    p.add_argument("--dilation", type=int, default=1)
    p.add_argument("--decay", type=float, default=0.99)
    p.add_argument("--uf", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument(
        "--corrMode",
        default="auto",
        choices=["auto", "cuda", "torch"],
        help="correlation: the CUDA kernels, the plain PyTorch version, or "
        "auto (the kernels on the GPU)",
    )
    p.add_argument(
        "--sessionMode", default="auto", choices=["auto", "fused", "host"]
    )
    return p


def main(args, device=None) -> dict:
    """Run the continual adaptation of ``args`` (``build_argparser``) on
    ``device``: ``cuda`` unless ``device="cpu"``; raises where no GPU is
    available."""
    from real_time_self_adaptive_deep_stereo_torch.adapt import (
        AdaptationEngine,
        load_block_config,
        make_blocks,
    )
    from real_time_self_adaptive_deep_stereo_torch.cli.adapt import load_model
    from real_time_self_adaptive_deep_stereo_torch.data import StereoDataset
    from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import save_step_checkpoint
    from real_time_self_adaptive_deep_stereo_torch.utils.device import resolve_device

    device = resolve_device(device)
    os.makedirs(args.output, exist_ok=True)
    if args.logDispStep != -1:
        os.makedirs(os.path.join(args.output, "disparities"), exist_ok=True)

    dataset = StereoDataset(
        args.list,
        batch_size=1,
        crop_shape=args.imageShape,
        num_epochs=1,
        augment=False,
        is_training=False,
        shuffle=False,
        load_proxy=True,
    )
    print(f"Decoding frames with {dataset.decoding()}", flush=True)

    model_kwargs = {"seed": args.seed or 0}
    if args.modelName == "MADNet":
        model_kwargs["bulkhead"] = args.mode == "MAD"
    model = load_model(args, device, **model_kwargs)

    blocks = make_blocks(load_block_config(args.blockConfig), model)
    engine = AdaptationEngine(
        model,
        blocks,
        lr=args.lr,
        optimizer="momentum",
        adaptation="proxy",
        reprojection_scale=args.reprojectionScale,
        device=device,
    )
    session_mode = args.sessionMode
    if session_mode == "auto":
        session_mode = "host" if (args.summary or args.logDispStep != -1) else "fused"

    hist_path = os.path.join(args.output, "histogram.csv")
    with open(hist_path, "w") as f:
        f.write("Histogram\n")

    if session_mode == "fused":
        stats, params = _run_fused(args, engine, dataset)
        with open(hist_path, "a") as f:
            f.write(f"{stats.fetch_counter}\n")
    else:
        stats, params = _run_host(args, engine, dataset, hist_path)
    with open(os.path.join(args.output, "overall.csv"), "w") as f:
        f.write("EPE\tD1\n")
        f.write(f"{np.mean(stats.epe):.3f}\t{np.mean(stats.d1):.3f}\n")
    with open(os.path.join(args.output, "series.csv"), "w") as f:
        f.write("step\tEPE\tD1\n")
        for i, (a, b) in enumerate(zip(stats.epe, stats.d1)):
            f.write(f"{i} & {a:.3f} & {b:.3f}\n")
    if args.saveWeights:
        path = save_step_checkpoint(os.path.join(args.output, "weights"), params, stats.steps)
        print(f"Checkpoint saved in {path}")
    print(f"Result saved in {args.output}")
    return {
        "avg_epe": float(np.mean(stats.epe)) if stats.epe else float("nan"),
        "avg_d1": float(np.mean(stats.d1)) if stats.d1 else float("nan"),
        "fps": stats.fps,
        "resets": stats.reset_counter,
    }


def _run_fused(args, engine, dataset):
    """Controller on the device: one graph replay per frame, stats at the
    end. Returns (stats, the adapted ``state_dict``)."""
    from real_time_self_adaptive_deep_stereo_torch.adapt.fused import FusedOnlineSession
    from real_time_self_adaptive_deep_stereo_torch.cli.adapt import fused_fixed_blocks, fused_stats
    from real_time_self_adaptive_deep_stereo_torch.data import prefetch_to_device

    fixed_id, num_blocks = fused_fixed_blocks(args)
    session = FusedOnlineSession(
        engine,
        mode=args.mode,
        sample_mode=args.sampleMode,
        num_blocks=num_blocks,
        fixed_id=fixed_id,
        sample_frequency=args.sampleFrequency,
        ssim_th=args.SSIMTh,
        decay=args.decay,
        uf=args.uf,
        dilation=args.dilation,
        max_steps=dataset.get_max_steps() + 8,
        seed=args.seed or 0,
    )
    t0 = time.perf_counter()
    for frame in prefetch_to_device(iter(dataset), size=2, device=engine.device):
        session.step(frame)
    session.block_until_ready()
    stats = fused_stats(session.finalize(), time.perf_counter() - t0)
    return stats, session.current_params()


def _run_host(args, engine, dataset, hist_path):
    """Reference-style host loop with per-frame logging and PNG dumps
    (``--summary`` only picks this session, as in the JAX CLI). Returns
    (stats, the adapted ``state_dict``)."""
    from real_time_self_adaptive_deep_stereo_torch.adapt import OnlineAdaptationSession
    from real_time_self_adaptive_deep_stereo_torch.data import prefetch_to_device
    from real_time_self_adaptive_deep_stereo_torch.utils.visual import save_disparity_png

    session = OnlineAdaptationSession(
        engine,
        mode=args.mode,
        sample_mode=args.sampleMode,
        num_blocks=args.numBlocks,
        fixed_id=args.fixedID if len(args.fixedID) > 1 else args.fixedID[0],
        sample_frequency=args.sampleFrequency,
        ssim_th=args.SSIMTh,
        decay=args.decay,
        uf=args.uf,
        dilation=args.dilation,
        seed=args.seed,
    )
    frames = prefetch_to_device(iter(dataset), size=2, device=engine.device)
    for step, frame in enumerate(frames):
        out = session.step(frame)
        if step % 100 == 0:
            with open(hist_path, "a") as f:
                f.write(f"{session.stats.fetch_counter}\n")
            print(f"Step: {step:04d} \tEPE:{out['epe']:.3f}\tD1:{out['d1']:.3f}")
        if args.logDispStep != -1 and step % args.logDispStep == 0:
            save_disparity_png(
                os.path.join(args.output, "disparities", f"disparity_{step}.png"),
                out["disp"][0].float().cpu().numpy(),
                MAX_DISP,
            )
    return session.stats, engine.model.state_dict()


def cli() -> None:
    args = build_argparser().parse_args()
    os.makedirs(args.output, exist_ok=True)
    shutil.copy(args.blockConfig, os.path.join(args.output, "config.json"))
    with open(os.path.join(args.output, "params.sh"), "w") as f:
        argv = list(sys.argv)
        argv[0] = os.path.join(os.getcwd(), argv[0])
        f.write("#!/bin/bash\npython3 " + " ".join(argv) + "\n")
    main(args)


if __name__ == "__main__":
    cli()
