"""Online adaptation CLI — port of the JAX package's ``cli/adapt.py``,
itself the counterpart of reference ``Stereo_Online_Adaptation.py``
(same flags, same output artifacts: stats.csv / series.csv / params.sh /
config.json / 16-bit disparity PNGs), on the port's engine and sessions.

Run:  python -m real_time_self_adaptive_deep_stereo_torch.cli.adapt \\
        -l list.csv -o out/ --weights w.npz --modelName MADNet \\
        --blockConfig block_config/MadNet_full.json --mode MAD

Weights are a JAX-layout ``.npz`` (``utils/checkpoint.py``); a
``weights-N.npz`` in the output folder is resumed first. It runs on the
GPU; ``main(args, device="cpu")`` runs the plain PyTorch versions on the
CPU. ``--summary`` writes the JAX CLI's TensorBoard events (scalars
``EPE`` and ``bad3``, jet-coloured images ``full_res_disp`` and
``gt_disp``) through TensorFlow, imported only then; without TensorFlow it
prints the JAX CLI's line and goes on.
"""

from __future__ import annotations

import argparse
import datetime
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
        description="Online adaptation of a deep stereo network (PyTorch/CUDA)"
    )
    p.add_argument("-l", "--list", required=True, help="frame list file")
    p.add_argument("-o", "--output", required=True, help="output folder")
    p.add_argument("--weights", required=True, help="initial weights (.npz, JAX layout)")
    p.add_argument("--modelName", default="MADNet", choices=list(STEREO_FACTORY))
    p.add_argument("--numBlocks", type=int, default=1)
    p.add_argument("--lr", type=float, default=0.0001)
    p.add_argument("--blockConfig", required=True, help="block config json")
    p.add_argument("--sampleMode", default="PROBABILITY", choices=AVAILABLE_SAMPLER)
    p.add_argument("--fixedID", type=int, nargs="+", default=[0])
    p.add_argument("--reprojectionScale", type=int, default=1)
    p.add_argument("--summary", action="store_true")
    p.add_argument("--imageShape", type=int, nargs="+", default=[320, 1216])
    p.add_argument("--SSIMTh", type=float, default=0.5)
    p.add_argument("--sampleFrequency", type=int, default=1)
    p.add_argument("--mode", default="MAD", choices=["NONE", "FULL", "MAD"])
    p.add_argument("--logDispStep", type=int, default=-1)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument(
        "--corrMode",
        default="auto",
        choices=["auto", "cuda", "torch"],
        help="correlation: the CUDA kernels, the plain PyTorch version, or "
        "auto (the kernels on the GPU)",
    )
    p.add_argument(
        "--sessionMode",
        default="auto",
        choices=["auto", "fused", "host"],
        help="fused = controller on the device, one CUDA graph replay per "
        "frame (fastest; console progress logs unavailable, but PNG dumps "
        "are still emitted at their stride); host = reference-style loop "
        "with per-frame logging. auto picks fused unless per-frame "
        "artifacts were requested.",
    )
    p.add_argument(
        "--chunk",
        type=int,
        default=1,
        help="fused sessions only: dispatch K frames per call "
        "(step_chunk) — identical adaptation trajectory, K-1 frames of "
        "extra latency. Ignored when per-frame artifacts are requested.",
    )
    return p


def load_model(args, device, **model_kwargs):
    """The model of ``args.modelName`` on ``device`` with the weights of
    ``--weights``, or of the newest ``weights-N.npz`` in ``--output``
    (``restore_or_init``); exits if there are none."""
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import (
        params_from_jax,
        params_to_jax,
        restore_or_init,
    )

    model = get_stereo_net(
        args.modelName, corr_mode=args.corrMode, device=device, **model_kwargs
    )
    params, restored, _ = restore_or_init(
        args.output, params_to_jax(model.state_dict()), args.weights, model
    )
    if not restored:
        raise SystemExit(f"could not restore weights from {args.weights}")
    model.load_state_dict(params_from_jax(params))
    print(f"Restored weights from {args.weights}")
    return model


def main(args, device=None) -> dict:
    """Run the adaptation of ``args`` (``build_argparser``) on ``device``:
    ``cuda`` unless ``device="cpu"``; raises where no GPU is available."""
    from real_time_self_adaptive_deep_stereo_torch.adapt import (
        AdaptationEngine,
        load_block_config,
        make_blocks,
    )
    from real_time_self_adaptive_deep_stereo_torch.data import StereoDataset
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
    )
    print(f"Decoding frames with {dataset.decoding()}", flush=True)

    model_kwargs = {"seed": args.seed or 0}
    if args.modelName == "MADNet":
        model_kwargs["bulkhead"] = args.mode == "MAD"
    model = load_model(args, device, **model_kwargs)

    groups = load_block_config(args.blockConfig)
    blocks = make_blocks(groups, model)
    if args.mode == "MAD":
        n_preds = model.num_adaptable_predictions
        assert len(blocks) == n_preds, (
            f"block config has {len(blocks)} groups but the model exposes "
            f"{n_preds} adaptable predictions"
        )

    engine = AdaptationEngine(
        model,
        blocks,
        lr=args.lr,
        optimizer="momentum",
        adaptation="reprojection",
        reprojection_scale=args.reprojectionScale,
        device=device,
    )

    session_mode = args.sessionMode
    if session_mode == "auto":
        per_frame_artifacts = args.summary or args.logDispStep != -1
        session_mode = "host" if per_frame_artifacts else "fused"

    max_steps = dataset.get_max_steps()
    if session_mode == "fused":
        return _run_fused(args, engine, dataset, max_steps)
    return _run_host(args, engine, dataset, max_steps)


def _result(stats) -> dict:
    return {
        "fps": stats.fps,
        "avg_epe": float(np.mean(stats.epe)) if stats.epe else float("nan"),
        "avg_bad3": float(np.mean(stats.bad3)) if stats.bad3 else float("nan"),
        "avg_d1": float(np.mean(stats.d1)) if stats.d1 else float("nan"),
        "resets": stats.reset_counter,
    }


def fused_fixed_blocks(args):
    """``(fixed_id, num_blocks)`` for a fused session. FIXED trains exactly
    the listed blocks (host/reference semantics, Sampler/sampler_factory.py:
    23-37 — the sampler ignores its nominal count); the fused session's
    static shapes require num_blocks == len(fixedID), so it is derived here."""
    fixed_ids = list(np.atleast_1d(args.fixedID))
    num_blocks = args.numBlocks
    if args.sampleMode == "FIXED" and args.mode == "MAD":
        if num_blocks != len(fixed_ids):
            print(
                f"# FIXED: training the {len(fixed_ids)} listed block(s) "
                f"{fixed_ids}; --numBlocks {num_blocks} ignored",
                flush=True,
            )
        num_blocks = len(fixed_ids)
    return (fixed_ids if len(fixed_ids) > 1 else fixed_ids[0]), num_blocks


def fused_stats(host, exec_time: float):
    """The host session's ``SessionStats`` of a fused session's
    ``finalize()``."""
    from real_time_self_adaptive_deep_stereo_torch.adapt.runner import SessionStats

    return SessionStats(
        epe=list(host["epe"]),
        bad3=list(host["bad3"]),
        d1=list(host["d1"]),
        loss=list(host["loss"]),
        fetch_counter=[int(c) for c in host["fetch_counter"]],
        sample_distribution=np.asarray(host["scores"], np.float64),
        reset_counter=int(host["reset_count"]),
        steps=host["steps"],
        exec_time=exec_time,
    )


def _run_fused(args, engine, dataset, max_steps):
    """Controller on the device: one graph replay per frame, stats at the end."""
    import torch

    from real_time_self_adaptive_deep_stereo_torch.adapt.fused import FusedOnlineSession
    from real_time_self_adaptive_deep_stereo_torch.data import prefetch_to_device
    from real_time_self_adaptive_deep_stereo_torch.utils.visual import save_disparity_png

    fixed_id, num_blocks = fused_fixed_blocks(args)
    session = FusedOnlineSession(
        engine,
        mode=args.mode,
        sample_mode=args.sampleMode,
        num_blocks=num_blocks,
        fixed_id=fixed_id,
        sample_frequency=args.sampleFrequency,
        ssim_th=args.SSIMTh,
        max_steps=max_steps + 8,
        seed=args.seed or 0,
    )
    writer = _make_summary_writer(args.output) if args.summary else None

    chunk = getattr(args, "chunk", 1)
    if chunk > 1 and (args.logDispStep != -1 or args.summary):
        print("# --chunk ignored: per-frame artifacts requested", flush=True)
        chunk = 1

    frames = prefetch_to_device(iter(dataset), size=chunk + 1, device=engine.device)
    t0 = time.perf_counter()
    steps = 0
    if chunk > 1:
        buf = []
        for frame in frames:
            buf.append(frame)
            if len(buf) == chunk:
                session.step_chunk({k: torch.stack([f[k] for f in buf]) for k in buf[0]})
                buf = []
            steps += 1
        for frame in buf:  # tail shorter than K: per-frame dispatch
            session.step(frame)
    else:
        for frame in frames:
            session.step(frame)
            # per-stride artifacts: fetching last_disp syncs, so it happens
            # only every logDispStep frames (reference cadence,
            # Stereo_Online_Adaptation.py:246-251)
            if args.logDispStep != -1 and steps % args.logDispStep == 0:
                save_disparity_png(
                    os.path.join(args.output, "disparities", f"disparity_{steps}.png"),
                    session.fetch_disp()()[0],
                    MAX_DISP,
                )
            if writer is not None and steps % 100 == 0:
                _write_image_summaries(
                    writer, steps, session.fetch_disp()()[0], frame["target"][0].cpu().numpy()
                )
            steps += 1
    session.block_until_ready()
    exec_time = time.perf_counter() - t0
    host = session.finalize()
    stats = fused_stats(host, exec_time)

    if writer is not None:
        # the session keeps per-frame metrics: the whole scalar series at
        # the end, as the JAX CLI writes it
        import tensorflow as tf

        with writer.as_default():
            for i in range(host["steps"]):
                tf.summary.scalar("EPE", host["epe"][i], step=i)
                tf.summary.scalar("bad3", host["bad3"][i], step=i)
        writer.flush()

    write_stats(args.output, stats)
    print(f"Result saved in {args.output}")
    return _result(stats)


def _run_host(args, engine, dataset, max_steps):
    """Reference-style host loop with per-frame logging / PNG dumps."""
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
        seed=args.seed,
    )
    writer = _make_summary_writer(args.output) if args.summary else None

    start = time.perf_counter()
    frames = prefetch_to_device(iter(dataset), size=2, device=engine.device)
    for step, frame in enumerate(frames):
        out = session.step(frame)

        if step % 100 == 0:
            elapsed = time.perf_counter() - start
            per = elapsed / max(step, 1)
            eta = datetime.timedelta(seconds=int((max_steps - step) * per))
            print(
                f"Step:{step:4d}\tbad3:{out['bad3']:.2f}\tEPE:{out['epe']:.2f}"
                f"\tSSIM:{out['loss']:.2f}\tf/b time:{per:.3f}\tMissing time:{eta}"
            )
            if writer is not None:
                import tensorflow as tf

                with writer.as_default():
                    tf.summary.scalar("EPE", out["epe"], step=step)
                    tf.summary.scalar("bad3", out["bad3"], step=step)
                _write_image_summaries(
                    writer,
                    step,
                    out["disp"][0].float().cpu().numpy(),
                    frame["target"][0].cpu().numpy(),
                )

        if args.logDispStep != -1 and step % args.logDispStep == 0:
            save_disparity_png(
                os.path.join(args.output, "disparities", f"disparity_{step}.png"),
                out["disp"][0].float().cpu().numpy(),
                MAX_DISP,
            )

    stats = session.stats
    write_stats(args.output, stats)
    print(f"Result saved in {args.output}")
    return _result(stats)


def _make_summary_writer(output: str):
    """A TensorBoard event writer in ``output``, or None with the JAX CLI's
    own line where TensorFlow is absent."""
    try:
        import tensorflow as tf
    except ImportError:
        print("tensorboard summaries unavailable (no tensorflow)")
        return None
    return tf.summary.create_file_writer(output)


def _write_image_summaries(writer, step: int, disp: np.ndarray, gt: np.ndarray) -> None:
    """Colorized full_res_disp / gt_disp TB images, matching reference
    Stereo_Online_Adaptation.py:135-136 (preprocessing.colorize_img,
    cmap='jet', max_outputs=1)."""
    import tensorflow as tf

    from real_time_self_adaptive_deep_stereo_torch.utils.visual import colorize_disparity

    with writer.as_default():
        for name, d in (("full_res_disp", disp), ("gt_disp", gt)):
            tf.summary.image(
                name, colorize_disparity(d, cmap="jet")[None].astype(np.float32), step=step, max_outputs=1
            )


def write_stats(output: str, stats) -> None:
    """stats.csv / series.csv in the reference's format
    (Stereo_Online_Adaptation.py:262-288)."""
    steps = max(stats.steps, 1)
    epe_sum = float(np.sum(stats.epe))
    bad3_sum = float(np.sum(stats.bad3))
    with open(os.path.join(output, "stats.csv"), "w") as f:
        f.write("Metrics,cumulative,average\n")
        f.write(f"EPE,{epe_sum},{epe_sum / steps}\n")
        f.write(f"bad3,{bad3_sum},{bad3_sum / steps}\n")
        f.write(f"time,{stats.exec_time},{stats.exec_time / steps}\n")
        f.write(f"FPS,{stats.fps}\n")
        f.write(f"#resets,{stats.reset_counter}\n")
        f.write("Blocks")
        for n in range(len(stats.fetch_counter)):
            f.write(f",{n}")
        f.write(",final\n")
        f.write("fetch_counter")
        for c in stats.fetch_counter:
            f.write(f",{c}")
        f.write("\n")
        if stats.sample_distribution is not None:
            for c in stats.sample_distribution:
                f.write(f",{c}")
            f.write("\n")

    step_time = stats.exec_time / steps
    with open(os.path.join(output, "series.csv"), "w") as f:
        f.write("Iteration,Time,EPE,bad3\n")
        for i, (e, b) in enumerate(zip(stats.epe, stats.bad3)):
            f.write(f"{i},{i * step_time},{e},{b}\n")


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
