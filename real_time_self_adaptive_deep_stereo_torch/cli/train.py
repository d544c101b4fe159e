"""Offline supervised training CLI — port of the JAX package's
``cli/train.py``, itself the counterpart of reference ``Train.py``:
multi-scale supervised loss (max_disp 192), Adam, checkpoints every
``--ckptEvery`` steps (two kept), resume-from-output, an optional
validation set with EPE/bad3.

Run:  python -m real_time_self_adaptive_deep_stereo_torch.cli.train \\
        --trainingSet list.csv -o out/ --modelName MADNet --batchSize 4 --augment

``--weights`` takes a JAX-layout ``.npz`` or a reference TF1 checkpoint
(``utils/checkpoint.py``); a ``weights-N.npz`` in ``--output`` is resumed
first, from step N. It runs on the GPU; ``main(args, device="cpu")`` runs
the plain PyTorch versions on the CPU.

``--dataParallel`` trains on several GPUs, one process (rank) a GPU:

    torchrun --standalone --nproc-per-node N \
        -m real_time_self_adaptive_deep_stereo_torch.cli.train --dataParallel ...

``cli()`` then joins an NCCL group from torchrun's environment and runs
rank r on ``cuda:LOCAL_RANK``; it raises where the ranks outnumber the
GPUs. Every rank draws the same shuffled sequence of global batches of
``--batchSize``, decodes only its contiguous slice of each
(``StereoDataset(shard=...)``) and trains on it with
``parallel.make_dp_train_step``, whose loss and Adam update are those of
one process on the whole batch; rank 0 alone writes checkpoints and logs
and runs the validation. ``main(args, device)`` takes that path wherever
a group of more than one rank is already initialized (a caller's own
``gloo`` group, on the CPU or sharing one GPU). With one rank
``--dataParallel`` takes the single-device step, as the JAX CLI does on
one device.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import time


MAX_DISP = 192  # supervised clip (reference static param, Train.py:20)


def build_argparser() -> argparse.ArgumentParser:
    from real_time_self_adaptive_deep_stereo_torch.losses import SUPERVISED_LOSS
    from real_time_self_adaptive_deep_stereo_torch.models import STEREO_FACTORY

    p = argparse.ArgumentParser(
        description="Offline training of a deep stereo network (PyTorch/CUDA)"
    )
    p.add_argument("--trainingSet", required=True)
    p.add_argument("--validationSet", default=None)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--weights", default=None, help="optional initial weights")
    p.add_argument("--modelName", default="MADNet", choices=list(STEREO_FACTORY))
    p.add_argument("--lr", type=float, default=0.0001)
    p.add_argument("--imageShape", type=int, nargs="+", default=[320, 1216])
    p.add_argument("--batchSize", type=int, default=4)
    p.add_argument("--numEpochs", type=int, default=50)
    p.add_argument("--augment", action="store_true")
    p.add_argument("--lossWeights", type=float, nargs="+", default=None)
    p.add_argument("--lossType", default="mean_l1", choices=list(SUPERVISED_LOSS))
    p.add_argument(
        "--decayStep",
        type=int,
        default=500000,
        help="reference-compat NO-OP: the reference computes a decayed lr "
        "from this but feeds Adam the raw --lr anyway (Train.py:94-95); "
        "kept so reference command lines parse, warns when set",
    )
    p.add_argument("--ckptEvery", type=int, default=10000)
    p.add_argument("--dataParallel", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--corrMode",
        default="auto",
        choices=["auto", "cuda", "torch"],
        help="correlation: the CUDA kernels, the plain PyTorch version, or "
        "auto (the kernels on the GPU)",
    )
    p.add_argument("--maxSteps", type=int, default=None, help="early stop (for smoke runs)")
    return p


def loss_and_grads(model, loss_fn, batch):
    """One training step's supervised loss of ``batch`` (NHWC ``left``,
    ``right``, ``target`` on the model's device) and its gradient with
    respect to every parameter, in ``named_parameters`` order."""
    import torch

    params = [p for _, p in model.named_parameters()]
    out = model(batch["left"], batch["right"])
    loss = loss_fn(out["disparities"], batch)
    return loss.detach(), torch.autograd.grad(loss, params)


def make_train_step(model, loss_fn, lr: float, reduce=None):
    """``step(batch) -> loss``: :func:`loss_and_grads`, then one TF-form
    Adam update of every parameter in place (``utils/optim.py``), with the
    optimizer state the returned function keeps as ``step.opt``. The loss
    stays on the device. ``reduce(loss, grads) -> (loss, grads)``, where
    given, runs between the two (the data-parallel step's all-reduce);
    ``step.grads`` is the gradient the last update took."""
    from real_time_self_adaptive_deep_stereo_torch.utils import optim

    weights = [p for _, p in model.named_parameters()]
    opt = optim.adam_init(weights)

    def step(batch):
        loss, grads = loss_and_grads(model, loss_fn, batch)
        if reduce is not None:
            loss, grads = reduce(loss, grads)
        step.grads = grads
        opt["t"] += 1
        optim.adam_update(weights, opt["m"], opt["v"], grads, lr, opt["t"])
        return loss

    step.opt = opt
    return step


def main(args, device=None) -> dict:
    """Train as ``args`` (``build_argparser``) say on ``device``: ``cuda``
    unless ``device="cpu"``; raises where no GPU is available. Where a
    process group of several ranks is initialized, this rank's part of the
    data-parallel run (``--dataParallel``). Returns the loss of every step
    (``losses``), the last logged one and the step count."""
    import torch
    import torch.distributed as dist

    dp = dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
    if dp and not args.dataParallel:
        raise ValueError(
            f"a process group of {dist.get_world_size()} ranks is initialized: pass "
            "--dataParallel, or run one process"
        )
    main_rank = not dp or dist.get_rank() == 0
    log = print if main_rank else (lambda *a, **k: None)

    if getattr(args, "decayStep", 500000) != 500000:
        log(
            "WARNING: --decayStep has no effect — matching the reference, "
            "which computes the decayed lr but passes the raw --lr to Adam "
            "(Train.py:94-95)."
        )

    from real_time_self_adaptive_deep_stereo_torch.adapt.engine import disparity_metrics
    from real_time_self_adaptive_deep_stereo_torch.data import StereoDataset, prefetch_to_device
    from real_time_self_adaptive_deep_stereo_torch.losses import get_supervised_loss
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import (
        params_from_jax,
        params_to_jax,
        restore_or_init,
        save_step_checkpoint,
    )
    from real_time_self_adaptive_deep_stereo_torch.utils.device import resolve_device

    device = resolve_device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)  # the kernels launch on the current device
    if args.dataParallel and not dp and device.type == "cuda" and torch.cuda.device_count() > 1:
        log(
            f"--dataParallel in one process trains on {device} alone; torchrun "
            "--nproc-per-node N starts one rank a GPU"
        )
    os.makedirs(args.output, exist_ok=True)

    train_set = StereoDataset(
        args.trainingSet,
        batch_size=args.batchSize,
        crop_shape=args.imageShape,
        num_epochs=args.numEpochs,
        augment=args.augment,
        is_training=True,
        shuffle=True,
        seed=args.seed,
        # rank r decodes only its slice of each global batch
        shard=(dist.get_rank(), dist.get_world_size()) if dp else None,
    )
    log(f"Decoding frames with {train_set.decoding()}", flush=True)
    val_set = (
        StereoDataset(
            args.validationSet,
            batch_size=args.batchSize,
            crop_shape=args.imageShape,
            num_epochs=None,
            augment=False,
            is_training=False,
            shuffle=True,
            seed=args.seed,
        )
        if args.validationSet and main_rank
        else None
    )

    model = get_stereo_net(args.modelName, corr_mode=args.corrMode, device=device, seed=args.seed)
    params, restored, start_step = restore_or_init(
        args.output, params_to_jax(model.state_dict()), args.weights, model
    )
    model.load_state_dict(params_from_jax(params))
    log(f"Restored?: {restored} from step {start_step}")

    if dp:
        from real_time_self_adaptive_deep_stereo_torch.parallel import make_dp_train_step, make_mesh

        mesh = make_mesh(device_type=device.type)
        train_step = make_dp_train_step(
            model,
            mesh,
            lr=args.lr,
            loss_name=args.lossType,
            max_disp=MAX_DISP,
            loss_weights=args.lossWeights,
        )
        log(f"Data-parallel over {mesh.size()} ranks ({dist.get_backend()})")
    else:
        loss_fn = get_supervised_loss(
            args.lossType, multiScale=True, weights=args.lossWeights, max_disp=MAX_DISP
        )
        train_step = make_train_step(model, loss_fn, args.lr)

    @torch.no_grad()
    def val_step(batch):
        out = model(batch["left"], batch["right"])
        return disparity_metrics(out["full_res_disp"], batch["target"])

    max_steps = train_set.get_max_steps()
    step = start_step
    start = time.perf_counter()
    last_loss = float("nan")
    losses, pending = [], []  # read at the logging syncs
    val_iter = iter(prefetch_to_device(iter(val_set), 1, device=device)) if val_set else None

    for batch in prefetch_to_device(iter(train_set), size=2, device=device):
        loss = train_step(batch)
        pending.append(loss)
        if step % 100 == 0:
            losses += torch.stack(pending).tolist()
            pending = []
            last_loss = losses[-1]
            dt = time.perf_counter() - start
            eta = datetime.timedelta(seconds=int((max_steps - step) * dt / 100))
            msg = f"Step:{step:6d}\tLoss:{last_loss:.3f}\tf/b time:{dt / 100:.3f}\tMissing time:{eta}"
            if val_iter is not None:
                try:
                    epe, bad3 = val_step(next(val_iter))
                    msg += f"\tval EPE:{float(epe):.2f} bad3:{float(bad3):.3f}"
                except StopIteration:
                    val_iter = None
            log(msg)
            start = time.perf_counter()
        if step % args.ckptEvery == 0 and step > start_step and main_rank:
            save_step_checkpoint(args.output, model.state_dict(), step)
        step += 1
        if args.maxSteps is not None and step - start_step >= args.maxSteps:
            break

    if pending:
        losses += torch.stack(pending).tolist()
    if main_rank:
        save_step_checkpoint(args.output, model.state_dict(), step)
    log("All Done")
    return {"final_loss": last_loss, "steps": step, "losses": losses}


def cli() -> None:
    """The command line. Under ``torchrun`` (``WORLD_SIZE`` > 1) with
    ``--dataParallel``: one rank a GPU, an NCCL group from torchrun's
    environment, rank r on ``cuda:LOCAL_RANK``."""
    args = build_argparser().parse_args()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if int(os.environ.get("RANK", "0")) == 0:
        os.makedirs(args.output, exist_ok=True)
        with open(os.path.join(args.output, "params.sh"), "w") as f:
            argv = list(sys.argv)
            argv[0] = os.path.join(os.getcwd(), argv[0])
            f.write("#!/bin/bash\npython3 " + " ".join(argv) + "\n")
    if world == 1:
        main(args)
        return
    import torch
    import torch.distributed as dist

    if not args.dataParallel:
        raise ValueError(f"{world} ranks were started: pass --dataParallel, or start one process")
    local_rank = int(os.environ["LOCAL_RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local_world > gpus:
        raise RuntimeError(
            f"--dataParallel runs one rank a GPU (NCCL), but {local_world} ranks were started on a "
            f"machine with {gpus} GPU(s): start at most {gpus} (torchrun --nproc-per-node {gpus})"
        )
    torch.cuda.set_device(local_rank)
    dist.init_process_group("nccl")
    try:
        main(args, device=f"cuda:{local_rank}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    cli()
