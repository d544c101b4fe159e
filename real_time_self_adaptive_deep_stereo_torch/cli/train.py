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
the plain PyTorch versions on the CPU. ``--dataParallel`` on one device
takes the single-device step, as the JAX CLI does; over several GPUs it
is not ported (``ROADMAP.md``, queue 1, ``parallel/``).
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


def make_train_step(model, loss_fn, lr: float):
    """``step(batch) -> loss``: :func:`loss_and_grads`, then one TF-form
    Adam update of every parameter in place (``utils/optim.py``), with the
    optimizer state the returned function keeps. The loss stays on the
    device."""
    from real_time_self_adaptive_deep_stereo_torch.utils import optim

    weights = [p for _, p in model.named_parameters()]
    opt = optim.adam_init(weights)

    def step(batch):
        loss, grads = loss_and_grads(model, loss_fn, batch)
        opt["t"] += 1
        optim.adam_update(weights, opt["m"], opt["v"], grads, lr, opt["t"])
        return loss

    return step


def main(args, device=None) -> dict:
    """Train as ``args`` (``build_argparser``) say on ``device``: ``cuda``
    unless ``device="cpu"``; raises where no GPU is available."""
    import torch

    if getattr(args, "decayStep", 500000) != 500000:
        print(
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
    if args.dataParallel and device.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            "--dataParallel over several GPUs is not ported: ROADMAP.md, queue 1, `parallel/`"
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
    )
    print(f"Decoding frames with {train_set.decoding()}", flush=True)
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
        if args.validationSet
        else None
    )

    model = get_stereo_net(args.modelName, corr_mode=args.corrMode, device=device, seed=args.seed)
    params, restored, start_step = restore_or_init(
        args.output, params_to_jax(model.state_dict()), args.weights, model
    )
    model.load_state_dict(params_from_jax(params))
    print(f"Restored?: {restored} from step {start_step}")

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
    val_iter = iter(prefetch_to_device(iter(val_set), 1, device=device)) if val_set else None

    for batch in prefetch_to_device(iter(train_set), size=2, device=device):
        loss = train_step(batch)
        if step % 100 == 0:
            last_loss = float(loss)
            dt = time.perf_counter() - start
            eta = datetime.timedelta(seconds=int((max_steps - step) * dt / 100))
            msg = f"Step:{step:6d}\tLoss:{last_loss:.3f}\tf/b time:{dt / 100:.3f}\tMissing time:{eta}"
            if val_iter is not None:
                try:
                    epe, bad3 = val_step(next(val_iter))
                    msg += f"\tval EPE:{float(epe):.2f} bad3:{float(bad3):.3f}"
                except StopIteration:
                    val_iter = None
            print(msg)
            start = time.perf_counter()
        if step % args.ckptEvery == 0 and step > start_step:
            save_step_checkpoint(args.output, model.state_dict(), step)
        step += 1
        if args.maxSteps is not None and step - start_step >= args.maxSteps:
            break

    save_step_checkpoint(args.output, model.state_dict(), step)
    print("All Done")
    return {"final_loss": last_loss, "steps": step}


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
