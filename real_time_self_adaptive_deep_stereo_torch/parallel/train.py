"""Data-parallel supervised training step and width-sharded adaptation step.

Port of ``make_dp_train_step`` and ``make_spatial_adapt_step`` in
``real_time_self_adaptive_deep_stereo_tpu/parallel/train.py``. There the
weights are replicated, the batch is sharded over the ``data`` mesh axis,
and GSPMD inserts the gradient all-reduce, because the loss is one global
mean over the whole batch. Here every rank is a process that holds the
weights and its contiguous piece of the batch (:func:`.sharding.shard_batch`),
and the step says the collectives itself.

The global mean is the point. ``mean_l1`` is ``sum(mask*|x-y|) / sum(mask)``
over the valid pixels of the whole batch, at each scale of the multi-scale
loss. Averaging per-rank means, as ``DistributedDataParallel`` averages
per-rank gradients, weighs a pixel by how few valid pixels its rank holds;
on sparse ground truth (KITTI) the ranks' counts differ in every batch, and
so would loss and gradient. So each rank takes the same loss as a *sum*
over its own pixels (``sum_l1``), divided by the count summed over the
ranks: one all-reduce of the valid count (the mask is the target's, the
same at every scale). The ranks' losses then add up to the global loss,
their gradients to its gradient: one all-reduce of the loss and every
gradient in one flat vector, as a sum. Every rank then takes the same
TF-form Adam step (``utils/optim.py``) on the same numbers, so the weights
stay equal bit for bit.

``make_spatial_adapt_step`` shards one frame along its width
(:mod:`.spatial`): every rank runs the model (MADNet or DispNet) on its
columns, fetching the halos its convolutions read, and takes the loss as
its own term, its sums over the global counts. The terms add up to the loss and their gradients
to its gradient, so one all-reduce of the loss and the flat gradient
gives every rank the whole frame's, and the same momentum step. (Each
rank backpropagates its own term only: an all-reduced loss, backpropagated
on every rank, would count the gradient once a rank.)
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from real_time_self_adaptive_deep_stereo_torch.losses import get_reprojection_loss, get_supervised_loss
from real_time_self_adaptive_deep_stereo_torch.losses.factory import supervised_invalid
from real_time_self_adaptive_deep_stereo_torch.parallel import spatial
from real_time_self_adaptive_deep_stereo_torch.utils import optim

__all__ = ["GLOBAL_FORM", "broadcast_weights", "make_dp_train_step", "make_spatial_adapt_step"]

# supervised loss: (the loss as a sum over a rank's pixels, what the global
# loss divides the ranks' summed sums by: the valid pixels, all pixels, or
# nothing). The other losses of the registry take no mask, or (ZNCC) are no
# sum over pixels.
GLOBAL_FORM: Dict[str, Tuple[str, Optional[str]]] = {
    "mean_l1": ("sum_l1", "valid"),
    "mean_l2": ("sum_l2", "valid"),
    "mean_huber": ("sum_huber", "pixels"),
    "sum_l1": ("sum_l1", None),
    "sum_l2": ("sum_l2", None),
    "sum_huber": ("sum_huber", None),
}


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, at = [], 0
    for t in like:
        out.append(flat[at : at + t.numel()].view_as(t))
        at += t.numel()
    return out


@torch.no_grad()
def broadcast_weights(model: torch.nn.Module, group) -> None:
    """Rank 0's weights onto every rank of ``group`` (one broadcast of a
    flat vector), then raises unless every rank holds the same bits (the
    elementwise max and min over the ranks equal)."""
    params = [p for _, p in model.named_parameters()]
    flat = _flat(params)
    dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    if not (torch.equal(hi, flat) and torch.equal(lo, flat)):
        raise AssertionError("the ranks' weights differ after the broadcast")
    for p, v in zip(params, _unflat(flat, params)):
        p.copy_(v)


def make_dp_train_step(
    model: torch.nn.Module,
    mesh: DeviceMesh,
    lr: float = 1e-4,
    loss_name: str = "mean_l1",
    max_disp: float = 192.0,
    loss_weights=None,
    axis: str = "data",
) -> Callable:
    """``step(batch) -> loss``, the data-parallel counterpart of
    ``cli/train.py::make_train_step`` over the ranks of ``mesh``'s axis
    ``axis``: ``batch`` is this rank's piece of the global batch (NHWC
    ``left``, ``right``, ``target`` on the model's device; rank r holds
    slice r, as ``shard_batch(batch, batch_sharded(mesh))`` cuts it), the
    returned loss the global batch's, and the Adam update of every rank
    the one of a single process on the whole batch. The weights are
    broadcast from rank 0 first. ``step.opt`` is the optimizer state,
    ``step.grads`` the last step's gradient, summed over the ranks."""
    from real_time_self_adaptive_deep_stereo_torch.cli.train import make_train_step

    if loss_name not in GLOBAL_FORM:
        raise ValueError(
            f"loss {loss_name!r} has no data-parallel form: pick one of {sorted(GLOBAL_FORM)}"
        )
    group = mesh.get_group(axis)
    broadcast_weights(model, group)
    sum_name, over = GLOBAL_FORM[loss_name]
    rank_sum = get_supervised_loss(sum_name, multiScale=True, weights=loss_weights, max_disp=max_disp)

    def loss_fn(disparities, batch):
        loss = rank_sum(disparities, batch)
        if over is None:
            return loss
        target = batch["target"]
        if over == "valid":
            count = (~supervised_invalid(target, max_disp)).sum(dtype=torch.float64)
        else:
            count = torch.tensor(float(target.numel()), dtype=torch.float64, device=target.device)
        dist.all_reduce(count, group=group)
        return loss / count.to(loss.dtype)

    def reduce(loss, grads):
        flat = torch.cat([loss.reshape(1).to(torch.float32), _flat(grads)])
        dist.all_reduce(flat, group=group)
        return flat[0].clone(), _unflat(flat[1:], grads)  # the loss outlives the bucket

    return make_train_step(model, loss_fn, lr, reduce=reduce)


def make_spatial_adapt_step(
    model: torch.nn.Module,
    mesh: DeviceMesh,
    lr: float = 1e-4,
    axis: str = "data",
    momentum: float = 0.9,
) -> Callable:
    """``step(frame) -> loss``: one FULL adaptation step of ``model``, any
    model with ``width_sharding`` (MADNet, DispNet), with the
    ``mean_SSIM_l1`` reprojection loss and momentum, the frame sharded
    along its width over the ranks of ``mesh``'s axis ``axis``. ``frame``
    is this rank's piece (NHWC ``left``, ``right`` and, unused, ``target``;
    numpy or tensors), as ``shard_batch(frame, width_sharded(mesh))`` cuts
    it; the returned loss is the whole frame's, and every rank takes the
    momentum step of one process on the whole frame. The weights are
    broadcast from rank 0 first. ``step.acc`` is the momentum state,
    ``step.grads`` the last step's gradient, ``step.layout`` the last
    frame's :class:`.spatial.Layout` (its ``audit`` counts the fetches)."""
    spatial.check_model(model)
    group = mesh.get_group(axis)
    broadcast_weights(model, group)
    loss_fn = get_reprojection_loss("mean_SSIM_l1", reduced=True)
    params = [p for _, p in model.named_parameters()]
    device = params[0].device
    layouts: Dict[int, spatial.Layout] = {}

    def step(frame) -> torch.Tensor:
        frame = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
                 .to(device, torch.float32) for k, v in frame.items()}
        w = frame["left"].shape[2]
        if w not in layouts:
            layouts[w] = spatial.Layout.for_pieces(group, w)
        layout = step.layout = layouts[w]
        with spatial.sharded(layout):
            inside = {k: layout.enter(v) for k, v in frame.items()}
            out = model(inside["left"], inside["right"])
            term = loss_fn(out["disparities"], inside)
        grads = torch.autograd.grad(term, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        flat = torch.cat([term.detach().reshape(1), _flat(grads)])
        dist.all_reduce(flat, group=group)
        grads = _unflat(flat[1:], grads)
        optim.momentum_update(params, step.acc, grads, lr, momentum)
        step.grads = grads
        return flat[0].clone()

    step.acc = optim.momentum_init(params)
    step.grads = None
    step.layout = None
    return step
