"""Minimal explicit optimizers over lists or dicts of tensors.

Port of ``real_time_self_adaptive_deep_stereo_tpu/utils/optim.py``. MAD
adaptation updates one block's parameters per step, so the optimizers
are plain functions over whatever collection of tensors the caller picks
(all parameters, or one block's), with the update numerics of the
reference's TF1 optimizers kept visible:

* SGD + momentum (``tf.train.MomentumOptimizer(lr, 0.9)``):
  ``acc = beta*acc + g; p -= lr*acc``. ``torch.optim.SGD`` folds ``lr``
  in at another point and equals this only while ``lr`` is constant.
* Adam (``tf.train.AdamOptimizer``): ``lr_t = lr*sqrt(1-b2^t)/(1-b1^t)``
  and ``p -= lr_t*m/(sqrt(v)+eps)``, epsilon outside the bias
  correction; ``torch.optim.Adam`` puts it elsewhere.

The JAX functions return new trees; these update ``params`` and the
state tensors in place under ``torch.no_grad()`` (the engine owns its
module's parameters). Collections are lists, tuples or dicts of tensors;
``params``, the state and ``grads`` share one structure. A one-element
list holding a slice of a flat arena (``adapt/arena.py``) is such a
collection: the update is then one or two ops over the slice.

Adam's step count may be a Python int (the host session counts its own
steps) or a 0-dim integer tensor on the parameters' device (the fused
session, whose steps are replayed as CUDA graphs: a Python number would
be frozen into the graph as a constant, and every replay would take step
1). With a tensor the step size is computed on the device, in float32
either way.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Union

import torch

__all__ = [
    "momentum_init",
    "momentum_update",
    "adam_init",
    "adam_update",
    "adam_lr_t",
]

Tensors = Union[Sequence[torch.Tensor], Dict[str, torch.Tensor]]


def _values(tree: Tensors) -> Iterable[torch.Tensor]:
    return tree.values() if isinstance(tree, dict) else tree


def _zeros_like(params: Tensors) -> Tensors:
    if isinstance(params, dict):
        return {k: torch.zeros_like(p) for k, p in params.items()}
    return [torch.zeros_like(p) for p in params]


def momentum_init(params: Tensors) -> Tensors:
    """A zero accumulator per parameter."""
    return _zeros_like(params)


@torch.no_grad()
def momentum_update(
    params: Tensors, acc: Tensors, grads: Tensors, lr: float, beta: float = 0.9
) -> None:
    """``acc = beta*acc + g; p -= lr*acc``, in place."""
    for p, a, g in zip(_values(params), _values(acc), _values(grads)):
        a.mul_(beta).add_(g)
        p.sub_(lr * a)


def adam_init(params: Tensors) -> Dict:
    """Zero first and second moments and the step count ``t`` (a Python
    int: one count for the whole optimizer, whatever subset a step
    updates)."""
    return {"m": _zeros_like(params), "v": _zeros_like(params), "t": 0}


def adam_lr_t(
    lr: float, t: Union[int, torch.Tensor], b1: float = 0.9, b2: float = 0.999
) -> Union[float, torch.Tensor]:
    """TF's bias-corrected step size ``lr*sqrt(1-b2^t)/(1-b1^t)`` after
    ``t`` steps, computed in float32 as the JAX package computes it
    (``1 - b2**t`` cancels, so the working type shows in the result). A
    Python ``t`` gives a float; a tensor ``t`` gives a 0-dim float32 tensor
    on its device, with no transfer to the host."""
    if isinstance(t, torch.Tensor):
        tf_ = t.to(torch.float32)
        return lr * torch.sqrt(1.0 - b2**tf_) / (1.0 - b1**tf_)
    tf_ = torch.tensor(float(t), dtype=torch.float32)
    return float(lr * torch.sqrt(1.0 - b2**tf_) / (1.0 - b1**tf_))


@torch.no_grad()
def adam_update(
    params: Tensors,
    m: Tensors,
    v: Tensors,
    grads: Tensors,
    lr: float,
    t: Union[int, torch.Tensor],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> None:
    """One TF-form Adam step, in place, as step number ``t`` (1 for the
    first; an int or a 0-dim tensor, see :func:`adam_lr_t`). The caller
    keeps the count: it is shared by every block."""
    lr_t = adam_lr_t(lr, t, b1, b2)
    for p, m_, v_, g in zip(_values(params), _values(m), _values(v), _values(grads)):
        m_.mul_(b1).add_((1 - b1) * g)
        v_.mul_(b2).add_((1 - b2) * g * g)
        p.sub_(lr_t * m_ / (torch.sqrt(v_) + eps))
