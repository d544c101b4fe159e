"""npz checkpoints and the JAX <-> PyTorch weight converter.

``flatten_params``, ``unflatten_params``, ``save_params``,
``load_params``, ``latest_checkpoint``, ``save_step_checkpoint`` and
``restore_or_init`` are ports of
``real_time_self_adaptive_deep_stereo_tpu/utils/checkpoint.py``: a flat
``.npz`` of ``path/to/leaf`` -> array in the JAX layout, so a file saved
by either package loads in the other. The TF1 importer is not ported:
``restore_or_init`` raises where the JAX one would read a TF1 checkpoint
(``ROADMAP.md``, queue 1, the TF1 importer).

The JAX package keeps conv weights as HWIO under leaf ``w`` and biases
under ``b``; a PyTorch ``state_dict`` keeps OIHW ``weight`` and ``bias``
under dotted keys. :func:`params_from_jax` maps the first to the second
and :func:`params_to_jax` back.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "flatten_params",
    "unflatten_params",
    "save_params",
    "load_params",
    "latest_checkpoint",
    "save_step_checkpoint",
    "restore_or_init",
    "params_from_jax",
    "params_to_jax",
]

Tree = Any


def flatten_params(tree: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_params(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_params(flat: Dict[str, np.ndarray]) -> Tree:
    root: Dict = {}
    for key, val in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def save_params(path: str, params: Tree) -> None:
    flat = flatten_params(params)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)


def load_params(path: str, dtype=None) -> Tree:
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        flat = {k: (data[k].astype(dtype) if dtype else data[k]) for k in data.files}
    return unflatten_params(flat)


_CKPT_RE = re.compile(r"weights-(\d+)\.npz$")


def latest_checkpoint(logdir: str) -> Optional[Tuple[str, int]]:
    """Find the newest step-numbered checkpoint in ``logdir``."""
    if not os.path.isdir(logdir):
        return None
    best = None
    for f in os.listdir(logdir):
        m = _CKPT_RE.search(f)
        if m:
            step = int(m.group(1))
            if best is None or step > best[1]:
                best = (os.path.join(logdir, f), step)
    return best


def save_step_checkpoint(
    logdir: str, state_dict: Dict[str, torch.Tensor], step: int, keep: int = 2
) -> str:
    """Save the port's ``state_dict`` as ``weights-{step}.npz`` in the JAX
    layout (:func:`params_to_jax`), keeping only the ``keep`` newest
    (reference keeps max_to_keep=2, Train.py:114)."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"weights-{step}.npz")
    save_params(path, params_to_jax(state_dict))
    ckpts = sorted(
        (
            (int(_CKPT_RE.search(f).group(1)), f)
            for f in os.listdir(logdir)
            if _CKPT_RE.search(f)
        )
    )
    for _, f in ckpts[:-keep]:
        os.remove(os.path.join(logdir, f))
    return path


def restore_or_init(
    logdir: str,
    params: Tree,
    initial_weights: Optional[str] = None,
    model=None,
) -> Tuple[Tree, bool, int]:
    """Resume-from-logdir if a checkpoint exists, else load
    ``initial_weights`` (.npz), else keep ``params``. Returns (params,
    restored?, step) like weights_utils.py:41-75; restored parameters are
    the JAX-layout tree of the file (:func:`params_from_jax` makes a
    ``state_dict`` of it). A TF1 checkpoint raises ``NotImplementedError``."""
    found = latest_checkpoint(logdir)
    if found:
        path, step = found
        return load_params(path), True, step
    if initial_weights:
        if initial_weights.endswith(".npz") or os.path.exists(initial_weights + ".npz"):
            return load_params(initial_weights), True, 0
        if model is not None:
            raise NotImplementedError(
                f"{initial_weights} is no .npz: reading TF1 checkpoints is not ported "
                "(ROADMAP.md, queue 1, the TF1 importer)"
            )
    return params, False, 0


_LEAF_TO_TORCH = {"w": "weight", "b": "bias"}
_LEAF_TO_JAX = {v: k for k, v in _LEAF_TO_TORCH.items()}


def params_from_jax(params: Tree) -> Dict[str, torch.Tensor]:
    """JAX parameters (a nested pytree of arrays, or its flat
    ``a/b/w`` form) -> a ``state_dict``: HWIO weights become OIHW, biases
    are copied as they are."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in flatten_params(params).items():  # a flat dict flattens to itself
        *path, leaf = key.split("/")
        if leaf not in _LEAF_TO_TORCH:
            raise KeyError(f"unexpected parameter leaf {key!r} (want .../w or .../b)")
        arr = np.asarray(val, dtype=np.float32)
        if leaf == "w":
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        out[".".join([*path, _LEAF_TO_TORCH[leaf]])] = torch.tensor(np.ascontiguousarray(arr))
    return out


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Tree:
    """Inverse of :func:`params_from_jax`: a nested tree of numpy arrays
    in the JAX layout, ready for :func:`save_params`."""
    flat = {}
    for key, val in state_dict.items():
        *path, leaf = key.split(".")
        arr = val.detach().cpu().numpy()
        if leaf == "weight":
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        flat["/".join([*path, _LEAF_TO_JAX[leaf]])] = np.ascontiguousarray(arr)
    return unflatten_params(flat)
