"""MAD block partitioning of a model's parameters.

Port of ``real_time_self_adaptive_deep_stereo_tpu/adapt/blocks.py``. The
reference drives Modular ADaptation with JSON block configs listing layer
names per independently-trainable portion (``block_config/*.json``); the
same files are read here and translated through the model's
``layer_to_path`` map.

In JAX a block extracts and merges a sub-pytree. Here a block is the
ordered list of the module's own ``nn.Parameter`` objects under its
paths: the engine asks autograd for the gradient of exactly these and
updates them in place, the counterpart of TF's
``optimizer.minimize(loss, var_list=...)``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

from torch import nn

__all__ = ["Block", "load_block_config", "make_blocks", "default_block_config_path"]

Path = Tuple[str, ...]


class Block:
    """One independently-trainable network portion of ``model``.

    ``paths`` are parameter-group paths as in the JAX package
    (``('pyramid', 'conv12')``); ``names`` the ``state_dict`` keys under
    them (``'pyramid.conv12.weight'``), in path order; ``params`` the
    parameters themselves."""

    def __init__(self, index: int, paths: Sequence[Path], model: nn.Module):
        self.index = index
        # deduplicate while keeping order (left/right share pyramid convs)
        self.paths: List[Path] = list(dict.fromkeys(tuple(p) for p in paths))
        self.names: List[str] = []
        self.params: List[nn.Parameter] = []
        for path in self.paths:
            prefix = ".".join(path)
            for name, param in model.get_submodule(prefix).named_parameters():
                self.names.append(f"{prefix}.{name}")
                self.params.append(param)

    def named_params(self) -> Dict[str, nn.Parameter]:
        return dict(zip(self.names, self.params))

    def __repr__(self):
        return f"Block({self.index}, {['/'.join(p) for p in self.paths]})"


def load_block_config(path: str) -> List[List[str]]:
    """Load a reference-format block config JSON (list of layer-name lists)."""
    with open(path) as f:
        return json.load(f)


def make_blocks(layer_groups: Sequence[Sequence[str]], model: nn.Module) -> List[Block]:
    """Translate layer-name groups into Blocks of ``model`` through its
    ``layer_to_path`` map; names that own no parameters are skipped."""
    blocks = []
    for i, group in enumerate(layer_groups):
        paths = [model.layer_to_path(name) for name in group]
        blocks.append(Block(i, [tuple(p) for p in paths if p is not None], model))
    return blocks


def default_block_config_path(model_name: str) -> str:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fname = "MadNet_full.json" if model_name == "MADNet" else "dispnet_full.json"
    return os.path.join(here, "..", "block_config", fname)
