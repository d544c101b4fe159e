"""Flat parameter arena for the fused adaptation session.

Port of ``real_time_self_adaptive_deep_stereo_tpu/adapt/arena.py``. A
module's parameters are a hundred separate tensors; an optimizer update,
a reset or a snapshot over them is a hundred small kernels. The arena
packs them into ONE contiguous fp32 vector, ordered so that every MAD
block occupies one contiguous ``[start, end)`` range (block 0's tensors,
block 1's, ..., the tensors of no block last), so that

* a block's optimizer update is one or two ops over a slice,
* the reset safeguard is one ``where`` over the vector,
* a snapshot is one contiguous copy.

The JAX arena ravels a pytree into the vector and unravels it again
inside the jitted step (``ravel``, ``unravel``, ``unravel_override``).
Here views do that work: :class:`Arena` re-points the ``data`` of the
module's own ``nn.Parameter`` objects at slices of the vector, so the
model code runs unchanged on the arena, and re-points their ``grad`` at
slices of a second vector, so that ``backward(inputs=block.params)``
accumulates a block's gradient into one contiguous slice. Optimizer
slots and the pristine weights are further vectors of the same layout.

The layout alone is :class:`ArenaSpec` (names, shapes, offsets, block
ranges), which needs shapes only and serves the host-side unravel of a
snapshot.

A multi-stream session (``num_streams=N``) keeps N weight vectors in one
``[N, P]`` arena, one row per stream, every row starting from the module's
weights. The module's parameters are views of one row at a time:
:meth:`Arena.bind` re-points them at another. A CUDA graph captured while
row s is bound reads and writes row s at every replay, whatever row the
module is bound to then. Under ``torch.func`` (the batched streams of
``stream_impl="vmap"``) the module runs instead on
:meth:`ArenaSpec.views` of a row, by ``functional_call``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from real_time_self_adaptive_deep_stereo_torch.adapt.blocks import Block

__all__ = ["ArenaSpec", "Arena", "build_arena"]


def _sort_key(name: str) -> Tuple[str, ...]:
    return tuple(name.split("."))


class ArenaSpec:
    """Packing of a module's parameters and a block partition.

    ``entries`` is a list of ``(name, shape, offset, size)`` in arena
    order: for every block in turn, for each of its paths in turn, the
    tensors under that path in sorted order (as the JAX arena walks its
    pytree), then the tensors of no block in sorted order.
    ``block_ranges[k]`` is block k's ``(start, end)``; ``size`` the length
    of the vector. A parameter listed by two blocks raises ``ValueError``:
    it cannot live in two contiguous ranges."""

    def __init__(self, shapes: Dict[str, Sequence[int]], blocks: Sequence[Block]):
        entries: List[Tuple[str, Tuple[int, ...], int, int]] = []
        ranges: List[Tuple[int, int]] = []
        seen = set()
        pos = 0

        def add(name: str) -> None:
            nonlocal pos
            shape = tuple(int(s) for s in shapes[name])
            size = int(np.prod(shape)) if shape else 1
            entries.append((name, shape, pos, size))
            seen.add(name)
            pos += size

        for block in blocks or []:
            start = pos
            for path in block.paths:
                prefix = ".".join(path) + "."
                for name in sorted((n for n in block.names if n.startswith(prefix)), key=_sort_key):
                    if name in seen:
                        raise ValueError(
                            f"param {name.replace('.', '/')} appears in more than one MAD "
                            "block; the flat arena requires disjoint blocks: use "
                            "arena=False for overlapping block configs"
                        )
                    add(name)
            ranges.append((start, pos))
        for name in sorted(shapes, key=_sort_key):
            if name not in seen:
                add(name)

        self.entries = entries
        self.block_ranges = ranges
        self.size = pos

    def block_slice(self, flat: torch.Tensor, block: int) -> torch.Tensor:
        """Block ``block``'s range of an arena vector (a view)."""
        start, end = self.block_ranges[block]
        return flat[start:end]

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``{name: tensor}`` views of one arena vector (a row), shaped as
        the parameters: what ``torch.func.functional_call`` takes."""
        return {name: flat[off : off + size].view(shape) for name, shape, off, size in self.entries}

    def ravel(self, tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One arena vector of ``{name: tensor}`` shaped as the parameters
        (the inverse of :meth:`views`): a gradient taken with respect to the
        views comes back in the arena's layout by one concatenation, where
        the gradient of each slice of the row would be a zero-filled row."""
        return torch.cat([tensors[name].reshape(-1) for name, _, _, _ in self.entries])

    def block_ids(self) -> np.ndarray:
        """int32 vector over the arena: the owning block of every element,
        -1 for the tensors of no block."""
        bid = np.full((self.size,), -1, np.int32)
        for k, (s, e) in enumerate(self.block_ranges):
            bid[s:e] = k
        return bid

    def unravel_host(self, flat: np.ndarray) -> Dict[str, np.ndarray]:
        """``{name: array}`` views of a host copy of the arena vector; the
        axes before the last (a multi-stream arena's rows) lead every leaf."""
        lead = tuple(flat.shape[:-1])
        return {
            name: flat[..., off : off + size].reshape(lead + shape)
            for name, shape, off, size in self.entries
        }


class Arena:
    """The arena of ``model`` on the model's device.

    After construction every parameter of ``model`` is a view of
    ``flat`` and its ``grad`` a view of ``grad``; ``flat0`` is a clone of
    the weights at construction (the pristine weights of the reset).
    Loading weights with ``load_state_dict`` keeps the views (it copies in
    place); moving the module to another device does not.

    ``rows=N`` (N > 0) makes ``flat`` ``[N, P]``, every row a copy of the
    weights, with the module bound to row 0; ``grad`` and ``flat0`` stay
    ``[P]``, shared by the rows."""

    def __init__(self, model: nn.Module, blocks: Sequence[Block], rows: int = 0):
        named = dict(model.named_parameters())
        if any(p.dtype != torch.float32 for p in named.values()):
            raise TypeError("the arena holds float32 parameters only")
        self.spec = ArenaSpec({n: p.shape for n, p in named.items()}, blocks)
        device = next(iter(named.values())).device
        self.rows = int(rows)
        lead = (self.rows,) if self.rows else ()
        self.flat = torch.empty(lead + (self.spec.size,), dtype=torch.float32, device=device)
        self.grad = torch.zeros(self.spec.size, dtype=torch.float32, device=device)
        self._params = [named[name] for name, *_ in self.spec.entries]
        # per row, the view of every parameter, in entry order
        self._row_views = [
            [row[off : off + size].view(shape) for _, shape, off, size in self.spec.entries]
            for row in (self.flat if self.rows else [self.flat])
        ]
        for p, view, (_, shape, off, size) in zip(self._params, self._row_views[0], self.spec.entries):
            view.copy_(p.detach())
            p.data = view
            p.grad = self.grad[off : off + size].view(shape)
        if self.rows:
            self.flat[1:].copy_(self.flat[0])
        self.flat0 = (self.flat[0] if self.rows else self.flat).clone()
        self.bound = 0  # the row the module's parameters view

    def bind(self, row: int) -> None:
        """Point the module's parameters at row ``row`` of a multi-row arena."""
        if row != self.bound:
            for p, view in zip(self._params, self._row_views[row]):
                p.data = view
            self.bound = row

    # the layout's accessors, by the JAX arena's names
    @property
    def entries(self):
        return self.spec.entries

    @property
    def block_ranges(self):
        return self.spec.block_ranges

    @property
    def size(self) -> int:
        return self.spec.size

    def block_slice(self, flat: torch.Tensor, block: int) -> torch.Tensor:
        return self.spec.block_slice(flat, block)

    def new_slot(self) -> torch.Tensor:
        """A zero vector of the arena's layout (an optimizer slot)."""
        return torch.zeros_like(self.flat)


def build_arena(model: nn.Module, blocks: Sequence[Block], rows: int = 0) -> Arena:
    return Arena(model, blocks, rows)
