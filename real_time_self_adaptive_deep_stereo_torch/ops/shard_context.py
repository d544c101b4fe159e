"""The width-sharded layout in force, which the width-reading ops consult.

:mod:`..parallel.spatial` builds a layout (one frame's width cut over the
ranks of a process group) and makes it the active one with
:func:`sharded`. The ops, the losses, the models and the engine read
:func:`active` and :func:`width` and reach the layout's exchanges
through the object it returns. Off the width-sharded path no layout is
active and nothing changes.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

__all__ = ["active", "sharded", "width"]

_ACTIVE = None


def active():
    """The layout in force (a :class:`..parallel.spatial.Layout`), or None
    off the width-sharded path."""
    return _ACTIVE


@contextlib.contextmanager
def sharded(layout) -> Iterator[None]:
    """Run a block under ``layout`` (None: unsharded), then restore."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, layout
    try:
        yield
    finally:
        _ACTIVE = prev


def width(t: torch.Tensor, dim: int) -> int:
    """The global width of axis ``dim`` of ``t``: its own size off the
    width-sharded path."""
    return t.shape[dim] if _ACTIVE is None else _ACTIVE.global_width(t.shape[dim])
