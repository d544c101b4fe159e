"""Operations and bytes of an op from its shapes, and the card's peaks.

``<op>.py`` gives ``count(kind, args, itemsize)`` -> ``(flops, bytes)``
for the ``<op>_fwd`` and ``<op>_bwd`` records of the reference
(``reference/ops.py``): each input the op needs read once and each output
written once, whatever a kernel reads again. ``peaks.json`` holds the
published peaks.
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple


def count(record: Tuple[str, Dict], itemsize: int = 4) -> Tuple[float, float]:
    kind, args = record
    op = kind.rsplit("_", 1)[0]
    return importlib.import_module(f"stereo_bench.rooflines.{op}").count(kind, args, itemsize)


def least_seconds(record, flops_peak: float, bytes_peak: float, itemsize: int = 4) -> float:
    """The larger of the operations over the peak and the bytes over the
    memory's bandwidth."""
    flops, nbytes = count(record, itemsize)
    return max(flops / flops_peak, nbytes / bytes_peak)
