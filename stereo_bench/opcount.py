"""The work of a frame, from the reference at the cell's shapes.

For each kind of frame the cell runs (``frame`` under NONE and FULL,
``block<k>`` under MAD: block ``k`` trained) the reference's step runs once
on the ``meta`` device, which computes shapes and no values, under
``FlopCounterMode`` (the convolutions, forward and backward, and the
resizes' products) and the reference's op recording (the correlations and
the warps, forward and, where autograd reaches them, backward). A frame's
FLOPs are the counter's plus the correlations' and warps' own counts
(``rooflines/``).
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch.utils.flop_counter import FlopCounterMode

from stereo_bench import rooflines
from stereo_bench.reference import loss as L
from stereo_bench.reference import models as M
from stereo_bench.reference import ops


def _step(cell, params, trained: List[str], target: int) -> None:
    """The reference's step on ``meta``: forward, the loss of prediction
    ``target`` differentiated with respect to ``trained``, and the served
    disparity's loss (MAD); or the forward alone."""
    cfg, trf = cell.config, cell.traffic
    h, w = cfg["input"]["height"], cfg["input"]["width"]
    left = torch.empty((1, h, w, 3), device="meta")
    right = torch.empty((1, h, w, 3), device="meta")
    forward = M.MODELS[cfg["model"]][0]
    bulkhead = cfg.get("bulkhead_in", {}).get(trf["mode"], False)
    p = {n: t.requires_grad_(n in trained) for n, t in params.items()}
    if not trained:
        with torch.no_grad():
            forward(p, left, right, bulkhead)
        return
    disps = forward(p, left, right, bulkhead)
    torch.autograd.grad(L.reprojection_loss(disps[target], left, right), [p[n] for n in trained])
    if trf["mode"] == "MAD":
        with torch.no_grad():
            L.reprojection_loss(disps[-1], left, right)


def frame_ops(cell) -> Dict[str, Dict]:
    """``{kind: {"flops": F, "ops": [record, ...]}}`` for the cell."""
    cfg, trf = cell.config, cell.traffic
    shapes = dict(M.MODELS[cfg["model"]][2]())
    names = list(shapes)
    if trf["mode"] == "MAD":
        blocks = M.block_names(cfg["model"], cfg["blocks"], names)
        kinds = {f"block{k}": (b, k) for k, b in enumerate(blocks)}
    elif trf["mode"] == "FULL":
        kinds = {"frame": (names, -1)}
    else:
        kinds = {"frame": ([], -1)}
    out = {}
    for kind, (trained, target) in kinds.items():
        params = {n: torch.empty(s, device="meta") for n, s in shapes.items()}
        records: List = []
        with FlopCounterMode(display=False) as counter, ops.recording(records):
            _step(cell, params, trained, target)
        flops = counter.get_total_flops() + sum(rooflines.count(r)[0] for r in records)
        out[kind] = {"flops": float(flops), "ops": records}
    return out
