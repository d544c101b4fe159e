"""Seeded weights, made on the device in a few bulk draws.

Every convolution weight is Xavier-uniform (``+-sqrt(6 / (k*k*(in+out)))``)
and every bias ``bias_std`` times a unit normal, both from one
``torch.Generator`` on ``device`` seeded with ``--seed``. The
configuration's ``tame`` rules then scale the output layers' weights and
shift their biases, as random-weight checks of these networks do, so that
the predictions (and with them the warps' gathers) fall in a realistic
range of a few tens of pixels instead of thousands, where the relu and
the warps' clips would zero most gradients.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Sequence, Tuple

import torch


def make_weights(shapes: Sequence[Tuple[str, Tuple[int, ...]]], rules: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` for ``shapes`` (``(name, shape)``, names ending in
    ``.weight`` or ``.bias``), float32 on ``device``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    ws = [(n, s) for n, s in shapes if n.endswith(".weight")]
    bs = [(n, s) for n, s in shapes if n.endswith(".bias")]
    u = torch.rand(sum(math.prod(s) for _, s in ws), generator=g, device=device)
    z = torch.randn(sum(math.prod(s) for _, s in bs), generator=g, device=device)
    out, at = {}, 0
    for name, shape in ws:
        n = math.prod(shape)
        s0, s1, kh, kw = shape
        lim = math.sqrt(6.0 / (kh * kw * (s0 + s1)))
        out[name] = ((2.0 * u[at : at + n] - 1.0) * lim).view(shape)
        at += n
    at = 0
    for name, shape in bs:
        n = math.prod(shape)
        out[name] = (rules.get("bias_std", 0.01) * z[at : at + n]).view(shape)
        at += n
    for rule in rules.get("tame", []):
        pattern = re.compile(rule["match"])
        hits = [n for n in out if pattern.search(n.rsplit(".", 1)[0])]
        if not hits:
            raise ValueError(f"tame rule {rule['match']!r} matches no layer")
        for name in hits:
            if name.endswith(".weight"):
                out[name].mul_(rule.get("weight_scale", 1.0))
            else:
                out[name].add_(rule.get("bias", 0.0))
    return out
