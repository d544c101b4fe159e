"""Plain PyTorch ops of the reference models, NCHW, float32.

Written from the published layer equations and the TF1 reference's
numerics, which the program under test also follows:

* convolutions pad as TensorFlow's SAME does (the extra pixel of an even
  input at stride 2 goes after), then run with no padding;
* a transposed convolution keeps ``(k-1)//2`` of its full output's columns
  before the ``n*stride`` it returns, as TF SAME does;
* the bilinear resize is TF1's legacy kernel (``src = dst * in/out``, no
  half-pixel offset), as two products with dense interpolation matrices;
* the pad to a multiple of 64 is a centred reflection, the crop back a
  centred one;
* the correlation is ``mean_c(x[c, h, w] * y[c, h, w + d])`` for ``d`` in
  ``-r .. r``, ``y`` zero beyond its edges;
* the warps clip the offset to a fixed window, then sample bilinearly: the
  image at ``x - disp`` with its edge repeated, the features at ``x + dx``
  with zeros beyond the edge.

Nothing here imports the program: this file is the yardstick.

Inside :func:`recording`, the correlation and the warps report each call
(and, where autograd reaches it, its backward) with its shape, which is
what the benchmark's op counts are made from.
"""

from __future__ import annotations

import contextlib
import functools
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F


_SINK: Optional[List] = None


@contextlib.contextmanager
def recording(sink: List):
    """Append ``(op, shape args)`` of every correlation and warp, forward
    and backward, to ``sink`` inside the block."""
    global _SINK
    prev, _SINK = _SINK, sink
    try:
        yield sink
    finally:
        _SINK = prev


def _record(out, op: str, inputs, **args):
    """Report a call and, by a hook on its output, its backward: ``grads``
    names the inputs that take a gradient."""
    if _SINK is None:
        return out
    sink = _SINK
    sink.append((op + "_fwd", args))
    grads = tuple(k for k, t in inputs.items() if t.requires_grad)
    if out.requires_grad:
        out.register_hook(lambda g: sink.append((op + "_bwd", dict(args, grads=grads))))
    return out


def leaky(alpha: float):
    return lambda x: torch.maximum(alpha * x, x)


def linear(x):
    return x


def _same_1d(size: int, k: int, stride: int, rate: int):
    k_eff = (k - 1) * rate + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + k_eff - size, 0)
    return total // 2, total - total // 2


def conv(x, w, b, stride=1, rate=1, act=linear):
    """TF SAME convolution of NCHW ``x`` with OIHW ``w``, then ``act``."""
    top, bottom = _same_1d(x.shape[2], w.shape[2], stride, rate)
    left, right = _same_1d(x.shape[3], w.shape[3], stride, rate)
    x = F.pad(x, (left, right, top, bottom))
    return act(F.conv2d(x, w, b, stride=stride, dilation=rate))


def conv_transpose(x, w, b, stride=2, act=linear):
    """TF SAME transposed convolution; ``w`` is ``[in, out, kh, kw]``."""
    y = F.conv_transpose2d(x, w, None, stride=stride)
    pads = []
    for n, k, full in ((x.shape[3], w.shape[3], y.shape[3]), (x.shape[2], w.shape[2], y.shape[2])):
        start = (k - 1) // 2
        pads += [-start, n * stride + start - full]
    y = F.pad(y, pads)
    return act(y + b.view(1, -1, 1, 1))


@functools.lru_cache(maxsize=None)
def _interp(in_size: int, out_size: int) -> np.ndarray:
    m = np.zeros((out_size, in_size), np.float32)
    scale = in_size / out_size
    for o in range(out_size):
        s = o * scale
        lo = min(int(np.floor(s)), in_size - 1)
        hi = min(lo + 1, in_size - 1)
        frac = np.float32(s - lo)
        m[o, lo] += 1.0 - frac
        m[o, hi] += frac
    return m


def resize(img, out_h: int, out_w: int):
    """TF1-legacy bilinear resize of NCHW ``img``."""
    h, w = img.shape[2], img.shape[3]
    x = img
    if h != out_h:
        x = torch.from_numpy(_interp(h, out_h)).to(x.device) @ x
    if w != out_w:
        x = x @ torch.from_numpy(_interp(w, out_w)).to(x.device).T
    return x


def padded_shape(h: int, w: int, factor: int = 64):
    return -(-h // factor) * factor, -(-w // factor) * factor


def pad_image(img, factor: int = 64):
    h, w = img.shape[2], img.shape[3]
    nh, nw = padded_shape(h, w, factor)
    if (nh, nw) == (h, w):
        return img
    return F.pad(img, ((nw - w) // 2, (nw - w + 1) // 2, (nh - h) // 2, (nh - h + 1) // 2), mode="reflect")


def crop(img, h: int, w: int):
    """Centred crop of NCHW ``img`` (at least ``h x w``) to ``h x w``."""
    top, left = (img.shape[2] - h) // 2, (img.shape[3] - w) // 2
    return img[:, :, top : top + h, left : left + w]


def correlation(x, y, radius: int):
    """[B, 2r+1, H, W] cost volume of NCHW features."""
    b, c, h, w = x.shape
    ypad = F.pad(y, (radius, radius))
    out = torch.cat([(ypad[..., k : k + w] * x).mean(dim=1, keepdim=True) for k in range(2 * radius + 1)], dim=1)
    return _record(out, "corr", {"x": x, "y": y}, b=b, c=c, h=h, w=w, radius=radius)


def _sample_w(src, pos, zero_outside: bool):
    """Bilinear samples of NCHW ``src`` along W at positions ``pos``
    ([B, 1, H, W]): with the edge repeated, or zero beyond it."""
    w = src.shape[3]
    x0 = torch.floor(pos)
    t = pos - x0
    taps = []
    for xi, wt in ((x0, 1.0 - t), (x0 + 1.0, t)):
        if zero_outside:
            wt = wt * ((xi >= 0) & (xi <= w - 1)).to(src.dtype)
        idx = xi.clamp(0, w - 1).long().expand(-1, src.shape[1], -1, -1)
        taps.append(wt * torch.gather(src, 3, idx))
    return taps[0] + taps[1]


def warp_image(img, disp, max_disp: int = 192):
    """``img`` sampled at ``x - clip(disp, 0, max_disp)``, edge repeated."""
    xs = torch.arange(img.shape[3], dtype=img.dtype, device=img.device)
    out = _sample_w(img, xs - disp.clamp(0.0, float(max_disp)), zero_outside=False)
    b, c, h, w = img.shape
    return _record(out, "warp", {"src": img, "off": disp}, b=b, c=c, h=h, w=w)


def warp_features(feats, dx, max_neg: int, max_pos: int):
    """``feats`` sampled at ``x + clip(dx, -max_neg, max_pos)``, zero
    beyond the edges."""
    xs = torch.arange(feats.shape[3], dtype=feats.dtype, device=feats.device)
    out = _sample_w(feats, xs + dx.clamp(-float(max_neg), float(max_pos)), zero_outside=True)
    b, c, h, w = feats.shape
    return _record(out, "warp", {"src": feats, "off": dx}, b=b, c=c, h=h, w=w)
