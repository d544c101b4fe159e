"""Bilinear resize, pad and crop with TF1-legacy numerics (NCHW).

Port of ``real_time_self_adaptive_deep_stereo_tpu/ops/resize.py``. The
resize is the TF<=1.12 bilinear kernel (``src = dst * in/out``, no
half-pixel offset, clamped at the top edge), which
``F.interpolate(align_corners=False)`` does not match; it runs as two
matmuls against dense interpolation matrices, as in JAX.

Under a width-sharded layout (:mod:`..parallel.spatial`) widths are
global: the resize takes the input columns that the rank's rows of the
width matrix touch (a column of halo for a resize by two), and the pad
and the crop act at the edge ranks only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from real_time_self_adaptive_deep_stereo_torch.ops import shard_context

__all__ = ["resize_bilinear", "resize_to", "crop_or_pad", "pad_image", "padded_shape"]


# Copied from real_time_self_adaptive_deep_stereo_tpu/ops/resize.py
# (_interp_matrix): the port imports nothing of the JAX package.
@functools.lru_cache(maxsize=None)
def _interp_matrix(in_size: int, out_size: int, dtype=np.float32) -> np.ndarray:
    """Dense [out_size, in_size] TF1-legacy bilinear interpolation matrix."""
    m = np.zeros((out_size, in_size), dtype=dtype)
    if in_size == out_size:
        np.fill_diagonal(m, 1.0)
        return m
    scale = in_size / out_size
    for o in range(out_size):
        s = o * scale
        lo = int(np.floor(s))
        lo = min(lo, in_size - 1)
        hi = min(lo + 1, in_size - 1)
        frac = np.float32(s - lo)
        m[o, lo] += 1.0 - frac
        m[o, hi] += frac
    return m


@functools.lru_cache(maxsize=None)
def _interp_tensor(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    # cached per device: the full-resolution matrices are ~1.5 MB and are
    # used several times per frame
    return torch.from_numpy(_interp_matrix(in_size, out_size)).to(device)


@functools.lru_cache(maxsize=None)
def _touched(in_size: int, out_size: int) -> tuple:
    """Per output column of the width matrix, the ``(first, last + 1)``
    input columns its nonzero weights touch."""
    m = _interp_matrix(in_size, out_size)
    return tuple((int(np.flatnonzero(r)[0]), int(np.flatnonzero(r)[-1]) + 1) for r in m)


@functools.lru_cache(maxsize=None)
def _interp_block(in_size: int, out_size: int, rows: tuple, cols: tuple, device: torch.device):
    """Rows ``[rows)`` and columns ``[cols)`` of the width matrix."""
    m = _interp_matrix(in_size, out_size)[rows[0] : rows[1], cols[0] : cols[1]]
    return torch.from_numpy(np.ascontiguousarray(m)).to(device)


def _resize_width_sharded(layout, x: torch.Tensor, w: int, out_w: int) -> torch.Tensor:
    """The rank's output columns of the width resize of NCHW ``x`` (the
    rank's columns of global width ``w``): each rank fetches the input
    columns that its rows of the matrix touch."""
    touched = _touched(w, out_w)
    spans = [
        (min(t[0] for t in touched[lo:hi]), max(t[1] for t in touched[lo:hi]))
        for lo, hi in layout.ranges(out_w)
    ]
    xe = layout.fetch(x, 3, layout.ranges(w), spans, "resize")
    block = _interp_block(w, out_w, layout.range(out_w), spans[layout.rank], x.device)
    return xe @ block.T


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize NCHW ``img`` to (out_h, out_w), TF1-legacy bilinear (under a
    width-sharded layout ``out_w`` is global, and the result the rank's
    columns)."""
    h, w = img.shape[2], shard_context.width(img, 3)
    if (h, w) == (out_h, out_w):
        return img
    x = img.float()
    if h != out_h:
        x = _interp_tensor(h, out_h, x.device) @ x  # [out_h,h] @ [b,c,h,w]
    if w != out_w:
        layout = shard_context.active()
        if layout is not None:
            x = _resize_width_sharded(layout, x, w, out_w)
        else:
            x = x @ _interp_tensor(w, out_w, x.device).T  # [b,c,h,w] @ [w,out_w]
    return x.to(img.dtype)


def resize_to(img: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Resize NCHW ``img`` to the spatial shape of NCHW ``like``."""
    return resize_bilinear(img, like.shape[2], like.shape[3])


def crop_or_pad(img: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """Centred crop and/or zero pad of NCHW ``img`` to (target_h, target_w)
    (``tf.image.resize_image_with_crop_or_pad``). Under a width-sharded
    layout ``img`` is of the padded frame's pyramid (the models' crop back
    to the frame), and the crop of the width falls to the edge ranks, each
    keeping its columns inside the target."""
    x = img
    h, w = x.shape[2], x.shape[3]
    if h > target_h:
        off = (h - target_h) // 2
        x = x[:, :, off : off + target_h]
    layout = shard_context.active()
    if layout is not None:
        gw = layout.global_width(w, pyramid=True)
        if gw < target_w:
            raise NotImplementedError("a zero pad of the width under width sharding")
        off = (gw - target_w) // 2
        lo, hi = layout.range(gw)
        x = x[:, :, :, max(lo, off) - lo : min(hi, off + target_w) - lo]
        w = target_w = x.shape[3]
    if w > target_w:
        off = (w - target_w) // 2
        x = x[:, :, :, off : off + target_w]
    ph, pw = target_h - x.shape[2], target_w - x.shape[3]
    if ph > 0 or pw > 0:
        x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    return x


def padded_shape(h: int, w: int, factor: int = 64) -> tuple[int, int]:
    """Next multiple of ``factor`` >= (h, w) (equal stays equal)."""
    nh = h if h % factor == 0 else (h // factor + 1) * factor
    nw = w if w % factor == 0 else (w // factor + 1) * factor
    return nh, nw


def pad_image(img: torch.Tensor, factor: int = 64) -> torch.Tensor:
    """Centred REFLECT pad of NCHW ``img`` so H and W divide ``factor``
    (``diff//2`` before, ``(diff+1)//2`` after). Under a width-sharded
    layout the width's pad falls to the edge ranks, which reflect their
    own columns."""
    h, w = img.shape[2], shard_context.width(img, 3)
    nh, nw = padded_shape(h, w, factor)
    if (nh, nw) == (h, w):
        return img
    ph_l, ph_r = (nh - h) // 2, (nh - h + 1) // 2
    pw_l, pw_r = (nw - w) // 2, (nw - w + 1) // 2
    layout = shard_context.active()
    if layout is not None:
        (lo, hi), (plo, phi) = layout.range(w), layout.range(nw)
        pw_l, pw_r = lo + pw_l - plo, phi - (hi + pw_l)
    return F.pad(img, (pw_l, pw_r, ph_l, ph_r), mode="reflect")
