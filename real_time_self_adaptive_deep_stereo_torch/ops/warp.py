"""Horizontal disparity warps (NCHW images, [B,1,H,W] offsets).

Port of ``real_time_self_adaptive_deep_stereo_tpu/ops/warp.py``. Two
sampling semantics, which must not be conflated:

1. :func:`warp_image` (loss path): samples at ``x - disp`` with bilinear
   weights from the unclamped coordinate and gathers at clamped indices,
   i.e. clamp-to-edge.
2. :func:`warp_features_horizontal` (feature warp inside MADNet): samples
   at ``x + dx``; a corner whose index falls outside [0, W-1] gets zero
   weight.

Each exists in two forms that differ for out-of-range offsets:

* ``gather``: the unclamped forms above, the TF-parity behaviour.
* ``clamped``: the offset is first clipped to a static window
  (``[0, max_disp]`` for images, ``[-max_neg, max_pos]`` for features).
  These are the semantics of the JAX ``warp_image_shift`` and
  ``warp_features_horizontal_shift`` and of the Pallas kernels, and
  equal clip-then-gather. :func:`warp_image_clamped` and
  :func:`warp_features_clamped` are the plain versions of the CUDA
  kernels in :mod:`.warp_kernels`, and autograd through them, as
  :func:`warp_image_clamped_bwd` and :func:`warp_features_clamped_bwd`,
  is the plain version of the backward kernels. ``torch.clamp`` passes
  the gradient at an offset exactly on a clip bound, as the Pallas
  kernels' inclusive masks do (``jnp.clip`` in the JAX shift forms halves
  it there).

* ``onehot``: the clamped semantics as a product with a sampling matrix,
  :func:`warp_image_onehot` and :func:`warp_features_onehot`. For each
  chunk of output columns, ``M[x, v] = w0[x]*[v == i0[x]] + w1[x]*[v == i1[x]]``
  is built from compares and contracted with the chunk's source window.
  With ``align=128`` the row is first padded with zero columns to a
  multiple of 128 and the indices are clamped to the padded width: that is
  what the tiled kernels of ``csrc/warp_tile.cu`` compute (as the Pallas
  kernels ``_mxu_fwd_kernel`` / ``_mxu_bwd_kernel`` do), so these are
  their plain versions, and autograd through them
  (:func:`warp_image_onehot_bwd`, :func:`warp_features_onehot_bwd`) is the
  plain version of the tiled backward kernel. Padding changes no output
  value and one gradient entry: at a disparity of exactly 0 in the last
  column of an image whose width is no multiple of 128, the second tap
  reads a zero pad column instead of the edge, so ``ddisp`` there is
  ``g*v0`` and not 0.

A fresh random-weight MADNet produces disparities beyond the windows, so
every comparison pins the mode.

:func:`bilinear_sampler` is the general 2-D bilinear sampler of the JAX
package (clamp-to-edge, for parity and generic flows); no model calls it.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "warp_image",
    "warp_features_horizontal",
    "warp_image_clamped",
    "warp_features_clamped",
    "warp_image_clamped_bwd",
    "warp_features_clamped_bwd",
    "warp_image_onehot",
    "warp_features_onehot",
    "warp_image_onehot_bwd",
    "warp_features_onehot_bwd",
    "bilinear_sampler",
    "resolve_warp_mode",
    "WARP_MODES",
]

WARP_MODES = ("auto", "gather", "clamped", "cuda", "onehot", "mxu")
TILE = 128  # output columns per tile of the tiled kernels (``mxu``)


def resolve_warp_mode(mode: str, device: torch.device) -> str:
    """``auto`` is ``gather`` on the CPU (as JAX resolves it off the TPU)
    and ``cuda``, the clamped-window kernels, on a CUDA device. ``mxu``
    (the tiled one-hot kernels) and ``onehot`` (their plain versions, on
    any device) are taken only when named."""
    if mode not in WARP_MODES:
        raise ValueError(f"unknown warp mode {mode!r}; choose from {WARP_MODES}")
    if mode == "auto":
        return "cuda" if device.type == "cuda" else "gather"
    return mode


def _gather_w(img: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """img[b, c, h, ix[b, 0, h, w]] for integer ix of shape [B,1,H,W]."""
    return torch.gather(img, 3, ix.expand(-1, img.shape[1], -1, -1))


def warp_image(img: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Clamp-to-edge warp of ``img`` at ``x - disp`` (gather form)."""
    w = img.shape[3]
    xs = torch.arange(w, dtype=torch.float32, device=img.device)
    cx = xs - disp
    x0 = torch.floor(cx)
    wt1 = cx - x0
    wt0 = 1.0 - wt1
    x0i = torch.clamp(x0, 0, w - 1).long()
    x1i = torch.clamp(x0 + 1, 0, w - 1).long()
    return wt0 * _gather_w(img, x0i) + wt1 * _gather_w(img, x1i)


def warp_features_horizontal(feats: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """Warp ``feats`` at ``x + dx``, out-of-range corners weighted zero
    (gather form)."""
    w = feats.shape[3]
    xs = torch.arange(w, dtype=torch.float32, device=feats.device)
    cx = xs + dx
    x0 = torch.floor(cx)
    x1 = x0 + 1
    in0 = ((x0 >= 0) & (x0 <= w - 1)).float()
    in1 = ((x1 >= 0) & (x1 <= w - 1)).float()
    wt0 = (x1 - cx) * in0
    wt1 = (cx - x0) * in1
    x0i = torch.clamp(x0, 0, w - 1).long()
    x1i = torch.clamp(x1, 0, w - 1).long()
    return wt0 * _gather_w(feats, x0i) + wt1 * _gather_w(feats, x1i)


def warp_image_clamped(img: torch.Tensor, disp: torch.Tensor, max_disp: int = 192) -> torch.Tensor:
    """Plain version of the image-warp kernel: ``disp`` clipped to
    ``[0, max_disp]``, then :func:`warp_image`."""
    return warp_image(img, torch.clamp(disp, 0.0, float(max_disp)))


def warp_features_clamped(
    feats: torch.Tensor, dx: torch.Tensor, max_neg: int = 64, max_pos: int = 4
) -> torch.Tensor:
    """Plain version of the feature-warp kernel: ``dx`` clipped to
    ``[-max_neg, max_pos]``, then :func:`warp_features_horizontal`."""
    return warp_features_horizontal(feats, torch.clamp(dx, -float(max_neg), float(max_pos)))


def _pad_columns(t: torch.Tensor, align: int) -> torch.Tensor:
    """Zero columns on the right, up to a multiple of ``align``."""
    pad = (-t.shape[3]) % align
    return F.pad(t, (0, pad)) if pad else t


def _onehot_contract(srcpad, w0, w1, i0, i1, halo: int, chunk: int) -> torch.Tensor:
    """``out[b,c,h,x] = sum_v M[b,h,x,v] * srcpad[b,c,h,v]`` chunk by chunk.
    ``w*`` and ``i*`` are [B,1,H,W]; ``i*`` index ``srcpad``'s columns, and
    the window of chunk ``[s, s+cw)`` is ``srcpad[..., s : s+cw+halo]``."""
    w = w0.shape[3]
    outs = []
    for start in range(0, w, chunk):
        cw = min(chunk, w - start)
        cols = slice(start, start + cw)
        win = srcpad[..., start : start + cw + halo]
        vidx = torch.arange(cw + halo, dtype=torch.float32, device=srcpad.device) + start
        sel0 = (vidx == i0[:, 0, :, cols, None]).to(srcpad.dtype)
        sel1 = (vidx == i1[:, 0, :, cols, None]).to(srcpad.dtype)
        m = w0[:, 0, :, cols, None] * sel0 + w1[:, 0, :, cols, None] * sel1
        outs.append(torch.einsum("bhxv,bchv->bchx", m, win))
    return torch.cat(outs, dim=3)


def warp_image_onehot(
    img: torch.Tensor, disp: torch.Tensor, max_disp: int = 192, chunk: int = TILE, align: int = 1
) -> torch.Tensor:
    """Matrix-product form of :func:`warp_image_clamped` (fp32 out)."""
    w_out = img.shape[3]
    img, disp = _pad_columns(img.float(), align), _pad_columns(disp, align)
    w, s = img.shape[3], int(max_disp)
    # s edge columns on the left, as the JAX one-hot form has them (the
    # clamped indices never reach them), and one on the right: at a
    # disparity of exactly 0 the second tap of a chunk's last column is the
    # next chunk's first, and its weight of 0 still carries a gradient
    imgpad = torch.cat([img[..., :1].expand(-1, -1, -1, s), img, img[..., -1:]], dim=3)
    xs = torch.arange(w, dtype=torch.float32, device=img.device)
    cx = xs - torch.clamp(disp, 0.0, float(s))
    x0 = torch.floor(cx)
    w1 = cx - x0
    w0 = 1.0 - w1
    i0 = torch.clamp(x0, 0, w - 1) + s
    i1 = torch.clamp(x0 + 1, 0, w - 1) + s
    return _onehot_contract(imgpad, w0, w1, i0, i1, s + 1, chunk)[..., :w_out]


def warp_features_onehot(
    feats: torch.Tensor,
    dx: torch.Tensor,
    max_neg: int = 64,
    max_pos: int = 4,
    chunk: int = TILE,
    align: int = 1,
) -> torch.Tensor:
    """Matrix-product form of :func:`warp_features_clamped` (fp32 out)."""
    w_out = feats.shape[3]
    feats, dx = _pad_columns(feats.float(), align), _pad_columns(dx, align)
    w = feats.shape[3]
    npad, ppad = min(int(max_neg), w), min(int(max_pos) + 1, w)
    fpad = F.pad(feats, (npad, ppad))
    xs = torch.arange(w, dtype=torch.float32, device=feats.device)
    cx = xs + torch.clamp(dx, -float(max_neg), float(max_pos))
    x0 = torch.floor(cx)
    x1 = x0 + 1
    in0 = ((x0 >= 0) & (x0 <= w - 1)).float()
    in1 = ((x1 >= 0) & (x1 <= w - 1)).float()
    w0 = (x1 - cx) * in0
    w1 = (cx - x0) * in1
    i0 = torch.clamp(x0, 0, w - 1) + npad
    i1 = torch.clamp(x1, 0, w - 1) + npad
    return _onehot_contract(fpad, w0, w1, i0, i1, npad + ppad, chunk)[..., :w_out]


def _vjp(fn, src: torch.Tensor, off: torch.Tensor, g: torch.Tensor):
    src = src.detach().requires_grad_()
    off = off.detach().requires_grad_()
    with torch.enable_grad():
        out = fn(src, off)
    return torch.autograd.grad(out, (src, off), g)


def warp_image_clamped_bwd(
    img: torch.Tensor, disp: torch.Tensor, g: torch.Tensor, max_disp: int = 192
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the image-warp backward kernel: ``(dimg, ddisp)``
    for the gradient ``g`` of :func:`warp_image_clamped`'s output."""
    return _vjp(lambda i, d: warp_image_clamped(i, d, max_disp), img, disp, g)


def warp_features_clamped_bwd(
    feats: torch.Tensor, dx: torch.Tensor, g: torch.Tensor, max_neg: int = 64, max_pos: int = 4
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the feature-warp backward kernel: ``(dfeats, ddx)``
    for the gradient ``g`` of :func:`warp_features_clamped`'s output."""
    return _vjp(lambda f, d: warp_features_clamped(f, d, max_neg, max_pos), feats, dx, g)


def warp_image_onehot_bwd(
    img: torch.Tensor, disp: torch.Tensor, g: torch.Tensor, max_disp: int = 192, align: int = TILE
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the tiled image-warp backward kernel: ``(dimg,
    ddisp)`` for the gradient ``g`` of :func:`warp_image_onehot`'s output."""
    return _vjp(lambda i, d: warp_image_onehot(i, d, max_disp, align=align), img, disp, g)


def warp_features_onehot_bwd(
    feats: torch.Tensor,
    dx: torch.Tensor,
    g: torch.Tensor,
    max_neg: int = 64,
    max_pos: int = 4,
    align: int = TILE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the tiled feature-warp backward kernel: ``(dfeats,
    ddx)`` for the gradient ``g`` of :func:`warp_features_onehot`'s output."""
    return _vjp(
        lambda f, d: warp_features_onehot(f, d, max_neg, max_pos, align=align), feats, dx, g
    )


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Full 2-D bilinear sampling of NCHW ``img`` at ``coords``
    [B,2,H,W] = (x, y): weights from the unclamped coordinates, indices
    clamped to the image, as the JAX package's ``bilinear_sampler``
    (NHWC ``coords`` [B,H,W,2] there)."""
    b, c, h, w = img.shape
    cx, cy = coords[:, 0], coords[:, 1]
    x0, y0 = torch.floor(cx), torch.floor(cy)
    wx1, wy1 = cx - x0, cy - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    x0i, x1i = (torch.clamp(v, 0, w - 1).long() for v in (x0, x0 + 1))
    y0i, y1i = (torch.clamp(v, 0, h - 1).long() for v in (y0, y0 + 1))
    flat = img.reshape(b, c, h * w)

    def gather(yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        idx = (yi * w + xi).reshape(b, 1, h * w).expand(b, c, h * w)
        return torch.gather(flat, 2, idx).reshape(b, c, h, w)

    return (
        (wx0 * wy0)[:, None] * gather(y0i, x0i)
        + (wx0 * wy1)[:, None] * gather(y1i, x0i)
        + (wx1 * wy0)[:, None] * gather(y0i, x1i)
        + (wx1 * wy1)[:, None] * gather(y1i, x1i)
    )
