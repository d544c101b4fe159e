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

A fresh random-weight MADNet produces disparities beyond the windows, so
every comparison pins the mode.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "warp_image",
    "warp_features_horizontal",
    "warp_image_clamped",
    "warp_features_clamped",
    "warp_image_clamped_bwd",
    "warp_features_clamped_bwd",
    "resolve_warp_mode",
    "WARP_MODES",
]

WARP_MODES = ("auto", "gather", "clamped", "cuda")


def resolve_warp_mode(mode: str, device: torch.device) -> str:
    """``auto`` is ``gather`` on the CPU (as JAX resolves it off the TPU)
    and ``cuda``, the clamped-window kernels, on a CUDA device."""
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
