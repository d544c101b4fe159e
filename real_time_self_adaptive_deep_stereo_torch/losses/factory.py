"""Photometric reprojection loss (the subset of the loss library that the
online session runs).

Port of ``real_time_self_adaptive_deep_stereo_tpu/losses/factory.py``:
``l1``, ``_flat``, ``_pool3_flat``, ``_ssim_mean_flat``, ``SSIM``,
``mean_SSIM_L1``, ``SSIM_ALPHA`` and ``get_reprojection_loss``, with
the same primitive order and constants. The losses take NHWC tensors as
in JAX; only the image warp runs in NCHW. The rest of the registry
(supervised and proxy losses, smoothness, ...) waits for ROADMAP.md,
modules to port, item 3.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from real_time_self_adaptive_deep_stereo_torch.ops.resize import resize_bilinear
from real_time_self_adaptive_deep_stereo_torch.ops.warp_kernels import warp_image_by_mode

__all__ = ["ALL_LOSSES", "SSIM", "SSIM_ALPHA", "get_reprojection_loss", "l1", "mean_SSIM_L1"]


def l1(x, y, mask=None):
    return (torch.ones_like(x) if mask is None else mask) * torch.abs(x - y)


def _flat(x: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] -> [B,H,W*C]."""
    b, h, w, c = x.shape
    return x.reshape(b, h, w * c)


def _pool3_flat(xf: torch.Tensor, c: int) -> torch.Tensor:
    """3x3 stride-1 VALID mean pool on the flat layout: the W taps are
    slices shifted by ±C in the merged minor dim."""
    n = xf.shape[2]
    a = (xf[:, :, : n - 2 * c] + xf[:, :, c : n - c] + xf[:, :, 2 * c :]) * (1.0 / 3.0)
    return (a[:, :-2] + a[:, 1:-1] + a[:, 2:]) * (1.0 / 3.0)


def _ssim_terms(mu_x, mu_y, sigma_x, sigma_y, sigma_xy):
    c1 = 0.01**2
    c2 = 0.03**2
    n = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    d = (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
    return torch.clamp((1.0 - n / d) / 2.0, 0.0, 1.0)


def _ssim_mean_flat(xf: torch.Tensor, yf: torch.Tensor, c: int) -> torch.Tensor:
    """Mean of the clipped (1-SSIM)/2 map, in the flat layout."""
    mu_x = _pool3_flat(xf, c)
    mu_y = _pool3_flat(yf, c)
    sigma_x = _pool3_flat(xf * xf, c) - mu_x**2
    sigma_y = _pool3_flat(yf * yf, c) - mu_y**2
    sigma_xy = _pool3_flat(xf * yf, c) - mu_x * mu_y
    return torch.mean(_ssim_terms(mu_x, mu_y, sigma_x, sigma_y, sigma_xy))


def _avg_pool3_valid(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 VALID mean pool over NHWC, as two separable 3-taps."""
    y = (x[:, :-2] + x[:, 1:-1] + x[:, 2:]) * (1.0 / 3.0)
    return (y[:, :, :-2] + y[:, :, 1:-1] + y[:, :, 2:]) * (1.0 / 3.0)


def SSIM(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Clipped (1-SSIM)/2 over 3x3 VALID windows (NHWC)."""
    mu_x = _avg_pool3_valid(x)
    mu_y = _avg_pool3_valid(y)
    sigma_x = _avg_pool3_valid(x**2) - mu_x**2
    sigma_y = _avg_pool3_valid(y**2) - mu_y**2
    sigma_xy = _avg_pool3_valid(x * y) - mu_x * mu_y
    return _ssim_terms(mu_x, mu_y, sigma_x, sigma_y, sigma_xy)


# the SSIM/L1 mix of mean_SSIM_l1
SSIM_ALPHA = 0.85


def mean_SSIM_L1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    xf, yf = _flat(x), _flat(y)
    ss = _ssim_mean_flat(xf, yf, x.shape[-1])
    return SSIM_ALPHA * ss + (1 - SSIM_ALPHA) * torch.mean(torch.abs(xf - yf))


ALL_LOSSES: Dict[str, Callable] = {"mean_SSIM_l1": mean_SSIM_L1, "l1": l1, "SSIM": SSIM}


def _resolve(name: str) -> Callable:
    if name not in ALL_LOSSES:
        raise KeyError(
            f"Loss {name!r} is not ported yet (ROADMAP.md, modules to port, item 3); "
            f"ported: {sorted(ALL_LOSSES)}"
        )
    return ALL_LOSSES[name]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def get_reprojection_loss(
    reconstruction_loss: str,
    multiScale: bool = False,
    weights: Optional[Sequence[float]] = None,
    reduced: bool = True,
    warp_mode: str = "auto",
    warp_max_disp: int = 192,
):
    """Unsupervised photometric loss closure ``(disparities, inputs) -> loss``.

    Normalises images by /256, rescales each prediction to image
    resolution (times the width ratio), warps the right image by it and
    compares with the left via ``reconstruction_loss``. ``warp_mode`` is
    resolved per call from the image's device (:func:`..ops.warp.resolve_warp_mode`).
    """
    base = _resolve(reconstruction_loss)
    weights = [1.0] * 10 if weights is None else list(weights)

    def compute_loss(disparities: List[torch.Tensor], inputs: dict) -> torch.Tensor:
        left = inputs["left"].float() / 256.0
        right = _nchw(inputs["right"].float() / 256.0)
        n = len(disparities) if multiScale else 1
        acc = []
        for i in range(n):
            cur = disparities[-(i + 1)]
            scale = left.shape[2] / cur.shape[2]
            resized = resize_bilinear(_nchw(cur), left.shape[1], left.shape[2]) * scale
            reproj = warp_image_by_mode(right, resized, warp_mode, warp_max_disp)
            acc.append(weights[i] * base(reproj.permute(0, 2, 3, 1), left))
        return torch.stack(acc).sum() if reduced else acc

    return compute_loss
