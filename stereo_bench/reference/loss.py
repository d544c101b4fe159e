"""The photometric loss the online adaptation minimises (``mean_SSIM_l1``).

The right image is warped by the predicted disparity onto the left one
and compared with it: ``0.85 * mean((1 - SSIM) / 2)`` over 3x3 windows
(VALID, the map clipped to [0, 1]) plus ``0.15 * mean |warped - left|``,
on images divided by 256. The prediction is first resized to the image
and scaled by the width ratio. (Tonioni et al., CVPR 2019; the reference's
``loss_factory.py``.)
"""

from __future__ import annotations

import torch

from stereo_bench.reference import ops

SSIM_ALPHA = 0.85
C1, C2 = 0.01**2, 0.03**2


def _pool3(x):
    """3x3 VALID mean over NHWC ``x``."""
    y = (x[:, :-2] + x[:, 1:-1] + x[:, 2:]) / 3.0
    return (y[:, :, :-2] + y[:, :, 1:-1] + y[:, :, 2:]) / 3.0


def mean_ssim_l1(x, y):
    mx, my = _pool3(x), _pool3(y)
    sx = _pool3(x * x) - mx * mx
    sy = _pool3(y * y) - my * my
    sxy = _pool3(x * y) - mx * my
    ssim = ((2 * mx * my + C1) * (2 * sxy + C2)) / ((mx * mx + my * my + C1) * (sx + sy + C2))
    dssim = torch.clamp((1.0 - ssim) / 2.0, 0.0, 1.0)
    return SSIM_ALPHA * dssim.mean() + (1 - SSIM_ALPHA) * (x - y).abs().mean()


def reprojection_loss(disp, left, right, max_disp: int = 192):
    """Loss of NHWC disparity ``disp`` ([B, h, w, 1]) on NHWC images in
    0..255."""
    left = left / 256.0
    right = (right / 256.0).permute(0, 3, 1, 2)
    h, w = left.shape[1], left.shape[2]
    d = ops.resize(disp.permute(0, 3, 1, 2), h, w) * (w / disp.shape[2])
    warped = ops.warp_image(right, d, max_disp).permute(0, 2, 3, 1)
    return mean_ssim_l1(warped, left)
