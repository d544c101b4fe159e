"""Loss library and factories.

Port of ``real_time_self_adaptive_deep_stereo_tpu/losses/factory.py``:
every primitive of its registry with the same primitive order, constants
and quirks (the signed-difference Huber switch, the asymmetric Sobel-y
kernel), and the three factories ``get_supervised_loss``,
``get_proxy_loss`` and ``get_reprojection_loss``, which return closures
``(disparities, inputs) -> loss``. The losses take NHWC tensors as in
JAX; only the image warp, the resize and the Sobel filters run in NCHW.
All are elementwise or small-window functions with no kernel of their
own, apart from the image warp inside the reprojection loss.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from real_time_self_adaptive_deep_stereo_torch.ops.resize import resize_bilinear
from real_time_self_adaptive_deep_stereo_torch.ops.warp_kernels import warp_image_by_mode

__all__ = [
    "SUPERVISED_LOSS",
    "PIXELWISE_LOSSES",
    "ALL_LOSSES",
    "SSIM",
    "SSIM_ALPHA",
    "get_supervised_loss",
    "get_proxy_loss",
    "get_reprojection_loss",
    "l1",
    "mean_SSIM_L1",
]


def _ones_mask(x, mask):
    return torch.ones_like(x) if mask is None else mask


def l1(x, y, mask=None):
    return _ones_mask(x, mask) * torch.abs(x - y)


def l2(x, y, mask=None):
    return _ones_mask(x, mask) * torch.square(x - y)


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


def mean_l1(x, y, mask=None):
    if x.dim() == 4:
        x, y = _flat(x), _flat(y)
        mask = None if mask is None else _flat(mask)
    mask = _ones_mask(x, mask)
    return torch.sum(mask * torch.abs(x - y)) / torch.sum(mask)


def mean_l2(x, y, mask=None):
    mask = _ones_mask(x, mask)
    return torch.sum(mask * torch.square(x - y)) / torch.sum(mask)


def sum_l1(x, y, mask=None):
    return torch.sum(_ones_mask(x, mask) * torch.abs(x - y))


def sum_l2(x, y, mask=None):
    return torch.sum(_ones_mask(x, mask) * torch.square(x - y))


def huber(x, y, c=1.0):
    diff = x - y
    # the reference switches on the *signed* difference (loss_factory.py:57)
    return torch.where(diff > c, 0.5 * c**2 + c * (torch.abs(diff) - c), 0.5 * torch.square(diff))


def mean_huber(x, y, mask=None):
    return torch.mean(huber(x, y) * _ones_mask(x, mask))


def sum_huber(x, y, mask=None):
    return torch.sum(huber(x, y) * _ones_mask(x, mask))


def zncc(x, y):
    nx = x - torch.mean(x)
    ny = y - torch.mean(y)
    vx = torch.sqrt(torch.sum(torch.square(nx)))
    vy = torch.sqrt(torch.sum(torch.square(ny)))
    return 1.0 - torch.sum(nx * ny) / (vx * vy)


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


def ssim_l1(x, y, alpha=SSIM_ALPHA):
    ss = F.pad(SSIM(x, y), (0, 0, 1, 1, 1, 1))  # NHWC: one pixel around H and W
    return alpha * ss + (1 - alpha) * l1(x, y)


def mean_SSIM(x, y):
    return _ssim_mean_flat(_flat(x), _flat(y), x.shape[-1])


def mean_SSIM_L1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    xf, yf = _flat(x), _flat(y)
    ss = _ssim_mean_flat(xf, yf, x.shape[-1])
    return SSIM_ALPHA * ss + (1 - SSIM_ALPHA) * torch.mean(torch.abs(xf - yf))


def sign_and_elementwise(x, y):
    element_wise_sign = torch.sigmoid(10 * (torch.sign(x) * torch.sign(y)))
    return torch.mean(torch.sigmoid(element_wise_sign))


def cos_similarity(x, y, normalize=False):
    if normalize:
        x = x / torch.linalg.norm(x)
        y = y / torch.linalg.norm(y)
    return torch.sum(x * y)


_SOBEL_X = [[1.0, 0.0, -1.0], [2.0, 0.0, -2.0], [1.0, 0.0, -1.0]]
# Kept verbatim from the reference (loss_factory.py:198), including the
# asymmetric first row.
_SOBEL_Y = [[1.0, 2.0, -1.0], [0.0, 0.0, 0.0], [-1.0, -2.0, -1.0]]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _sobel(img: torch.Tensor, k) -> torch.Tensor:
    """3x3 depthwise SAME cross-correlation of NHWC ``img`` with ``k``."""
    c = img.shape[-1]
    kern = torch.tensor(k, dtype=img.dtype, device=img.device).expand(c, 1, 3, 3)
    return F.conv2d(_nchw(img), kern, padding=1, groups=c).permute(0, 2, 3, 1)


def smoothness(x, y):
    """Edge-aware disparity smoothness (loss_factory.py:183-220)."""
    x = x / 255.0
    y = y / 255.0
    dgx = _sobel(x, _SOBEL_X)
    dgy = _sobel(x, _SOBEL_Y)
    igx = torch.mean(_sobel(y, _SOBEL_X), dim=-1, keepdim=True)
    igy = torch.mean(_sobel(y, _SOBEL_Y), dim=-1, keepdim=True)
    wx = torch.exp(-torch.abs(igx))
    wy = torch.exp(-torch.abs(igy))
    return torch.mean(torch.abs(dgx) * wx + torch.abs(dgy) * wy)


# registries (loss_factory.py:230-253)
SUPERVISED_LOSS: Dict[str, Callable] = {
    "mean_l1": mean_l1,
    "sum_l1": sum_l1,
    "mean_l2": mean_l2,
    "sum_l2": sum_l2,
    "mean_SSIM": mean_SSIM,
    "mean_SSIM_l1": mean_SSIM_L1,
    "ZNCC": zncc,
    "cos_similarity": cos_similarity,
    "smoothness": smoothness,
    "mean_huber": mean_huber,
    "sum_huber": sum_huber,
}

PIXELWISE_LOSSES: Dict[str, Callable] = {
    "l1": l1,
    "l2": l2,
    "SSIM": SSIM,
    "huber": huber,
    "ssim_l1": ssim_l1,
}

ALL_LOSSES: Dict[str, Callable] = {**SUPERVISED_LOSS, **PIXELWISE_LOSSES}


def _resolve(name: str) -> Callable:
    if name not in ALL_LOSSES:
        raise KeyError(f"Unknown loss {name!r}; pick one of {sorted(ALL_LOSSES)}")
    return ALL_LOSSES[name]


def _resize_to_nhwc(cur: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """NHWC ``cur`` resized to the spatial shape of NHWC ``like``."""
    return resize_bilinear(_nchw(cur), like.shape[1], like.shape[2]).permute(0, 2, 3, 1)


def _target_loss(base, weights, multiScale, reduced, label_key, invalid):
    """Closure shared by the supervised and proxy factories: predictions
    are iterated finest-first, each resized to the target resolution and
    scaled by the width ratio, and compared with ``inputs[label_key]``
    where ``invalid(label)`` is false."""

    def compute_loss(disparities: List[torch.Tensor], inputs: dict):
        left = inputs["left"]
        targets = inputs["target"]
        labels = inputs[label_key]
        n = len(disparities) if multiScale else 1
        valid = torch.where(invalid(labels), 0.0, 1.0).to(torch.float32)
        acc = []
        for i in range(n):
            cur = disparities[-(i + 1)]
            scale = left.shape[2] / cur.shape[2]
            resized = _resize_to_nhwc(cur, targets) * scale
            acc.append(weights[i] * base(resized, labels, valid))
        return torch.stack(acc).sum() if reduced else acc

    return compute_loss


def get_supervised_loss(
    name: str,
    multiScale: bool = False,
    weights: Optional[Sequence[float]] = None,
    reduced: bool = True,
    max_disp: Optional[float] = None,
):
    """GT-supervised loss closure (loss_factory.py:256-302). Valid pixels:
    ``0 < target < max_disp``."""
    weights = [1.0] * 10 if weights is None else list(weights)
    max_disp = 1000.0 if max_disp is None else max_disp
    return _target_loss(
        _resolve(name), weights, multiScale, reduced, "target",
        lambda t: (t == 0) | (t >= max_disp),
    )


def get_proxy_loss(
    name: str,
    multiScale: bool = False,
    weights: Optional[Sequence[float]] = None,
    reduced: bool = True,
    max_disp: Optional[float] = None,
):
    """Proxy-label loss closure (loss_factory.py:304-351). Valid pixels:
    ``0 < proxy < 192`` (the 192 is hard-coded in the reference whatever
    ``max_disp`` says); default weights 0.01."""
    weights = [0.01] * 10 if weights is None else list(weights)
    return _target_loss(
        _resolve(name), weights, multiScale, reduced, "proxy",
        lambda p: (p <= 0) | (p >= 192),
    )


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
