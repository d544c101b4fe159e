"""Convolution layers with TensorFlow SAME padding (NCHW / OIHW).

Port of ``real_time_self_adaptive_deep_stereo_tpu/ops/conv.py``
(``leaky_relu``, ``init_conv``, ``conv2d``, ``dilated_conv2d``) at its
default precision, ``highest``: fp32 convolutions on cuDNN with TF32 off
(see ``utils/device.py``). The other precision modes come later.

TF SAME padding splits the total pad ``max((out-1)*s + k_eff - in, 0)``
as ``total//2`` before and the rest after, so at stride 2 on an even
input the extra pixel goes to the bottom and right. PyTorch's
``padding=1`` would put it on both sides and shift every pyramid level
by one pixel, so the pad is applied explicitly before a ``padding=0``
convolution.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["leaky_relu", "init_conv", "conv2d", "dilated_conv2d", "same_pad"]


def leaky_relu(alpha: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    """``max(alpha*x, x)``, the form the JAX package uses."""
    return lambda x: torch.maximum(alpha * x, x)


def init_conv(
    generator: torch.Generator,
    kernel_shape: Sequence[int],
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Xavier-uniform OIHW weight and zero bias, drawn from ``generator``."""
    cout, cin, kh, kw = kernel_shape
    limit = math.sqrt(6.0 / (kh * kw * cin + kh * kw * cout))
    u = torch.rand(tuple(kernel_shape), generator=generator, dtype=dtype)
    return (2.0 * u - 1.0) * limit, torch.zeros(cout, dtype=dtype)


def _same_1d(size: int, k: int, stride: int, rate: int) -> Tuple[int, int]:
    k_eff = (k - 1) * rate + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + k_eff - size, 0)
    return total // 2, total - total // 2


def same_pad(x: torch.Tensor, k: Tuple[int, int], stride: int = 1, rate: int = 1):
    """Zero-pad NCHW ``x`` as TF SAME padding does for a ``k`` kernel."""
    top, bottom = _same_1d(x.shape[2], k[0], stride, rate)
    left, right = _same_1d(x.shape[3], k[1], stride, rate)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return x


def _conv(x, weight, bias, stride, rate, activation, padding):
    if padding == "SAME":
        x = same_pad(x, weight.shape[2:], stride, rate)
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    return activation(F.conv2d(x, weight, bias, stride=stride, dilation=rate))


def conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    activation: Callable = leaky_relu(0.1),
    padding: str = "SAME",
) -> torch.Tensor:
    """``activation(conv(x, weight) + bias)``; x NCHW, weight OIHW."""
    return _conv(x, weight, bias, stride, 1, activation, padding)


def dilated_conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    rate: int = 1,
    activation: Callable = leaky_relu(0.1),
    padding: str = "SAME",
) -> torch.Tensor:
    """Stride-1 atrous conv; SAME with rate r pads (k-1)*r/2 each side."""
    return _conv(x, weight, bias, 1, rate, activation, padding)
