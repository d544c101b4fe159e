"""Convolution layers with TensorFlow SAME padding (NCHW / OIHW).

Port of ``real_time_self_adaptive_deep_stereo_tpu/ops/conv.py``
(``leaky_relu``, ``init_conv``, ``conv2d``, ``dilated_conv2d``,
``conv2d_transpose``) at its
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

__all__ = ["leaky_relu", "init_conv", "conv2d", "dilated_conv2d", "conv2d_transpose", "same_pad"]


def leaky_relu(alpha: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    """``max(alpha*x, x)``, the form the JAX package uses."""
    return lambda x: torch.maximum(alpha * x, x)


def init_conv(
    generator: torch.Generator,
    kernel_shape: Sequence[int],
    dtype: torch.dtype = torch.float32,
    transpose: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Xavier-uniform weight and zero bias, drawn from ``generator``. The
    weight is OIHW, or for a transposed conv ``[in, out, kh, kw]``
    (``ConvTranspose2d``'s layout), with a bias of ``out`` entries."""
    c0, c1, kh, kw = kernel_shape
    limit = math.sqrt(6.0 / (kh * kw * c0 + kh * kw * c1))
    u = torch.rand(tuple(kernel_shape), generator=generator, dtype=dtype)
    return (2.0 * u - 1.0) * limit, torch.zeros(c1 if transpose else c0, dtype=dtype)


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


def conv2d_transpose(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 2,
    activation: Callable = leaky_relu(0.1),
) -> torch.Tensor:
    """Transposed conv with TF SAME semantics: an output of ``stride``
    times the input. ``weight`` is ``[in, out, kh, kw]``: the JAX
    package's ``[kh, kw, out, in]`` under the same permutation as a
    forward kernel (:func:`..utils.checkpoint.params_from_jax`), not
    flipped. The JAX package flips it because it writes the transpose as
    a forward conv of the dilated input; ``conv_transpose2d`` is the
    transpose itself.

    TF SAME keeps ``(k-1)//2`` of the full output's ``(n-1)*s + k``
    columns before the ``n*s`` it returns; for k = 4, s = 2 that is
    ``conv_transpose2d``'s ``padding=1``. The crop (or, for a kernel
    narrower than the stride, zero extension) is one pad of the full
    output, and the bias comes after it, as in TF."""
    y = F.conv_transpose2d(x, weight, None, stride=stride)
    pads = []
    for n, k, full in ((x.shape[3], weight.shape[3], y.shape[3]), (x.shape[2], weight.shape[2], y.shape[2])):
        before = (k - 1) // 2
        pads += [-before, n * stride + before - full]
    if any(pads):
        y = F.pad(y, pads)
    if bias is not None:
        y = y + bias.view(1, -1, 1, 1)
    return activation(y)
