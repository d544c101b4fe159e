"""Convolution layers with TensorFlow SAME padding (NCHW / OIHW).

Port of ``real_time_self_adaptive_deep_stereo_tpu/ops/conv.py``
(``leaky_relu``, ``init_conv``, ``conv2d``, ``dilated_conv2d``,
``conv2d_transpose``, ``depthwise_conv``, ``separable_conv2d``,
``grouped_conv2d``, ``channel_shuffle_inside_group``) with its four
precision modes, set globally by :func:`set_conv_precision` as in JAX:

* ``highest`` (the default): fp32 convolutions, on cuDNN with TF32 off;
* ``default``: fp32 operands, TF32 on cuDNN, which is what JAX's
  ``Precision.DEFAULT`` is on a GPU; fp32 on the CPU, as in JAX;
* ``bf16``: operands cast to bf16 (the weight per call, so that the fp32
  master weights take the gradient), fp32 accumulation, the convolution's
  output rounded to bf16 and widened again, and the bias and activation in
  fp32;
* ``bf16_act``: the same, with the bias and activation in bf16 whatever
  the input's dtype, so that the activations between convolutions are
  bf16.

The TF32 flags follow the mode (:func:`apply_precision_flags`, also run by
``utils/device.py::resolve_device``); cuBLAS matmuls stay fp32 in every
mode, as the JAX resize's ``precision="highest"`` matmuls do.

TF SAME padding splits the total pad ``max((out-1)*s + k_eff - in, 0)``
as ``total//2`` before and the rest after, so at stride 2 on an even
input the extra pixel goes to the bottom and right. PyTorch's
``padding=1`` would put it on both sides and shift every pyramid level
by one pixel, so the pad is applied explicitly before a ``padding=0``
convolution.

Under a width-sharded layout (:mod:`..parallel.spatial`) a SAME
convolution runs on the rank's columns: the pad along W becomes the
columns of the neighbours that the rank's outputs read (zeros beyond the
frame), fetched from them, and the convolution is VALID along W. A
transposed convolution fetches the input columns that reach the rank's
output columns and crops its full output to them.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from real_time_self_adaptive_deep_stereo_torch.ops import shard_context

__all__ = [
    "leaky_relu", "init_conv", "conv2d", "dilated_conv2d", "conv2d_transpose", "same_pad",
    "depthwise_conv", "separable_conv2d", "grouped_conv2d", "channel_shuffle_inside_group",
    "PRECISIONS", "set_conv_precision", "get_conv_precision", "conv_precision",
    "apply_precision_flags",
]

PRECISIONS = ("highest", "default", "bf16", "bf16_act")
_PRECISION = "highest"


def apply_precision_flags() -> None:
    """Set PyTorch's TF32 flags from the mode: cuDNN's on under
    ``default`` only, cuBLAS's always off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = _PRECISION == "default"


def set_conv_precision(p: str) -> None:
    """Set the global convolution precision, one of :data:`PRECISIONS`
    (the JAX package's strings), and the TF32 flags that go with it."""
    global _PRECISION
    if p not in PRECISIONS:
        raise ValueError(f"unknown conv precision {p!r}; one of {PRECISIONS}")
    _PRECISION = p
    apply_precision_flags()


def get_conv_precision() -> str:
    return _PRECISION


@contextlib.contextmanager
def conv_precision(p: str) -> Iterator[None]:
    """Run a block under precision ``p`` and restore the previous mode."""
    prev = _PRECISION
    set_conv_precision(p)
    try:
        yield
    finally:
        set_conv_precision(prev)


def _bf16_epilogue(x: torch.Tensor) -> Optional[torch.dtype]:
    """Under ``bf16`` and ``bf16_act``, the dtype of the bias and
    activation (JAX ``_epilogue_dtype``): bf16 under ``bf16_act``, else the
    input's. None in the fp32 modes."""
    if _PRECISION == "bf16_act":
        return torch.bfloat16
    return x.dtype if _PRECISION == "bf16" else None


def leaky_relu(alpha: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    """``max(alpha*x, x)``, the form the JAX package uses. On a bf16 ``x``
    the slope is rounded to bf16 first (0.2 becomes 0.2001953125), as
    JAX's weak-typed scalar is; PyTorch would keep it in fp32."""
    alpha_bf16 = float(torch.tensor(alpha, dtype=torch.bfloat16))
    return lambda x: torch.maximum((alpha_bf16 if x.dtype == torch.bfloat16 else alpha) * x, x)


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
    """Zero-pad NCHW ``x`` as TF SAME padding does for a ``k`` kernel.
    Under a width-sharded layout the W pad is the neighbours' halo
    (:func:`_same_halo`)."""
    top, bottom = _same_1d(x.shape[2], k[0], stride, rate)
    layout = shard_context.active()
    if layout is not None:
        x = _same_halo(layout, x, k[1], stride, rate)
        left = right = 0
    else:
        left, right = _same_1d(x.shape[3], k[1], stride, rate)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return x


def _same_halo(layout, x: torch.Tensor, k: int, stride: int, rate: int) -> torch.Tensor:
    """The rank's columns of NCHW ``x`` with the halo a SAME convolution
    of its output columns reads: output column j reads the input columns
    ``j*stride - left .. j*stride - left + k_eff - 1`` of the global
    width, ``left`` the SAME split's; a VALID convolution of the result
    gives the rank's output columns. A convolution takes the padded
    frame's pyramid, never the frame."""
    w = layout.global_width(x.shape[3], pyramid=True)
    left, _ = _same_1d(w, k, stride, rate)
    k_eff = (k - 1) * rate + 1
    spans = [(lo * stride - left, (hi - 1) * stride - left + k_eff) for lo, hi in layout.ranges(-(-w // stride))]
    return layout.fetch(x, 3, layout.ranges(w), spans, f"conv k{k_eff} s{stride}")


def _transpose_halo(layout, x: torch.Tensor, k: int, stride: int):
    """The input columns that reach the rank's output columns of a TF SAME
    transposed convolution of NCHW ``x`` (the rank's columns of global
    width w; the output's width ``w * stride`` is a level of the layout),
    and the pad, negative a crop, of the full output of those columns to
    the rank's output columns. Full output column ``p = i*stride + t``
    (input i, tap t < k) is output column ``p - (k-1)//2``, so output o
    reads the inputs ``ceil((o + (k-1)//2 - k + 1) / stride) ..
    floor((o + (k-1)//2) / stride)``; zeros beyond the frame."""
    w = layout.global_width(x.shape[3], pyramid=True)
    before = (k - 1) // 2
    outs = layout.ranges(w * stride)
    spans = [(-((k - 1 - before - lo) // stride), (hi - 1 + before) // stride + 1) for lo, hi in outs]
    xe = layout.fetch(x, 3, layout.ranges(w), spans, f"deconv k{k} s{stride}")
    (lo, hi), (slo, shi) = outs[layout.rank], spans[layout.rank]
    return xe, _transpose_crop(lo, hi, slo, k, stride, (shi - slo - 1) * stride + k)


def _transpose_crop(lo: int, hi: int, first: int, k: int, stride: int, full: int) -> Tuple[int, int]:
    """The pad (negative: the crop) that takes the ``full`` columns of a
    transposed convolution's output, of inputs from column ``first`` on,
    to the TF SAME output columns ``[lo, hi)``."""
    start = lo + (k - 1) // 2 - first * stride
    return -start, hi - lo + start - full


def _bias_act(y, bias, dt, activation):
    """The bf16 modes' epilogue: ``y`` (rounded to bf16 by the
    convolution) cast to ``dt``, then the bias in ``dt``, then the
    activation."""
    y = y.to(dt)
    if bias is not None:
        y = y + bias.to(dt).view(1, -1, 1, 1)
    return activation(y)


def _conv(x, weight, bias, stride, rate, activation, padding, groups=1):
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    if padding == "VALID" and shard_context.active() is not None:
        raise NotImplementedError("a VALID convolution under width sharding: ROADMAP.md, queue 1")
    dt = _bf16_epilogue(x)
    if dt is not None:
        x, weight = x.to(torch.bfloat16), weight.to(torch.bfloat16)
    if padding == "SAME":
        x = same_pad(x, weight.shape[2:], stride, rate)
    if dt is None:
        return activation(F.conv2d(x, weight, bias, stride=stride, dilation=rate, groups=groups))
    y = F.conv2d(x, weight, None, stride=stride, dilation=rate, groups=groups)
    return _bias_act(y, bias, dt, activation)


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
    output, and the bias comes after it, as in TF. The precision modes
    apply as in :func:`conv2d`. Under a width-sharded layout it returns
    the rank's output columns (:func:`_transpose_halo`)."""
    dt = _bf16_epilogue(x)
    if dt is not None:
        x, weight = x.to(torch.bfloat16), weight.to(torch.bfloat16)
    layout = shard_context.active()
    if layout is not None:
        x, (left, right) = _transpose_halo(layout, x, weight.shape[3], stride)
    y = F.conv_transpose2d(x, weight, None, stride=stride)
    if layout is None:
        left, right = _transpose_crop(0, x.shape[3] * stride, 0, weight.shape[3], stride, y.shape[3])
    pads = [left, right, *_transpose_crop(0, x.shape[2] * stride, 0, weight.shape[2], stride, y.shape[2])]
    if any(pads):
        y = F.pad(y, pads)
    if dt is not None:
        return _bias_act(y, bias, dt, activation)
    if bias is not None:
        y = y + bias.view(1, -1, 1, 1)
    return activation(y)


def depthwise_conv(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    activation: Callable = leaky_relu(0.1),
    padding: str = "SAME",
) -> torch.Tensor:
    """Depthwise conv. ``weight`` is the JAX package's ``[kh, kw, in_c,
    mult]`` kernel as :func:`..utils.checkpoint.params_from_jax` carries it
    over, ``[mult, in_c, kh, kw]``; it runs as a conv of ``groups=in_c``
    whose output channel ``c*mult + m`` is input channel c's m-th filter,
    the order of the JAX package's reshape to ``in_c*mult`` outputs."""
    mult, c_in, kh, kw = weight.shape
    w = weight.transpose(0, 1).reshape(c_in * mult, 1, kh, kw)
    return _conv(x, w, bias, stride, 1, activation, padding, groups=c_in)


def separable_conv2d(
    x: torch.Tensor,
    depthwise_weight: torch.Tensor,
    depthwise_bias: Optional[torch.Tensor],
    pointwise_weight: torch.Tensor,
    pointwise_bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    activation: Callable = leaky_relu(0.1),
    padding: str = "SAME",
) -> torch.Tensor:
    """Depthwise (leaky relu 0.1) then pointwise conv, mirroring
    sharedLayers.py:105-115; the JAX package's ``params['depthwise']`` and
    ``params['pointwise']`` come in as two weight and bias pairs. As in the
    reference, ``stride`` applies to BOTH convs."""
    x = depthwise_conv(x, depthwise_weight, depthwise_bias, stride, leaky_relu(0.1), padding)
    return conv2d(x, pointwise_weight, pointwise_bias, stride, activation, padding)


def grouped_conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    num_groups: int = 1,
    stride: int = 1,
    activation: Callable = leaky_relu(0.1),
    padding: str = "SAME",
) -> torch.Tensor:
    """Grouped conv; ``weight`` is ``[out_c, in_c/groups, kh, kw]``, the
    JAX package's ``[kh, kw, in_c/groups, out_c]`` under
    :func:`..utils.checkpoint.params_from_jax` (both split the outputs into
    groups in order)."""
    return _conv(x, weight, bias, stride, 1, activation, padding, groups=num_groups)


def channel_shuffle_inside_group(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Channel shuffle (sharedLayers.py:133-139) on NCHW ``x``: channel
    ``i*(c/g) + j`` goes to ``j*g + i``, as the JAX package's NHWC one."""
    b, c, h, w = x.shape
    return x.reshape(b, num_groups, c // num_groups, h, w).transpose(1, 2).reshape(b, c, h, w)
