"""1-D stereo correlation cost volume (NCHW).

    corr[b, k, h, w] = mean_c( x[b, c, h, w] * y[b, c, h, w + d_k] )

for d_k = -max_disp .. +max_disp (step ``stride``), ``y`` zero-padded
along W. Port of ``real_time_self_adaptive_deep_stereo_tpu/ops/correlation.py``:

* :func:`correlation_torch` is the plain version, a copy of
  ``correlation_jnp``. The CPU path and the tests use it.
* :func:`correlation_torch_bwd` is the plain version of the backward, a
  copy of ``_corr_pallas_bwd``.
* :func:`correlation_cuda` is the wrapper of the hand-written kernels in
  ``csrc/correlation.cu``: ``corr_fwd``, which replaces the Pallas kernel
  ``_corr_fwd_kernel``, and in backward ``corr_bwd``. On a CPU tensor it
  runs the plain version (autograd differentiates it); on a CUDA tensor
  it launches the kernels or raises.
* :func:`correlation` picks one: ``mode='auto'`` is ``cuda`` for CUDA
  tensors at stride 1 and ``torch`` otherwise.
"""

from __future__ import annotations

from typing import Literal, Tuple

import torch
import torch.nn.functional as F

from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

__all__ = [
    "correlation",
    "correlation_torch",
    "correlation_torch_bwd",
    "correlation_cuda",
    "correlation_bwd_cuda",
    "MAX_KERNEL_RADIUS",
]

MAX_KERNEL_RADIUS = 4  # corr_fwd and corr_bwd are instantiated for radius 1..4


def correlation_torch(
    x: torch.Tensor, y: torch.Tensor, max_disp: int, stride: int = 1
) -> torch.Tensor:
    """Plain version (NCHW in, [B, n_shifts, H, W] out)."""
    w = x.shape[3]
    ypad = F.pad(y, (max_disp, max_disp))
    outs = []
    for d in range(-max_disp, max_disp + 1, stride):
        shifted = ypad[..., d + max_disp : d + max_disp + w]
        outs.append(torch.mean(shifted * x, dim=1, keepdim=True))
    return torch.cat(outs, dim=1)


def correlation_torch_bwd(
    x: torch.Tensor, y: torch.Tensor, g: torch.Tensor, max_disp: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward at stride 1: ``(dx, dy)`` for the
    gradient ``g`` ([B, 2*max_disp+1, H, W]) of the cost volume.

        dx[w, c] = sum_k g[w, k] * ypad[w + k, c] / C
        dy[v, c] = sum_k g[v + max_disp - k, k] * x[v + max_disp - k, c] / C
    """
    c, w = x.shape[1], x.shape[3]
    inv_c = 1.0 / c
    pad = (max_disp, max_disp)
    xpad, ypad, gpad = F.pad(x, pad), F.pad(y, pad), F.pad(g, pad)
    dx = torch.zeros_like(x)
    dy = torch.zeros_like(y)
    for k in range(2 * max_disp + 1):
        dx = dx + g[:, k : k + 1] * ypad[..., k : k + w] * inv_c
        # reverse shift: output column w feeds y column w + k - max_disp
        off = 2 * max_disp - k
        dy = dy + gpad[:, k : k + 1, :, off : off + w] * xpad[..., off : off + w] * inv_c
    return dx, dy


def _check(name: str, x: torch.Tensor, y: torch.Tensor, max_disp: int) -> None:
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"{name} needs both inputs on one CUDA device, got {x.device}, {y.device}")
    if x.dim() != 4 or x.shape != y.shape:
        raise ValueError(f"{name} needs two NCHW tensors of one shape, got {tuple(x.shape)}, {tuple(y.shape)}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"{name} needs contiguous inputs")
    if not 1 <= max_disp <= MAX_KERNEL_RADIUS:
        raise ValueError(f"{name} supports max_disp 1..{MAX_KERNEL_RADIUS}, got {max_disp}")


def _corr_fwd_launch(x: torch.Tensor, y: torch.Tensor, max_disp: int) -> torch.Tensor:
    _check("corr_fwd", x, y, max_disp)
    b, c, h, w = x.shape
    out = torch.empty((b, 2 * max_disp + 1, h, w), device=x.device, dtype=x.dtype)
    lib = cuda_lib.library("correlation")
    err = lib.corr_fwd(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), b, c, h, w, max_disp,
        cuda_lib.stream_ptr(x.device),
    )
    cuda_lib.check(lib, err, "corr_fwd")
    cuda_lib.LAUNCHES["corr_fwd"] += 1
    return out


def _corr_bwd_launch(
    x: torch.Tensor, y: torch.Tensor, g: torch.Tensor, max_disp: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    _check("corr_bwd", x, y, max_disp)
    b, c, h, w = x.shape
    if g.device != x.device or g.dtype != x.dtype or tuple(g.shape) != (b, 2 * max_disp + 1, h, w):
        raise ValueError(
            f"corr_bwd needs a float32 gradient of shape {(b, 2 * max_disp + 1, h, w)} on "
            f"{x.device}, got {g.dtype} {tuple(g.shape)} on {g.device}"
        )
    if not g.is_contiguous():
        raise ValueError("corr_bwd needs a contiguous gradient")
    if c > 65535:
        raise ValueError(f"corr_bwd supports at most 65535 channels, got {c}")
    dx, dy = torch.empty_like(x), torch.empty_like(y)
    lib = cuda_lib.library("correlation")
    err = lib.corr_bwd(
        x.data_ptr(), y.data_ptr(), g.data_ptr(), dx.data_ptr(), dy.data_ptr(),
        b, c, h, w, max_disp, cuda_lib.stream_ptr(x.device),
    )
    cuda_lib.check(lib, err, "corr_bwd")
    cuda_lib.LAUNCHES["corr_bwd"] += 1
    return dx, dy


class _CorrelationCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, max_disp):
        ctx.save_for_backward(x, y)
        ctx.max_disp = max_disp
        return _corr_fwd_launch(x, y, max_disp)

    @staticmethod
    def backward(ctx, grad):
        x, y = ctx.saved_tensors
        # cuDNN may hand the gradient over in another layout or as an
        # expanded view; the kernel takes contiguous NCHW
        dx, dy = _corr_bwd_launch(x, y, grad.contiguous(), ctx.max_disp)
        return dx, dy, None


def correlation_cuda(x: torch.Tensor, y: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Kernel wrapper (stride 1, fp32, NCHW): ``corr_fwd``, and ``corr_bwd``
    in backward, on CUDA tensors; the plain version on CPU tensors."""
    cuda_lib.check_float32("corr_fwd", x, y)
    if x.device.type == "cpu" and y.device.type == "cpu":
        return correlation_torch(x, y, max_disp)
    return _CorrelationCUDA.apply(x, y, max_disp)


def correlation_bwd_cuda(
    x: torch.Tensor, y: torch.Tensor, g: torch.Tensor, max_disp: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wrapper of the backward kernel alone: ``(dx, dy)`` from ``corr_bwd``
    on CUDA tensors, from the plain version on CPU tensors. The backward
    of :func:`correlation_cuda` launches the same kernel."""
    cuda_lib.check_float32("corr_bwd", x, y, g)
    if x.device.type == "cpu" and y.device.type == "cpu" and g.device.type == "cpu":
        return correlation_torch_bwd(x, y, g, max_disp)
    return _corr_bwd_launch(x, y, g, max_disp)


def correlation(
    x: torch.Tensor,
    y: torch.Tensor,
    max_disp: int,
    stride: int = 1,
    mode: Literal["auto", "torch", "cuda"] = "auto",
) -> torch.Tensor:
    """Correlation cost volume between left ``x`` and right ``y`` (NCHW)."""
    if mode == "auto":
        mode = "cuda" if (x.device.type == "cuda" and stride == 1) else "torch"
    if mode == "cuda":
        if stride != 1:
            raise ValueError("the correlation kernel requires stride == 1")
        return correlation_cuda(x, y, max_disp)
    if mode == "torch":
        return correlation_torch(x, y, max_disp, stride)
    raise ValueError(f"unknown correlation mode {mode!r}")
