"""1-D stereo correlation cost volume (NCHW).

    corr[b, k, h, w] = mean_c( x[b, c, h, w] * y[b, c, h, w + d_k] )

for d_k = -max_disp .. +max_disp (step ``stride``), ``y`` zero-padded
along W. Port of ``real_time_self_adaptive_deep_stereo_tpu/ops/correlation.py``:

* :func:`correlation_torch` is the plain version, a copy of
  ``correlation_jnp``. The CPU path and the tests use it.
* :func:`correlation_cuda` is the wrapper of the hand-written kernel
  ``csrc/correlation.cu`` (``corr_fwd``), which replaces the Pallas
  kernel ``_corr_fwd_kernel``. On a CPU tensor it runs the plain version;
  on a CUDA tensor it launches the kernel or raises.
* :func:`correlation` picks one: ``mode='auto'`` is ``cuda`` for CUDA
  tensors at stride 1 and ``torch`` otherwise.

The backward kernel comes with the adaptation slice; until then the
autograd shell raises in backward.
"""

from __future__ import annotations

from typing import Literal

import torch
import torch.nn.functional as F

from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

__all__ = ["correlation", "correlation_torch", "correlation_cuda", "MAX_KERNEL_RADIUS"]

MAX_KERNEL_RADIUS = 4  # corr_fwd is instantiated for radius 1..4


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


def _corr_fwd_launch(x: torch.Tensor, y: torch.Tensor, max_disp: int) -> torch.Tensor:
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"corr_fwd needs both inputs on one CUDA device, got {x.device}, {y.device}")
    if x.dim() != 4 or x.shape != y.shape:
        raise ValueError(f"corr_fwd needs two NCHW tensors of one shape, got {tuple(x.shape)}, {tuple(y.shape)}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("corr_fwd needs contiguous inputs")
    if not 1 <= max_disp <= MAX_KERNEL_RADIUS:
        raise ValueError(f"corr_fwd supports max_disp 1..{MAX_KERNEL_RADIUS}, got {max_disp}")
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


class _CorrelationCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, max_disp):
        return _corr_fwd_launch(x, y, max_disp)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the correlation backward kernel comes with the MAD/FULL adaptation "
            "slice (ROADMAP.md, TPU kernels to port)"
        )


def correlation_cuda(x: torch.Tensor, y: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Kernel wrapper (stride 1, fp32, NCHW): ``corr_fwd`` on CUDA tensors,
    the plain version on CPU tensors."""
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"corr_fwd takes float32 only, got {x.dtype}, {y.dtype}")
    if x.device.type == "cpu" and y.device.type == "cpu":
        return correlation_torch(x, y, max_disp)
    return _CorrelationCUDA.apply(x, y, max_disp)


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
