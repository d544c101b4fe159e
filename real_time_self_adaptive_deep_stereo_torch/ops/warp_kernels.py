"""Wrappers of the hand-written warp kernels (``csrc/warp.cu``).

Counterpart of ``real_time_self_adaptive_deep_stereo_tpu/ops/warp_pallas.py``:

* :func:`warp_image_cuda` launches ``warp_image_fwd``, which replaces the
  Pallas kernel ``_img_fwd_kernel`` (``warp_image_pallas``).
* :func:`warp_features_cuda` launches ``warp_features_fwd``, which
  replaces ``_feat_fwd_kernel`` (``warp_features_pallas``).

Both compute the clamped-window semantics of :mod:`.warp`; their plain
versions are :func:`warp_image_clamped` and :func:`warp_features_clamped`,
re-exported here. A wrapper runs the plain version on a CPU tensor and
launches its kernel, or raises, on a CUDA tensor. The backward kernels
come with the adaptation slice; until then the autograd shells raise in
backward.

:func:`warp_image_by_mode` and :func:`warp_features_by_mode` dispatch on
the warp modes of :func:`.warp.resolve_warp_mode` for the model and loss.
"""

from __future__ import annotations

import torch

from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib
from real_time_self_adaptive_deep_stereo_torch.ops.warp import (
    resolve_warp_mode,
    warp_features_clamped,
    warp_features_horizontal,
    warp_image,
    warp_image_clamped,
)

__all__ = [
    "warp_image_cuda",
    "warp_features_cuda",
    "warp_image_clamped",
    "warp_features_clamped",
    "warp_image_by_mode",
    "warp_features_by_mode",
]


def _check(name: str, src: torch.Tensor, off: torch.Tensor) -> None:
    if src.device.type != "cuda" or off.device != src.device:
        raise ValueError(f"{name} needs both inputs on one CUDA device, got {src.device}, {off.device}")
    if src.dim() != 4 or tuple(off.shape) != (src.shape[0], 1, *src.shape[2:]):
        raise ValueError(
            f"{name} needs an NCHW source and a [B,1,H,W] offset, got "
            f"{tuple(src.shape)}, {tuple(off.shape)}"
        )
    if not (src.is_contiguous() and off.is_contiguous()):
        raise ValueError(f"{name} needs contiguous inputs")


def _check_dtype(name: str, src: torch.Tensor, off: torch.Tensor) -> None:
    if src.dtype != torch.float32 or off.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 only, got {src.dtype}, {off.dtype}")


def _launch(fn_name: str, src: torch.Tensor, off: torch.Tensor, *bounds: float) -> torch.Tensor:
    _check(fn_name, src, off)
    b, c, h, w = src.shape
    out = torch.empty_like(src)
    lib = cuda_lib.library("warp")
    err = getattr(lib, fn_name)(
        src.data_ptr(), off.data_ptr(), out.data_ptr(), b, c, h, w, *bounds,
        cuda_lib.stream_ptr(src.device),
    )
    cuda_lib.check(lib, err, fn_name)
    cuda_lib.LAUNCHES[fn_name] += 1
    return out


def _no_backward(what: str):
    raise NotImplementedError(
        f"the {what} backward kernel comes with the MAD/FULL adaptation slice "
        "(ROADMAP.md, TPU kernels to port)"
    )


class _WarpImageCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, disp, max_disp):
        return _launch("warp_image_fwd", img, disp, float(max_disp))

    @staticmethod
    def backward(ctx, grad):
        _no_backward("image warp")


class _WarpFeaturesCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, dx, max_neg, max_pos):
        return _launch("warp_features_fwd", feats, dx, float(max_neg), float(max_pos))

    @staticmethod
    def backward(ctx, grad):
        _no_backward("feature warp")


def warp_image_cuda(img: torch.Tensor, disp: torch.Tensor, max_disp: int = 192) -> torch.Tensor:
    """Clamp-to-edge image warp at ``x - clip(disp, 0, max_disp)``
    (NCHW img, [B,1,H,W] disp, fp32)."""
    _check_dtype("warp_image_fwd", img, disp)
    if img.device.type == "cpu" and disp.device.type == "cpu":
        return warp_image_clamped(img, disp, max_disp)
    return _WarpImageCUDA.apply(img, disp, max_disp)


def warp_features_cuda(
    feats: torch.Tensor, dx: torch.Tensor, max_neg: int = 64, max_pos: int = 4
) -> torch.Tensor:
    """Feature warp at ``x + clip(dx, -max_neg, max_pos)`` with
    out-of-range corners zeroed (NCHW feats, [B,1,H,W] dx, fp32)."""
    _check_dtype("warp_features_fwd", feats, dx)
    if feats.device.type == "cpu" and dx.device.type == "cpu":
        return warp_features_clamped(feats, dx, max_neg, max_pos)
    return _WarpFeaturesCUDA.apply(feats, dx, max_neg, max_pos)


def warp_image_by_mode(
    img: torch.Tensor, disp: torch.Tensor, mode: str, max_disp: int = 192
) -> torch.Tensor:
    mode = resolve_warp_mode(mode, img.device)
    if mode == "cuda":
        return warp_image_cuda(img.contiguous(), disp.contiguous(), max_disp)
    if mode == "clamped":
        return warp_image_clamped(img, disp, max_disp)
    return warp_image(img, disp)


def warp_features_by_mode(
    feats: torch.Tensor, dx: torch.Tensor, mode: str, max_neg: int = 64, max_pos: int = 4
) -> torch.Tensor:
    mode = resolve_warp_mode(mode, feats.device)
    if mode == "cuda":
        return warp_features_cuda(feats.contiguous(), dx.contiguous(), max_neg, max_pos)
    if mode == "clamped":
        return warp_features_clamped(feats, dx, max_neg, max_pos)
    return warp_features_horizontal(feats, dx)
