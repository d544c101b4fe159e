"""Wrappers of the hand-written warp kernels (``csrc/warp.cu``,
``csrc/warp_tile.cu``).

Counterpart of ``real_time_self_adaptive_deep_stereo_tpu/ops/warp_pallas.py``:

* :func:`warp_image_cuda` launches ``warp_image_fwd``, which replaces the
  Pallas kernel ``_img_fwd_kernel`` (``warp_image_pallas``), and in
  backward ``warp_image_bwd``, which replaces ``_img_bwd_kernel``.
* :func:`warp_features_cuda` launches ``warp_features_fwd``, which
  replaces ``_feat_fwd_kernel`` (``warp_features_pallas``), and in
  backward ``warp_features_bwd``, which replaces ``_feat_bwd_kernel``.

* :func:`warp_image_mxu` and :func:`warp_features_mxu` launch
  ``warp_tile_image_fwd`` / ``warp_tile_features_fwd``, which replace the
  Pallas kernel ``_mxu_fwd_kernel`` (``warp_image_mxu``,
  ``warp_features_mxu``), and in backward ``warp_tile_image_bwd`` /
  ``warp_tile_features_bwd``, which replace ``_mxu_bwd_kernel``. They
  compute the same two samplings over 128-column tiles with the row
  padded to a multiple of 128; their plain versions are
  :func:`warp_image_onehot` and :func:`warp_features_onehot` with
  ``align=128`` (backward: :func:`warp_image_onehot_bwd`,
  :func:`warp_features_onehot_bwd`). The output is fp32.

All compute the clamped-window semantics of :mod:`.warp`; the plain
versions of the first two are :func:`warp_image_clamped` and :func:`warp_features_clamped`
(backward: :func:`warp_image_clamped_bwd`, :func:`warp_features_clamped_bwd`),
re-exported here. A wrapper runs the plain version on a CPU tensor, where
autograd differentiates it, and launches its kernels, or raises, on a
CUDA tensor. A backward kernel computes only the gradients that autograd
asks for: on the main path the right image needs none, and with MADNet's
bulkhead the feature warp's offset needs none.

:func:`warp_image_by_mode` and :func:`warp_features_by_mode` dispatch on
the warp modes of :func:`.warp.resolve_warp_mode` for the model and loss.
Under a width-sharded layout (:mod:`..parallel.spatial`) they run at the
full width on every rank, the source fetched whole and the offset at the
rank's columns, and return the rank's columns.

The kernel Functions carry ``vmap`` rules for ``torch.func``: the
streams of a vmapped step fold into the batch axis, and each kernel, its
backward's too, launches once for all of them.
"""

from __future__ import annotations

import torch

from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib
from real_time_self_adaptive_deep_stereo_torch.ops import shard_context
from real_time_self_adaptive_deep_stereo_torch.ops.warp import (
    TILE,
    resolve_warp_mode,
    warp_features_clamped,
    warp_features_clamped_bwd,
    warp_features_horizontal,
    warp_features_onehot,
    warp_features_onehot_bwd,
    warp_image,
    warp_image_clamped,
    warp_image_clamped_bwd,
    warp_image_onehot,
    warp_image_onehot_bwd,
)

__all__ = [
    "warp_image_cuda",
    "warp_features_cuda",
    "warp_image_bwd_cuda",
    "warp_features_bwd_cuda",
    "warp_image_clamped",
    "warp_features_clamped",
    "warp_image_clamped_bwd",
    "warp_features_clamped_bwd",
    "warp_image_mxu",
    "warp_features_mxu",
    "warp_image_mxu_bwd",
    "warp_features_mxu_bwd",
    "warp_image_onehot",
    "warp_features_onehot",
    "warp_image_onehot_bwd",
    "warp_features_onehot_bwd",
    "warp_image_by_mode",
    "warp_features_by_mode",
]

# The launch grid's y and z axes take at most 65535 blocks each. Per entry
# point: whether a y or z axis runs over the rows H, and the channels per
# block where an axis runs over B times the channel chunks (the image
# warp's backward: kChunk of csrc/warp.cu; the feature warps' backward:
# kOffMaxSlices * kSrcMaxCps, the source gradient's channels a block),
# None where it runs over B alone. The feature forwards put their channel
# groups on the x axis; the feature backward, tiled or not, puts the
# pixels of the plane there (both of its kernels).
_GRID = {
    "warp_image_fwd": (True, None),
    "warp_features_fwd": (False, None),
    "warp_image_bwd": (True, 4),
    "warp_features_bwd": (False, 128),
    "warp_tile_image_fwd": (True, None),
    "warp_tile_features_fwd": (False, None),
    "warp_tile_image_bwd": (False, 128),
    "warp_tile_features_bwd": (False, 128),
}


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


def _all_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_grid(fn_name: str, shape) -> None:
    b, c, h, _ = shape
    rows, chunk = _GRID[fn_name]
    if (rows and h > 65535) or b * (1 if chunk is None else -(-c // chunk)) > 65535:
        raise ValueError(f"{fn_name}: shape {tuple(shape)} exceeds the launch grid")


def _launch(
    lib_name: str, fn_name: str, src: torch.Tensor, off: torch.Tensor, *bounds: float
) -> torch.Tensor:
    _check(fn_name, src, off)
    b, c, h, w = src.shape
    _check_grid(fn_name, src.shape)
    out = torch.empty_like(src)
    lib = cuda_lib.library(lib_name)
    err = getattr(lib, fn_name)(
        src.data_ptr(), off.data_ptr(), out.data_ptr(), b, c, h, w, *bounds,
        cuda_lib.stream_ptr(src.device),
    )
    cuda_lib.check(lib, err, fn_name)
    cuda_lib.LAUNCHES[fn_name] += 1
    return out


def _launch_bwd(
    lib_name: str,
    fn_name: str,
    src: torch.Tensor,
    off: torch.Tensor,
    grad: torch.Tensor,
    need_src: bool,
    need_off: bool,
    *bounds: float,
):
    """``(dsrc, doff)``; a gradient that is not needed is ``None`` and its
    kernel is not launched."""
    _check(fn_name, src, off)
    if grad.device != src.device or grad.dtype != src.dtype or grad.shape != src.shape:
        raise ValueError(
            f"{fn_name} needs a float32 gradient of shape {tuple(src.shape)} on {src.device}, "
            f"got {grad.dtype} {tuple(grad.shape)} on {grad.device}"
        )
    if not grad.is_contiguous():
        raise ValueError(f"{fn_name} needs a contiguous gradient")
    b, c, h, w = src.shape
    _check_grid(fn_name, src.shape)
    dsrc = torch.empty_like(src) if need_src else None
    doff = torch.empty_like(off) if need_off else None
    if not (need_src or need_off):
        return dsrc, doff
    lib = cuda_lib.library(lib_name)
    err = getattr(lib, fn_name)(
        src.data_ptr(), off.data_ptr(), grad.data_ptr(),
        None if dsrc is None else dsrc.data_ptr(),
        None if doff is None else doff.data_ptr(),
        b, c, h, w, *bounds, int(need_src), int(need_off),
        cuda_lib.stream_ptr(src.device),
    )
    cuda_lib.check(lib, err, fn_name)
    cuda_lib.LAUNCHES[fn_name] += 1
    return dsrc, doff


class _WarpBwd(torch.autograd.Function):
    """A warp's backward kernel ``fn_name`` of library ``lib_name`` as a
    Function of its own, for its ``vmap`` rule (the forward Functions'
    backward receives batched tensors under ``vmap(grad(...))``); it is not
    differentiable again."""

    @staticmethod
    def forward(lib_name, fn_name, src, off, grad, need_src, need_off, bounds):
        return _launch_bwd(lib_name, fn_name, src, off, grad, need_src, need_off, *bounds)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("a warp's backward kernel has no backward of its own")

    @staticmethod
    def vmap(info, in_dims, lib_name, fn_name, src, off, grad, need_src, need_off, bounds):
        n = info.batch_size
        folded = cuda_lib.fold_streams(n, (src, off, grad), in_dims[2:5])
        dsrc, doff = _WarpBwd.apply(lib_name, fn_name, *folded, need_src, need_off, bounds)
        out = (cuda_lib.unfold_streams(n, dsrc), cuda_lib.unfold_streams(n, doff))
        return out, tuple(None if t is None else 0 for t in out)


class _WarpFn(torch.autograd.Function):
    """Base of the four warp Functions: ``forward(src, off, *bounds)``
    launches ``FWD`` of ``LIB``, the backward launches ``BWD`` through
    :class:`_WarpBwd` for the gradients autograd asks for, and the ``vmap``
    rule folds the streams into the batch axis, so that each kernel runs
    once over them."""

    LIB = FWD = BWD = ""

    @classmethod
    def forward(cls, src, off, *bounds):
        return _launch(cls.LIB, cls.FWD, src, off, *(float(b) for b in bounds))

    @staticmethod
    def setup_context(ctx, inputs, output):
        src, off, *bounds = inputs
        ctx.save_for_backward(src, off)
        ctx.bounds = tuple(float(b) for b in bounds)

    @classmethod
    def backward(cls, ctx, grad):
        src, off = ctx.saved_tensors
        # the gradient may arrive in another layout or as an expanded
        # view; the kernel takes contiguous NCHW
        dsrc, doff = _WarpBwd.apply(
            cls.LIB, cls.BWD, src, off, grad.contiguous(),
            ctx.needs_input_grad[0], ctx.needs_input_grad[1], ctx.bounds,
        )
        return (dsrc, doff) + (None,) * len(ctx.bounds)

    @classmethod
    def vmap(cls, info, in_dims, src, off, *bounds):
        n = info.batch_size
        folded = cuda_lib.fold_streams(n, (src, off), in_dims[:2])
        return cuda_lib.unfold_streams(n, cls.apply(*folded, *bounds)), 0


class _WarpImageCUDA(_WarpFn):
    LIB, FWD, BWD = "warp", "warp_image_fwd", "warp_image_bwd"


class _WarpFeaturesCUDA(_WarpFn):
    LIB, FWD, BWD = "warp", "warp_features_fwd", "warp_features_bwd"


def warp_image_cuda(img: torch.Tensor, disp: torch.Tensor, max_disp: int = 192) -> torch.Tensor:
    """Clamp-to-edge image warp at ``x - clip(disp, 0, max_disp)``
    (NCHW img, [B,1,H,W] disp, fp32)."""
    cuda_lib.check_float32("warp_image_fwd", img, disp)
    if _all_cpu(img, disp):
        return warp_image_clamped(img, disp, max_disp)
    return _WarpImageCUDA.apply(img, disp, max_disp)


def warp_image_bwd_cuda(
    img: torch.Tensor,
    disp: torch.Tensor,
    g: torch.Tensor,
    max_disp: int = 192,
    need_img: bool = True,
    need_disp: bool = True,
):
    """Wrapper of the backward kernel alone: ``(dimg, ddisp)`` for the
    gradient ``g`` of :func:`warp_image_cuda`'s output, from
    ``warp_image_bwd`` on CUDA tensors and from the plain version on CPU
    tensors. A gradient that is not needed is ``None``."""
    cuda_lib.check_float32("warp_image_bwd", img, disp, g)
    if _all_cpu(img, disp, g):
        dimg, ddisp = warp_image_clamped_bwd(img, disp, g, max_disp)
        return (dimg if need_img else None), (ddisp if need_disp else None)
    return _launch_bwd(
        "warp", "warp_image_bwd", img, disp, g, need_img, need_disp, float(max_disp)
    )


def warp_features_cuda(
    feats: torch.Tensor, dx: torch.Tensor, max_neg: int = 64, max_pos: int = 4
) -> torch.Tensor:
    """Feature warp at ``x + clip(dx, -max_neg, max_pos)`` with
    out-of-range corners zeroed (NCHW feats, [B,1,H,W] dx, fp32)."""
    cuda_lib.check_float32("warp_features_fwd", feats, dx)
    if _all_cpu(feats, dx):
        return warp_features_clamped(feats, dx, max_neg, max_pos)
    return _WarpFeaturesCUDA.apply(feats, dx, max_neg, max_pos)


def warp_features_bwd_cuda(
    feats: torch.Tensor,
    dx: torch.Tensor,
    g: torch.Tensor,
    max_neg: int = 64,
    max_pos: int = 4,
    need_feats: bool = True,
    need_dx: bool = True,
):
    """Wrapper of the backward kernel alone: ``(dfeats, ddx)`` for the
    gradient ``g`` of :func:`warp_features_cuda`'s output, with the
    conventions of :func:`warp_image_bwd_cuda`."""
    cuda_lib.check_float32("warp_features_bwd", feats, dx, g)
    if _all_cpu(feats, dx, g):
        dfeats, ddx = warp_features_clamped_bwd(feats, dx, g, max_neg, max_pos)
        return (dfeats if need_feats else None), (ddx if need_dx else None)
    return _launch_bwd(
        "warp", "warp_features_bwd", feats, dx, g, need_feats, need_dx,
        float(max_neg), float(max_pos),
    )


class _WarpImageTile(_WarpFn):
    LIB, FWD, BWD = "warp_tile", "warp_tile_image_fwd", "warp_tile_image_bwd"


class _WarpFeaturesTile(_WarpFn):
    LIB, FWD, BWD = "warp_tile", "warp_tile_features_fwd", "warp_tile_features_bwd"


def _check_bounds(what: str, *bounds: float) -> None:
    if any(b < 0 for b in bounds):
        raise ValueError(f"{what}: the clip bounds must not be negative, got {bounds}")


def warp_image_mxu(img: torch.Tensor, disp: torch.Tensor, max_disp: int = 192) -> torch.Tensor:
    """Tiled one-hot image warp: clamp-to-edge at ``x - clip(disp, 0,
    max_disp)`` over 128-column tiles of the zero-padded row (NCHW img,
    [B,1,H,W] disp, fp32 in and out)."""
    cuda_lib.check_float32("warp_tile_image_fwd", img, disp)
    _check_bounds("warp_tile_image_fwd", max_disp)
    if _all_cpu(img, disp):
        return warp_image_onehot(img, disp, max_disp, align=TILE)
    return _WarpImageTile.apply(img, disp, max_disp)


def warp_image_mxu_bwd(
    img: torch.Tensor,
    disp: torch.Tensor,
    g: torch.Tensor,
    max_disp: int = 192,
    need_img: bool = True,
    need_disp: bool = True,
):
    """Wrapper of the tiled backward kernel alone: ``(dimg, ddisp)`` for
    the gradient ``g`` of :func:`warp_image_mxu`'s output, from
    ``warp_tile_image_bwd`` on CUDA tensors and from the plain version on
    CPU tensors. A gradient that is not needed is ``None``."""
    cuda_lib.check_float32("warp_tile_image_bwd", img, disp, g)
    _check_bounds("warp_tile_image_bwd", max_disp)
    if _all_cpu(img, disp, g):
        dimg, ddisp = warp_image_onehot_bwd(img, disp, g, max_disp, align=TILE)
        return (dimg if need_img else None), (ddisp if need_disp else None)
    return _launch_bwd(
        "warp_tile", "warp_tile_image_bwd", img, disp, g, need_img, need_disp, float(max_disp)
    )


def warp_features_mxu(
    feats: torch.Tensor, dx: torch.Tensor, max_neg: int = 64, max_pos: int = 4
) -> torch.Tensor:
    """Tiled one-hot feature warp at ``x + clip(dx, -max_neg, max_pos)``
    with out-of-range corners zeroed, over 128-column tiles of the
    zero-padded row (NCHW feats, [B,1,H,W] dx, fp32 in and out)."""
    cuda_lib.check_float32("warp_tile_features_fwd", feats, dx)
    _check_bounds("warp_tile_features_fwd", max_neg, max_pos)
    if _all_cpu(feats, dx):
        return warp_features_onehot(feats, dx, max_neg, max_pos, align=TILE)
    return _WarpFeaturesTile.apply(feats, dx, max_neg, max_pos)


def warp_features_mxu_bwd(
    feats: torch.Tensor,
    dx: torch.Tensor,
    g: torch.Tensor,
    max_neg: int = 64,
    max_pos: int = 4,
    need_feats: bool = True,
    need_dx: bool = True,
):
    """Wrapper of the tiled backward kernel alone: ``(dfeats, ddx)`` for
    the gradient ``g`` of :func:`warp_features_mxu`'s output, with the
    conventions of :func:`warp_image_mxu_bwd`."""
    cuda_lib.check_float32("warp_tile_features_bwd", feats, dx, g)
    _check_bounds("warp_tile_features_bwd", max_neg, max_pos)
    if _all_cpu(feats, dx, g):
        dfeats, ddx = warp_features_onehot_bwd(feats, dx, g, max_neg, max_pos, align=TILE)
        return (dfeats if need_feats else None), (ddx if need_dx else None)
    return _launch_bwd(
        "warp_tile", "warp_tile_features_bwd", feats, dx, g, need_feats, need_dx,
        float(max_neg), float(max_pos),
    )


def _widen(*tensors: torch.Tensor):
    """bf16 sources and offsets widened to fp32, losslessly. The warp
    kernels take fp32 alone, and no warp of the reference computes in bf16:
    under ``bf16_act`` its Pallas feature warps reject bf16 features, and
    its ``gather`` and ``onehot`` warps promote them to fp32. A warp of
    bf16 inputs therefore returns fp32, as the reference's does."""
    return [t.float() if t.dtype == torch.bfloat16 else t for t in tensors]


def warp_image_by_mode(
    img: torch.Tensor, disp: torch.Tensor, mode: str, max_disp: int = 192
) -> torch.Tensor:
    """The image warp of ``mode`` (``ops/warp.py::resolve_warp_mode``), in
    fp32 (a bf16 disparity, DispNet's under ``bf16_act``, is widened)."""
    layout = shard_context.active()
    if layout is not None:
        return layout.full_width(
            lambda s, o: warp_image_by_mode(s, o, mode, max_disp), img, disp, "warp_image"
        )
    img, disp = _widen(img, disp)
    mode = resolve_warp_mode(mode, img.device)
    if mode == "cuda":
        return warp_image_cuda(img.contiguous(), disp.contiguous(), max_disp)
    if mode == "mxu":
        return warp_image_mxu(img.contiguous(), disp.contiguous(), max_disp)
    if mode == "onehot":
        return warp_image_onehot(img, disp, max_disp)
    if mode == "clamped":
        return warp_image_clamped(img, disp, max_disp)
    return warp_image(img, disp)


def warp_features_by_mode(
    feats: torch.Tensor, dx: torch.Tensor, mode: str, max_neg: int = 64, max_pos: int = 4
) -> torch.Tensor:
    """The feature warp of ``mode``, in fp32 (bf16 features and offsets,
    MADNet's under ``bf16_act``, are widened); the caller casts back."""
    layout = shard_context.active()
    if layout is not None:
        return layout.full_width(
            lambda s, o: warp_features_by_mode(s, o, mode, max_neg, max_pos), feats, dx, "warp_features"
        )
    feats, dx = _widen(feats, dx)
    mode = resolve_warp_mode(mode, feats.device)
    if mode == "cuda":
        return warp_features_cuda(feats.contiguous(), dx.contiguous(), max_neg, max_pos)
    if mode == "mxu":
        return warp_features_mxu(feats.contiguous(), dx.contiguous(), max_neg, max_pos)
    if mode == "onehot":
        return warp_features_onehot(feats, dx, max_neg, max_pos)
    if mode == "clamped":
        return warp_features_clamped(feats, dx, max_neg, max_pos)
    return warp_features_horizontal(feats, dx)
