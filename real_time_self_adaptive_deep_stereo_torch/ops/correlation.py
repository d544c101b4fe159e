"""1-D stereo correlation cost volume (NCHW).

    corr[b, k, h, w] = mean_c( x[b, c, h, w] * y[b, c, h, w + d_k] )

for d_k = -max_disp .. +max_disp (step ``stride``), ``y`` zero-padded
along W. Port of ``real_time_self_adaptive_deep_stereo_tpu/ops/correlation.py``:

* :func:`correlation_torch` is the plain version, a copy of
  ``correlation_jnp``. The CPU path and the tests use it.
* :func:`correlation_torch_bwd` is the plain version of the backward, a
  copy of ``_corr_pallas_bwd``.

Both take float32 or bfloat16. On bf16 they compute in fp32 from the
bf16 values and round each output once, which is what the Pallas forward
does (``_corr_fwd_kernel`` widens, accumulates in fp32 and stores in the
input dtype) and what the kernels' bf16 instances do; the reference's
backward computes in bf16 instead (``ROADMAP.md``, section 3).
* :func:`correlation_cuda` is the wrapper of the hand-written kernels in
  ``csrc/correlation.cu``, which replace the Pallas kernel
  ``_corr_fwd_kernel`` at any radius: ``corr_fwd`` (and ``corr_bwd`` in
  backward) keep their sums in registers and are instantiated for radius
  1 .. ``MAX_REGISTER_RADIUS`` (MADNet's 2); ``corr_fwd_wide`` and
  ``corr_bwd_wide`` take any radius (DispNet-Corr1D's 40). On a CPU tensor
  it runs the plain version (autograd differentiates it); on a CUDA
  tensor it launches the kernels or raises. bf16 inputs launch the bf16
  instances, counted as ``corr_fwd_bf16``, ``corr_bwd_bf16``,
  ``corr_fwd_wide_bf16`` and ``corr_bwd_wide_bf16``.
* :func:`correlation` picks one by :func:`resolve_corr_mode`: ``auto`` is
  ``cuda`` for CUDA tensors at stride 1, at every radius, and ``torch``
  otherwise. Under a width-sharded layout (:mod:`..parallel.spatial`) it
  runs on the rank's columns: the right features with a halo of the
  radius from the neighbours (zeros beyond the frame, as the kernel's own
  zeros), the left ones padded, and the result cropped.

The kernel Functions carry ``vmap`` rules for ``torch.func``: the
streams of a vmapped step fold into the batch axis, and each kernel
launches once for all of them.
"""

from __future__ import annotations

from typing import Literal, Optional, Tuple

import torch
import torch.nn.functional as F

from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib
from real_time_self_adaptive_deep_stereo_torch.ops import shard_context

__all__ = [
    "correlation",
    "correlation_torch",
    "correlation_torch_bwd",
    "correlation_cuda",
    "correlation_bwd_cuda",
    "resolve_corr_mode",
    "MAX_REGISTER_RADIUS",
]

# the largest radius of the register-resident instances corr_fwd and
# corr_bwd; a wider (or zero) radius runs corr_fwd_wide and corr_bwd_wide
MAX_REGISTER_RADIUS = 4


def correlation_torch(
    x: torch.Tensor, y: torch.Tensor, max_disp: int, stride: int = 1
) -> torch.Tensor:
    """Plain version (NCHW in, [B, n_shifts, H, W] out, in x's dtype)."""
    if x.dtype == torch.bfloat16:
        # fp32 sums of the widened values, scaled by 1/C and rounded once,
        # as _corr_fwd_kernel
        xf, ypad = x.float(), F.pad(y.float(), (max_disp, max_disp))
        inv_c, w = 1.0 / x.shape[1], x.shape[3]
        outs = [
            (ypad[..., k : k + w] * xf).sum(dim=1, keepdim=True) * inv_c
            for k in range(0, 2 * max_disp + 1, stride)
        ]
        return torch.cat(outs, dim=1).to(x.dtype)
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

    On bf16 the sums are taken in fp32 and each gradient is rounded once.
    """
    if x.dtype == torch.bfloat16:
        dx, dy = correlation_torch_bwd(x.float(), y.float(), g.float(), max_disp)
        return dx.to(x.dtype), dy.to(y.dtype)
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


def _is_wide(max_disp: int, wide: Optional[bool]) -> bool:
    """Whether a radius runs the wide kernels: by default beyond the
    register-resident instances; ``wide`` forces one kind."""
    if max_disp < 0:
        raise ValueError(f"the correlation needs max_disp >= 0, got {max_disp}")
    if wide is None:
        return not 1 <= max_disp <= MAX_REGISTER_RADIUS
    if not wide and not 1 <= max_disp <= MAX_REGISTER_RADIUS:
        raise ValueError(f"corr_fwd and corr_bwd support max_disp 1..{MAX_REGISTER_RADIUS}, got {max_disp}")
    return bool(wide)


def _check(name: str, x: torch.Tensor, y: torch.Tensor) -> None:
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"{name} needs both inputs on one CUDA device, got {x.device}, {y.device}")
    if x.dim() != 4 or x.shape != y.shape:
        raise ValueError(f"{name} needs two NCHW tensors of one shape, got {tuple(x.shape)}, {tuple(y.shape)}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"{name} needs contiguous inputs")
    if x.shape[0] > 65535 or x.shape[2] > 65535:  # the launch grid's y and z axes
        raise ValueError(f"{name} supports batch and height up to 65535, got {tuple(x.shape)}")


def _kernel_name(base: str, wide: bool, dtype: torch.dtype) -> str:
    return base + ("_wide" if wide else "") + ("_bf16" if dtype == torch.bfloat16 else "")


def _corr_fwd_launch(x: torch.Tensor, y: torch.Tensor, max_disp: int, wide: bool) -> torch.Tensor:
    name = _kernel_name("corr_fwd", wide, x.dtype)
    _check(name, x, y)
    b, c, h, w = x.shape
    out = torch.empty((b, 2 * max_disp + 1, h, w), device=x.device, dtype=x.dtype)
    lib = cuda_lib.library("correlation")
    err = getattr(lib, name)(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), b, c, h, w, max_disp,
        cuda_lib.stream_ptr(x.device),
    )
    cuda_lib.check(lib, err, name)
    cuda_lib.LAUNCHES[name] += 1
    return out


def _corr_bwd_launch(
    x: torch.Tensor, y: torch.Tensor, g: torch.Tensor, max_disp: int, wide: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    name = _kernel_name("corr_bwd", wide, x.dtype)
    _check(name, x, y)
    b, c, h, w = x.shape
    if g.device != x.device or g.dtype != x.dtype or tuple(g.shape) != (b, 2 * max_disp + 1, h, w):
        raise ValueError(
            f"{name} needs a {x.dtype} gradient (the inputs' dtype) of shape "
            f"{(b, 2 * max_disp + 1, h, w)} on {x.device}, got {g.dtype} {tuple(g.shape)} on {g.device}"
        )
    if not g.is_contiguous():
        raise ValueError(f"{name} needs a contiguous gradient")
    dx, dy = torch.empty_like(x), torch.empty_like(y)
    lib = cuda_lib.library("correlation")
    err = getattr(lib, name)(
        x.data_ptr(), y.data_ptr(), g.data_ptr(), dx.data_ptr(), dy.data_ptr(),
        b, c, h, w, max_disp, cuda_lib.stream_ptr(x.device),
    )
    cuda_lib.check(lib, err, name)
    cuda_lib.LAUNCHES[name] += 1
    return dx, dy


class _CorrelationCUDA(torch.autograd.Function):
    """The forward kernel, with a ``vmap`` rule for ``torch.func``: the
    streams are folded into the batch axis and the kernel runs once. Its
    backward goes through :class:`_CorrelationBwdCUDA`, which has a rule
    of its own, since under ``vmap(grad(...))`` it receives batched
    tensors."""

    @staticmethod
    def forward(x, y, max_disp, wide):
        return _corr_fwd_launch(x, y, max_disp, wide)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, y, max_disp, wide = inputs
        ctx.save_for_backward(x, y)
        ctx.max_disp, ctx.wide = max_disp, wide

    @staticmethod
    def backward(ctx, grad):
        x, y = ctx.saved_tensors
        # cuDNN may hand the gradient over in another layout or as an
        # expanded view; the kernel takes contiguous NCHW. A downstream
        # promotion may hand back a wider gradient than bf16 inputs: it is
        # cast to their dtype, as _corr_pallas_bwd does.
        dx, dy = _CorrelationBwdCUDA.apply(x, y, grad.to(x.dtype).contiguous(), ctx.max_disp, ctx.wide)
        return dx, dy, None, None

    @staticmethod
    def vmap(info, in_dims, x, y, max_disp, wide):
        n = info.batch_size
        xs, ys = cuda_lib.fold_streams(n, (x, y), in_dims[:2])
        return cuda_lib.unfold_streams(n, _CorrelationCUDA.apply(xs, ys, max_disp, wide)), 0


class _CorrelationBwdCUDA(torch.autograd.Function):
    """The backward kernel as a Function of its own, for its ``vmap``
    rule; it is not differentiable again."""

    @staticmethod
    def forward(x, y, g, max_disp, wide):
        return _corr_bwd_launch(x, y, g, max_disp, wide)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the correlation backward kernel has no backward of its own")

    @staticmethod
    def vmap(info, in_dims, x, y, g, max_disp, wide):
        n = info.batch_size
        xs, ys, gs = cuda_lib.fold_streams(n, (x, y, g), in_dims[:3])
        dx, dy = _CorrelationBwdCUDA.apply(xs, ys, gs, max_disp, wide)
        return (cuda_lib.unfold_streams(n, dx), cuda_lib.unfold_streams(n, dy)), (0, 0)


def correlation_cuda(
    x: torch.Tensor, y: torch.Tensor, max_disp: int, wide: Optional[bool] = None
) -> torch.Tensor:
    """Kernel wrapper (stride 1, fp32 or bf16, NCHW) on CUDA tensors:
    ``corr_fwd`` (and ``corr_bwd`` in backward) for radius
    1..``MAX_REGISTER_RADIUS``, ``corr_fwd_wide`` (and ``corr_bwd_wide``)
    for any other radius; ``wide`` forces one kind; bf16 inputs run the
    ``_bf16`` instances. The plain version on CPU tensors."""
    cuda_lib.check_same_float("corr_fwd", x, y)
    wide = _is_wide(max_disp, wide)
    if x.device.type == "cpu" and y.device.type == "cpu":
        return correlation_torch(x, y, max_disp)
    return _CorrelationCUDA.apply(x, y, max_disp, wide)


def correlation_bwd_cuda(
    x: torch.Tensor, y: torch.Tensor, g: torch.Tensor, max_disp: int, wide: Optional[bool] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wrapper of the backward kernels alone: ``(dx, dy)`` from
    ``corr_bwd`` or ``corr_bwd_wide`` (picked as :func:`correlation_cuda`
    picks) on CUDA tensors, from the plain version on CPU tensors. The
    backward of :func:`correlation_cuda` launches the same kernel."""
    cuda_lib.check_same_float("corr_bwd", x, y, g)
    wide = _is_wide(max_disp, wide)
    if x.device.type == "cpu" and y.device.type == "cpu" and g.device.type == "cpu":
        return correlation_torch_bwd(x, y, g, max_disp)
    return _corr_bwd_launch(x, y, g, max_disp, wide)


def resolve_corr_mode(device_type: str, stride: int, max_disp: int) -> str:
    """What ``mode='auto'`` runs: ``'cuda'``, the kernels, for a CUDA
    tensor at stride 1 whatever the radius (the kernels take every
    ``max_disp >= 0``), and ``'torch'``, the plain version, otherwise."""
    if max_disp < 0:
        raise ValueError(f"the correlation needs max_disp >= 0, got {max_disp}")
    return "cuda" if device_type == "cuda" and stride == 1 else "torch"


def correlation(
    x: torch.Tensor,
    y: torch.Tensor,
    max_disp: int,
    stride: int = 1,
    mode: Literal["auto", "torch", "cuda"] = "auto",
) -> torch.Tensor:
    """Correlation cost volume between left ``x`` and right ``y`` (NCHW)."""
    layout = shard_context.active()
    if layout is not None:
        ye = layout.halo(y, 3, max_disp, max_disp, "correlation")
        with shard_context.sharded(None):
            out = correlation(F.pad(x, (max_disp, max_disp)), ye, max_disp, stride, mode)
        return out[..., max_disp : max_disp + x.shape[3]]
    if mode == "auto":
        mode = resolve_corr_mode(x.device.type, stride, max_disp)
    if mode == "cuda":
        if stride != 1:
            raise ValueError("the correlation kernel requires stride == 1")
        return correlation_cuda(x, y, max_disp)
    if mode == "torch":
        return correlation_torch(x, y, max_disp, stride)
    raise ValueError(f"unknown correlation mode {mode!r}")
