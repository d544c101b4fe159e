"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips elsewhere: a CUDA kernel has
no CPU mode, and the CPU tests cover the plain versions against JAX. This
file imports neither JAX nor the JAX package, so on a machine without JAX
it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: the correlation kernel sums over C in another order than
``torch.mean`` (1e-5 relative and absolute); the warp kernels round every
product and sum as the plain version does and agree to 1e-6 absolute. The
backward kernels are held to 1e-5 of the largest entry of each gradient:
they add in a fixed order, the plain versions (autograd, whose scatter
uses atomics on the card) in another. Two runs of a backward kernel on
the same input must agree bit for bit.
"""

import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch import ops as tops
from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _normal(shape, seed, dev, scale=1.0, shift=0.0):
    r = np.random.default_rng(seed)
    return torch.from_numpy((r.standard_normal(shape) * scale + shift).astype(np.float32)).to(dev)


def _uniform(shape, seed, dev, lo, hi):
    r = np.random.default_rng(seed)
    return torch.from_numpy((r.random(shape) * (hi - lo) + lo).astype(np.float32)).to(dev)


@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(2, 7, 5, 37), (1, 192, 5, 19), (1, 32, 80, 304)])
def test_corr_kernel_matches_plain(dev, shape, radius):
    x, y = _normal(shape, 1, dev), _normal(shape, 2, dev)
    before = cuda_lib.LAUNCHES["corr_fwd"]
    got = tops.correlation(x, y, radius)  # 'auto' on CUDA at stride 1: the kernel
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["corr_fwd"] == before + 1
    want = tops.correlation_torch(x, y, radius)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,max_disp", [((2, 3, 9, 150), 40), ((1, 3, 320, 1216), 192)])
def test_warp_image_kernel_matches_plain(dev, shape, max_disp):
    img = _normal(shape, 3, dev)
    disp = _uniform((shape[0], 1, *shape[2:]), 4, dev, -20.0, max_disp + 40.0)
    got = tops.warp_image_cuda(img, disp, max_disp)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tops.warp_image_clamped(img, disp, max_disp), rtol=0, atol=1e-6)


@pytest.mark.parametrize(
    "shape,max_neg", [((2, 6, 4, 140), 20), ((1, 128, 10, 38), 6), ((1, 32, 80, 304), 48)]
)
def test_warp_features_kernel_matches_plain(dev, shape, max_neg):
    feats = _normal(shape, 5, dev)
    dx = _uniform((shape[0], 1, *shape[2:]), 6, dev, -max_neg - 10.0, 10.0)
    got = tops.warp_features_cuda(feats, dx, max_neg, 4)
    torch.cuda.synchronize()
    want = tops.warp_features_clamped(feats, dx, max_neg, 4)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = _normal((1, 4, 3, 8), 7, dev)
    with pytest.raises(ValueError, match="contiguous"):
        tops.correlation_cuda(x.transpose(2, 3), x.transpose(2, 3), 2)
    with pytest.raises(ValueError, match="max_disp"):
        tops.correlation_cuda(x, x, 9)
    with pytest.raises(ValueError):
        tops.warp_image_cuda(x, torch.zeros(1, 2, 3, 8, device=dev), 8)
    with pytest.raises(ValueError):
        tops.warp_features_cuda(x, torch.zeros(1, 1, 3, 8), 8, 4)  # offset on the CPU


def _close(got, want, what):
    scale = float(want.abs().max())
    assert scale > 0, what
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale, msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(2, 7, 5, 37), (1, 3, 2, 3), (1, 192, 5, 19), (1, 32, 80, 304)])
def test_corr_bwd_kernel_matches_plain(dev, shape, radius):
    x, y = _normal(shape, 11, dev), _normal(shape, 12, dev)
    g = _normal((shape[0], 2 * radius + 1, *shape[2:]), 13, dev)
    xg, yg = x.clone().requires_grad_(), y.clone().requires_grad_()
    before = cuda_lib.LAUNCHES["corr_bwd"]
    dx, dy = torch.autograd.grad(tops.correlation(xg, yg, radius), (xg, yg), g)
    dx2, dy2 = torch.autograd.grad(tops.correlation(xg, yg, radius), (xg, yg), g)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["corr_bwd"] == before + 2
    want_dx, want_dy = tops.correlation_torch_bwd(x, y, g, radius)
    _close(dx, want_dx, "dx")
    _close(dy, want_dy, "dy")
    assert torch.equal(dx, dx2) and torch.equal(dy, dy2)
    # autograd through the plain forward agrees with the plain backward
    ax, ay = torch.autograd.grad(tops.correlation_torch(xg, yg, radius), (xg, yg), g)
    _close(ax, want_dx, "autograd dx")
    _close(ay, want_dy, "autograd dy")


@pytest.mark.parametrize(
    "shape,max_disp", [((2, 3, 9, 150), 40), ((1, 5, 3, 20), 40), ((1, 3, 320, 1216), 192)]
)
def test_warp_image_bwd_kernel_matches_plain(dev, shape, max_disp):
    """Offsets beyond both ends of the window, some exactly on its bounds
    and at 0; one row narrower than the window; 5 channels cross the
    kernel's chunk of 4."""
    img = _normal(shape, 14, dev)
    disp = _uniform((shape[0], 1, *shape[2:]), 15, dev, -20.0, max_disp + 40.0)
    disp[..., 3::11] = float(max_disp)
    disp[..., 5::13] = 0.0
    g = _normal(shape, 16, dev)
    ig, dg = img.clone().requires_grad_(), disp.clone().requires_grad_()
    before = cuda_lib.LAUNCHES["warp_image_bwd"]
    dimg, ddisp = torch.autograd.grad(tops.warp_image_cuda(ig, dg, max_disp), (ig, dg), g)
    dimg2, ddisp2 = torch.autograd.grad(tops.warp_image_cuda(ig, dg, max_disp), (ig, dg), g)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["warp_image_bwd"] == before + 2
    want_img, want_disp = tops.warp_image_clamped_bwd(img, disp, g, max_disp)
    _close(dimg, want_img, "dimg")
    _close(ddisp, want_disp, "ddisp")
    assert torch.equal(dimg, dimg2) and torch.equal(ddisp, ddisp2)
    # only the gradient that is asked for is computed
    (only_disp,) = torch.autograd.grad(tops.warp_image_cuda(img, dg, max_disp), (dg,), g)
    assert torch.equal(only_disp, ddisp)
    (only_img,) = torch.autograd.grad(tops.warp_image_cuda(ig, disp, max_disp), (ig,), g)
    assert torch.equal(only_img, dimg)


@pytest.mark.parametrize(
    "shape,max_neg",
    [((2, 6, 4, 140), 20), ((1, 5, 3, 9), 20), ((1, 128, 10, 38), 6), ((1, 32, 80, 304), 48)],
)
def test_warp_features_bwd_kernel_matches_plain(dev, shape, max_neg):
    feats = _normal(shape, 17, dev)
    dx = _uniform((shape[0], 1, *shape[2:]), 18, dev, -max_neg - 10.0, 10.0)
    dx[..., 2::7] = -float(max_neg)
    dx[..., 4::9] = 4.0
    g = _normal(shape, 19, dev)
    fg, dg = feats.clone().requires_grad_(), dx.clone().requires_grad_()
    dfeats, ddx = torch.autograd.grad(tops.warp_features_cuda(fg, dg, max_neg, 4), (fg, dg), g)
    dfeats2, ddx2 = torch.autograd.grad(tops.warp_features_cuda(fg, dg, max_neg, 4), (fg, dg), g)
    torch.cuda.synchronize()
    want_f, want_dx = tops.warp_features_clamped_bwd(feats, dx, g, max_neg, 4)
    _close(dfeats, want_f, "dfeats")
    _close(ddx, want_dx, "ddx")
    assert torch.equal(dfeats, dfeats2) and torch.equal(ddx, ddx2)
    (only_f,) = torch.autograd.grad(tops.warp_features_cuda(fg, dx, max_neg, 4), (fg,), g)
    assert torch.equal(only_f, dfeats)


def test_backward_takes_a_gradient_in_any_layout(dev):
    """The gradient reaches ``backward`` as an expanded view (after a sum)
    or channels-last; the wrappers make it contiguous for the kernels."""
    x, y = _normal((1, 8, 6, 40), 20, dev), _normal((1, 8, 6, 40), 21, dev)
    xg = x.clone().requires_grad_()
    (dx,) = torch.autograd.grad(tops.correlation_cuda(xg, y, 2).sum(), xg)
    want, _ = tops.correlation_torch_bwd(x, y, torch.ones(1, 5, 6, 40, device=dev), 2)
    _close(dx, want, "dx from an expanded gradient")
    g = _normal((1, 8, 6, 40), 22, dev).contiguous(memory_format=torch.channels_last)
    d = _uniform((1, 1, 6, 40), 23, dev, -5.0, 30.0)
    (dimg,) = torch.autograd.grad(tops.warp_image_cuda(xg, d, 16), xg, g)
    want, _ = tops.warp_image_clamped_bwd(x, d, g, 16)
    _close(dimg, want, "dimg from a channels-last gradient")


def test_madnet_gradients_with_kernels_match_plain_modes(dev):
    """One backward through the whole network and the loss: kernels against
    plain modes on the card, to 5e-4 of the largest gradient (float32 noise
    of a backward pass; atomics in the plain modes' scatters)."""
    from real_time_self_adaptive_deep_stereo_torch.losses import get_reprojection_loss

    r = np.random.default_rng(24)
    frame = {
        k: torch.from_numpy((r.random((1, 60, 120, 3)) * 255).astype(np.float32)).to(dev)
        for k in ("left", "right")
    }
    grads = []
    for kw in ({}, dict(corr_mode="torch", warp_mode="clamped")):
        net = get_stereo_net("MADNet", seed=3, **kw)
        loss_fn = get_reprojection_loss("mean_SSIM_l1", warp_mode=kw.get("warp_mode", "auto"))
        cuda_lib.reset_launches()
        loss = loss_fn(net(frame["left"], frame["right"])["disparities"], frame)
        grads.append(torch.autograd.grad(loss, list(net.parameters())))
        if not kw:
            assert cuda_lib.LAUNCHES == {
                "corr_fwd": 5, "corr_bwd": 5, "warp_image_fwd": 1, "warp_image_bwd": 1,
                "warp_features_fwd": 4, "warp_features_bwd": 4,
            }
    scale = max(float(g.abs().max()) for g in grads[1])
    assert scale > 0
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=5e-4 * scale)


def test_madnet_kernels_match_plain_modes(dev):
    """The whole forward, kernels against plain modes on the card, at a
    size that is not a multiple of 64 (1e-4 of the largest disparity)."""
    r = np.random.default_rng(9)
    left = torch.from_numpy((r.random((1, 60, 120, 3)) * 255).astype(np.float32)).to(dev)
    right = torch.from_numpy((r.random((1, 60, 120, 3)) * 255).astype(np.float32)).to(dev)
    fast = get_stereo_net("MADNet", seed=3)
    plain = get_stereo_net("MADNet", seed=3, corr_mode="torch", warp_mode="clamped")
    cuda_lib.reset_launches()
    with torch.no_grad():
        a, b = fast(left, right), plain(left, right)
    fwd = {k: v for k, v in cuda_lib.LAUNCHES.items() if k.endswith("_fwd")}
    assert fwd == {"corr_fwd": 5, "warp_image_fwd": 0, "warp_features_fwd": 4}
    assert not any(v for k, v in cuda_lib.LAUNCHES.items() if k.endswith("_bwd"))
    for da, db in zip(a["disparities"], b["disparities"]):
        scale = max(float(db.abs().max()), 1e-6)
        torch.testing.assert_close(da, db, rtol=1e-4, atol=1e-4 * scale)
