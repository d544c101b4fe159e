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
the same input must agree bit for bit. The tiled one-hot warps are held
against the one-hot products (2e-6 absolute: the product may fuse one
rounding) and against the clamped-window kernels (1e-6; the image warps
bit for bit, both forwards being gathers of the same taps), and one fused
MAD session replayed from CUDA graphs against the same session run
eagerly.
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


# the edges of the feature forwards' grids: W = 1; C = 1 and C = 17 (no
# multiple of a channel group); rows of 33 and 38 floats (not 16-byte
# aligned); H = 1 with B = 2; max_neg beyond the row
_FEATURE_EDGES = [
    ((1, 3, 4, 1), 6),
    ((1, 17, 5, 33), 12),
    ((1, 1, 7, 38), 6),
    ((2, 5, 1, 76), 12),
    ((1, 9, 3, 20), 40),
]


@pytest.mark.parametrize(
    "shape,max_neg",
    [((2, 6, 4, 140), 20), ((1, 128, 10, 38), 6), ((1, 32, 80, 304), 48), *_FEATURE_EDGES],
)
def test_warp_features_kernel_matches_plain(dev, shape, max_neg):
    """Bit for bit: the kernel rounds as the plain version does."""
    feats = _normal(shape, 5, dev)
    dx = _uniform((shape[0], 1, *shape[2:]), 6, dev, -max_neg - 10.0, 10.0)
    before = cuda_lib.LAUNCHES["warp_features_fwd"]
    got = tops.warp_features_cuda(feats, dx, max_neg, 4)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["warp_features_fwd"] == before + 1
    assert torch.equal(got, tops.warp_features_clamped(feats, dx, max_neg, 4))


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
            assert {k: v for k, v in cuda_lib.LAUNCHES.items() if v} == {
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
    # no loss, so no image warp; no backward; none of the tiled kernels
    assert {k: v for k, v in cuda_lib.LAUNCHES.items() if v} == {"corr_fwd": 5, "warp_features_fwd": 4}
    for da, db in zip(a["disparities"], b["disparities"]):
        scale = max(float(db.abs().max()), 1e-6)
        torch.testing.assert_close(da, db, rtol=1e-4, atol=1e-4 * scale)


# ------------------------------------------------- the tiled one-hot warps


@pytest.mark.parametrize(
    "shape,max_disp",
    [((2, 3, 9, 150), 40), ((1, 17, 3, 20), 40), ((1, 5, 4, 256), 300), ((1, 3, 320, 1216), 192)],
)
def test_tiled_image_warp_matches_plain_and_clamped_kernels(dev, shape, max_disp):
    """Forward and both gradients against the one-hot product over the
    padded row (its plain version) and against the clamped-window kernels,
    which compute the same function: widths that are no multiple of 128,
    one that is, a row narrower than the window, 17 channels across the
    offset gradient's chunk of 16, a window wider than the row; offsets beyond both
    bounds, on them, and exactly 0."""
    img = _normal(shape, 24, dev)
    disp = _uniform((shape[0], 1, *shape[2:]), 25, dev, -20.0, max_disp + 40.0)
    disp[..., 3::11] = float(max_disp)
    disp[..., 5::13] = 0.0
    disp[..., -1] = 1.5  # the last column's second tap reads the pad column at 0 only
    g = _normal(shape, 26, dev)
    ig, dg = img.clone().requires_grad_(), disp.clone().requires_grad_()
    before = {k: cuda_lib.LAUNCHES[k] for k in ("warp_tile_image_fwd", "warp_tile_image_bwd")}
    out = tops.warp_image_mxu(ig, dg, max_disp)
    dimg, ddisp = torch.autograd.grad(out, (ig, dg), g)
    dimg2, ddisp2 = torch.autograd.grad(tops.warp_image_mxu(ig, dg, max_disp), (ig, dg), g)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["warp_tile_image_fwd"] == before["warp_tile_image_fwd"] + 2
    assert cuda_lib.LAUNCHES["warp_tile_image_bwd"] == before["warp_tile_image_bwd"] + 2
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, tops.warp_image_onehot(img, disp, max_disp, align=128), rtol=0, atol=2e-6)
    # a gather of the same taps as warp_image_fwd: the same bits
    assert torch.equal(out, tops.warp_image_cuda(img, disp, max_disp))
    want_img, want_disp = tops.warp_image_onehot_bwd(img, disp, g, max_disp)
    _close(dimg, want_img, "dimg")
    _close(ddisp, want_disp, "ddisp")
    other_img, other_disp = tops.warp_image_bwd_cuda(img, disp, g, max_disp)
    _close(dimg, other_img, "dimg against warp_image_bwd")
    _close(ddisp, other_disp, "ddisp against warp_image_bwd")
    assert torch.equal(dimg, dimg2) and torch.equal(ddisp, ddisp2)
    # the gradient passes on the bounds and at 0, and is cut beyond them
    # (in a row narrower than the window both taps of a sample at the lower
    # bound are the edge pixel, and its gradient is rightly zero)
    assert bool(ddisp[..., 5::13].any()) and (shape[3] <= max_disp or bool(ddisp[..., 3::11].any()))
    assert not bool(ddisp[(disp < 0) | (disp > max_disp)].any())
    (only_disp,) = torch.autograd.grad(tops.warp_image_mxu(img, dg, max_disp), (dg,), g)
    assert torch.equal(only_disp, ddisp)
    only_img, none = tops.warp_image_mxu_bwd(img, disp, g, max_disp, need_disp=False)
    assert none is None and torch.equal(only_img, dimg)


@pytest.mark.parametrize(
    "shape,max_neg",
    [
        ((2, 6, 4, 140), 20), ((1, 17, 3, 9), 20), ((1, 9, 2, 256), 12), ((1, 128, 10, 38), 6),
        ((1, 32, 80, 304), 48), *_FEATURE_EDGES,
        # wide rows: 1500 and 7000 columns, one with a clip window of 3400
        # columns (the forward is a gather, with no row-length limit)
        ((1, 9, 2, 1500), 20), ((1, 9, 2, 7000), 20), ((1, 16, 2, 7000), 3400),
    ],
)
def test_tiled_feature_warp_matches_plain_and_clamped_kernels(dev, shape, max_neg):
    feats = _normal(shape, 27, dev)
    dx = _uniform((shape[0], 1, *shape[2:]), 28, dev, -max_neg - 10.0, 10.0)
    dx[..., 2::7] = -float(max_neg)
    dx[..., 4::9] = 4.0
    if shape[3] > 3:
        dx[..., -3:] = 2.5  # samples right of the row: a weight on a pad column
    else:
        dx[..., ::2, :] = -0.25  # one tap left of the row, one on column 0
    g = _normal(shape, 29, dev)
    fg, dg = feats.clone().requires_grad_(), dx.clone().requires_grad_()
    before = cuda_lib.LAUNCHES["warp_tile_features_fwd"]
    out = tops.warp_features_mxu(fg, dg, max_neg, 4)
    assert cuda_lib.LAUNCHES["warp_tile_features_fwd"] == before + 1
    dfeats, ddx = torch.autograd.grad(out, (fg, dg), g)
    dfeats2, ddx2 = torch.autograd.grad(tops.warp_features_mxu(fg, dg, max_neg, 4), (fg, dg), g)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, tops.warp_features_onehot(feats, dx, max_neg, 4, align=128), rtol=0, atol=2e-6
    )
    torch.testing.assert_close(out, tops.warp_features_cuda(feats, dx, max_neg, 4), rtol=0, atol=1e-6)
    want_f, want_dx = tops.warp_features_onehot_bwd(feats, dx, g, max_neg, 4)
    _close(dfeats, want_f, "dfeats")
    _close(ddx, want_dx, "ddx")
    other_f, other_dx = tops.warp_features_bwd_cuda(feats, dx, g, max_neg, 4)
    _close(dfeats, other_f, "dfeats against warp_features_bwd")
    _close(ddx, other_dx, "ddx against warp_features_bwd")
    assert torch.equal(dfeats, dfeats2) and torch.equal(ddx, ddx2)
    if shape[3] > max_neg:  # else a sample at the lower bound lies left of the row
        assert bool(ddx[..., 2::7].any()) and bool(ddx[..., 4::9].any())
    assert not bool(ddx[(dx < -max_neg) | (dx > 4)].any())
    (only_f,) = torch.autograd.grad(tops.warp_features_mxu(fg, dx, max_neg, 4), (fg,), g)
    assert torch.equal(only_f, dfeats)


def test_tiled_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = _normal((1, 4, 3, 140), 30, dev)
    d = torch.zeros(1, 1, 3, 140, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        tops.warp_image_mxu(x.transpose(2, 3), d.transpose(2, 3), 8)
    with pytest.raises(ValueError, match="contiguous"):
        tops.warp_features_mxu_bwd(x, d, x.transpose(2, 3).contiguous().transpose(2, 3), 8, 4)
    with pytest.raises(TypeError, match="float32"):
        tops.warp_image_mxu(x.half(), d, 8)
    with pytest.raises(TypeError, match="float32"):
        tops.warp_features_mxu(x, d.double(), 8, 4)
    with pytest.raises(ValueError):
        tops.warp_features_mxu(x, d.cpu(), 8, 4)  # offset on the CPU
    with pytest.raises(ValueError):
        tops.warp_image_mxu(x.cpu(), d, 8)  # source on the CPU
    with pytest.raises(ValueError):
        tops.warp_image_mxu(x, torch.zeros(1, 2, 3, 140, device=dev), 8)
    with pytest.raises(ValueError, match="negative"):
        tops.warp_image_mxu(x, d, -1)
    # by mode: a channels-last source is made contiguous for the kernel
    cl = x.contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(
        tops.warp_features_by_mode(cl, d + 1.25, "mxu", 8, 4),
        tops.warp_features_by_mode(x, d + 1.25, "onehot", 8, 4), rtol=0, atol=2e-6,
    )


# ------------------------------------------------------- the fused session


def _smooth_frames(n, h, w, seed):
    r = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0 : w + 16].astype(np.float32)
    out = []
    for i in range(n):
        d = 3 + i
        base = np.zeros((h, w + 16, 3), np.float32)
        for c in range(3):
            for _ in range(6):
                fx, fy = r.uniform(0.02, 0.25, 2)
                px, py = r.uniform(0, 2 * np.pi, 2)
                base[..., c] += r.uniform(10, 40) * np.sin(2 * np.pi * fx * xs + px) * np.cos(
                    2 * np.pi * fy * ys + py
                )
        base = np.clip(base + 128, 0, 255).astype(np.float32)
        target = np.full((1, h, w, 1), float(d), np.float32)
        target[:, :, :d] = 0.0
        out.append({"left": base[None, :, :w].copy(), "right": base[None, :, d : w + d].copy(), "target": target})
    return out


def test_fused_mad_step_replayed_equals_eager(dev):
    """A MAD session whose steps are replayed CUDA graphs against the same
    session run eagerly, with the tiled warps: losses to 1e-5 relative
    (cuDNN's backward is not run-to-run deterministic), the same blocks'
    ranges moved, launches counted per replay, and no host sync in the
    replayed frames."""
    from real_time_self_adaptive_deep_stereo_torch.adapt import (
        AdaptationEngine,
        FusedOnlineSession,
        default_block_config_path,
        load_block_config,
        make_blocks,
    )

    frames = _smooth_frames(6, 128, 256, 31)

    def session(use_graphs):
        model = get_stereo_net("MADNet", bulkhead=True, warp_mode="mxu", seed=0)
        with torch.no_grad():  # predictions of 20 px plus a few, so that gradients flow
            for name, p in model.named_parameters():
                layer, leaf = name.split(".")[1:]
                if leaf == "weight" and layer in ("disp6", "context7"):
                    p.mul_(0.02)
                if leaf == "bias" and layer == "disp6":
                    p.fill_(-1.0)
        blocks = make_blocks(load_block_config(default_block_config_path("MADNet")), model)
        eng = AdaptationEngine(model, blocks, lr=1e-4, warp_mode="mxu")
        return FusedOnlineSession(
            eng, mode="MAD", sample_mode="FIXED", fixed_id=3, ssim_th=1e9, max_steps=8,
            use_graphs=use_graphs,
        )

    eager, graphed = session(False), session(True)
    for f in frames:
        eager.step(f)
    graphed.step(frames[0])  # eager, then the capture
    assert set(graphed._graphs) == {("mad", (3,))}
    want = {"corr_fwd": 5, "warp_tile_image_fwd": 2, "warp_tile_features_fwd": 4,
            "corr_bwd": 1, "warp_tile_image_bwd": 1, "warp_tile_features_bwd": 1}
    assert graphed.graph_launches[("mad", (3,))] == want
    before = dict(cuda_lib.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for f in frames[1:]:
            graphed.step(f)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    added = {k: cuda_lib.LAUNCHES[k] - before[k] for k in before if cuda_lib.LAUNCHES[k] != before[k]}
    assert added == {k: 5 * v for k, v in want.items()}
    a, b = graphed.finalize(), eager.finalize()
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    np.testing.assert_allclose(a["epe"], b["epe"], rtol=1e-4)
    np.testing.assert_array_equal(a["fetch_counter"], [0, 0, 0, 6, 0])
    s, e = graphed.arena.block_ranges[3]
    moved = (graphed.arena.flat != graphed.arena.flat0).nonzero().flatten()
    assert moved.numel() > 0 and s <= int(moved.min()) and int(moved.max()) < e
    scale = float((eager.arena.flat - eager.arena.flat0).abs().max())
    assert float((graphed.arena.flat - eager.arena.flat).abs().max()) <= 1e-2 * scale
    assert not eager._graphs
