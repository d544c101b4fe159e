"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips elsewhere: a CUDA kernel has
no CPU mode, and the CPU tests cover the plain versions against JAX. This
file imports neither JAX nor the JAX package, so on a machine without JAX
it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: the correlation kernels sum over C in another order than
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
eagerly. The bf16 correlation instances are held within one bf16 ulp of
each entry of their plain versions (both sum in fp32 and round once, in
another order), plus what the order of an fp32 sum may change where it
cancels: 2 (n + 2) 2^-24 times the sum of its n terms' magnitudes.
"""

import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch import ops as tops
from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib
from real_time_self_adaptive_deep_stereo_torch.ops.correlation import MAX_REGISTER_RADIUS

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
        tops.correlation_cuda(x, x, 9, wide=False)  # the register instances stop at 4
    with pytest.raises(ValueError, match="max_disp"):
        tops.correlation_cuda(x, x, -1)
    with pytest.raises(ValueError):
        tops.warp_image_cuda(x, torch.zeros(1, 2, 3, 8, device=dev), 8)
    with pytest.raises(ValueError):
        tops.warp_features_cuda(x, torch.zeros(1, 1, 3, 8), 8, 4)  # offset on the CPU


def _close(got, want, what):
    scale = float(want.abs().max())
    assert scale > 0, what
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale, msg=lambda m: f"{what}: {m}")


# DispNet's shape at 320x1216, an edge where W < 2R+1, widths that are no
# multiple of the 64-column tile, channels that are no multiple of 32, and
# radii that take two and three chunks of shifts
_WIDE = [
    ((1, 128, 80, 304), 40),
    ((1, 128, 5, 19), 40),
    ((2, 7, 3, 70), 40),
    ((1, 33, 4, 130), 5),
    ((1, 5, 2, 140), 50),
    ((1, 70, 2, 200), 100),
]


@pytest.mark.parametrize("shape,radius", _WIDE)
def test_corr_wide_kernels_match_plain(dev, shape, radius):
    """``correlation(mode='auto')`` beyond radius 4 runs ``corr_fwd_wide``
    and, in backward, ``corr_bwd_wide``; both against their plain
    versions, the backward bit-identical in two runs."""
    x, y = _normal(shape, 31, dev), _normal(shape, 32, dev)
    g = _normal((shape[0], 2 * radius + 1, *shape[2:]), 33, dev)
    xg, yg = x.clone().requires_grad_(), y.clone().requires_grad_()
    cuda_lib.reset_launches()
    out = tops.correlation(xg, yg, radius)
    dx, dy = torch.autograd.grad(out, (xg, yg), g)
    dx2, dy2 = tops.correlation_bwd_cuda(x, y, g, radius)
    torch.cuda.synchronize()
    assert {k: v for k, v in cuda_lib.LAUNCHES.items() if v} == {"corr_fwd_wide": 1, "corr_bwd_wide": 2}
    torch.testing.assert_close(out, tops.correlation_torch(x, y, radius), rtol=1e-5, atol=1e-5)
    want_dx, want_dy = tops.correlation_torch_bwd(x, y, g, radius)
    _close(dx, want_dx, "dx")
    _close(dy, want_dy, "dy")
    assert torch.equal(dx, dx2) and torch.equal(dy, dy2)


@pytest.mark.parametrize("shape", [(1, 192, 5, 19), (1, 32, 80, 304)])
def test_corr_wide_kernels_take_a_register_radius(dev, shape):
    """Forced at MADNet's radius 2, the wide kernels compute what the
    register instances compute."""
    x, y = _normal(shape, 34, dev), _normal(shape, 35, dev)
    g = _normal((shape[0], 5, *shape[2:]), 36, dev)
    torch.testing.assert_close(
        tops.correlation_cuda(x, y, 2, wide=True), tops.correlation_cuda(x, y, 2), rtol=1e-5, atol=1e-5
    )
    for a, b, nm in zip(tops.correlation_bwd_cuda(x, y, g, 2, wide=True), tops.correlation_torch_bwd(x, y, g, 2),
                        ("dx", "dy")):
        _close(a, b, nm)


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


def _pile_at_ends(dx, max_neg, max_pos):
    """Row 0: every output samples left of the row (cx in (-3, 0]), so a
    tap of each lands on column 0, most of them with weight 0; row 1: every
    output samples right of it, a tap on column W - 1 (both as far as the
    clip window lets them)."""
    xs = torch.arange(dx.shape[3], device=dx.device, dtype=torch.float32)
    u = torch.linspace(0.0, 2.9, dx.shape[3], device=dx.device)
    dx[:, 0, 0] = (-xs - u).clamp(-max_neg, max_pos)
    dx[:, 0, 1] = (dx.shape[3] - 1 - xs + u).clamp(-max_neg, max_pos)


# K5's slices: MADNet's scale 5 and scale 2; C = 1, 5 and 6 where the
# source gradient takes one slice of 4 channels and one of 1 or 2 (planes
# over 135,168 pixels), 33 and 130 (a short last slice; two groups of 128
# channels); H = 1 with B = 2; rows narrower than the window; a window of
# 306 outputs (two passes of 256); every tap of a row piled on column 0 or
# on column W - 1
@pytest.mark.parametrize(
    "shape,max_neg,max_pos,pile",
    [
        ((2, 6, 4, 140), 20, 4, False), ((1, 5, 3, 9), 20, 4, False), ((1, 128, 10, 38), 6, 4, False),
        ((1, 32, 80, 304), 48, 4, False), ((1, 1, 6, 38), 6, 4, False), ((1, 5, 300, 456), 20, 4, False),
        ((1, 6, 300, 456), 20, 4, False), ((1, 33, 10, 38), 6, 4, False), ((1, 130, 10, 38), 6, 4, False),
        ((2, 5, 1, 76), 12, 4, False), ((1, 9, 3, 20), 40, 4, False), ((1, 16, 2, 700), 300, 4, False),
        ((1, 8, 3, 20), 40, 25, True), ((1, 32, 80, 304), 48, 4, True),
    ],
)
def test_warp_features_bwd_kernel_matches_plain(dev, shape, max_neg, max_pos, pile):
    """Both gradients against the plain version; two runs agree bit for
    bit; each gradient alone (MAD's ``dfeats``, the offset's ``ddx``) gives
    the bits of both together; one launch a call."""
    feats = _normal(shape, 17, dev)
    dx = _uniform((shape[0], 1, *shape[2:]), 18, dev, -max_neg - 10.0, max_pos + 6.0)
    dx[..., 2::7] = -float(max_neg)
    dx[..., 3::8] = 0.0
    dx[..., 4::9] = float(max_pos)
    if pile:
        _pile_at_ends(dx, max_neg, max_pos)
    g = _normal(shape, 19, dev)
    fg, dg = feats.clone().requires_grad_(), dx.clone().requires_grad_()
    before = cuda_lib.LAUNCHES["warp_features_bwd"]
    dfeats, ddx = torch.autograd.grad(tops.warp_features_cuda(fg, dg, max_neg, max_pos), (fg, dg), g)
    dfeats2, ddx2 = torch.autograd.grad(tops.warp_features_cuda(fg, dg, max_neg, max_pos), (fg, dg), g)
    (only_f,) = torch.autograd.grad(tops.warp_features_cuda(fg, dx, max_neg, max_pos), (fg,), g)
    none, only_dx = tops.warp_features_bwd_cuda(feats, dx, g, max_neg, max_pos, need_feats=False)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["warp_features_bwd"] == before + 4
    want_f, want_dx = tops.warp_features_clamped_bwd(feats, dx, g, max_neg, max_pos)
    _close(dfeats, want_f, "dfeats")
    _close(ddx, want_dx, "ddx")
    assert torch.equal(dfeats, dfeats2) and torch.equal(ddx, ddx2)
    assert torch.equal(only_f, dfeats)
    assert none is None and torch.equal(only_dx, ddx)
    assert not bool(ddx[(dx < -max_neg) | (dx > max_pos)].any())
    if pile and min(max_neg, max_pos) >= shape[3]:  # every output of rows 0-1 beyond an end
        for row, col in ((0, 0), (1, shape[3] - 1)):
            rest = torch.ones(shape[3], dtype=torch.bool, device=dev)
            rest[col] = False
            assert bool(want_f[:, :, row, col].ne(0).all()) and bool(dfeats[:, :, row, col].ne(0).all())
            assert not bool(want_f[:, :, row, rest].any()) and not bool(dfeats[:, :, row, rest].any())


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


def test_dispnet_with_kernels_matches_plain_modes(dev):
    """DispNet-Corr1D at a size that is not a multiple of 64: the forward
    (1e-4 of the largest disparity) and one backward through the loss
    (5e-4 of the largest gradient), kernels against the plain correlation
    and warps on the card; the forward runs ``corr_fwd_wide`` once and the
    backward ``corr_bwd_wide`` once."""
    from real_time_self_adaptive_deep_stereo_torch.losses import get_reprojection_loss

    r = np.random.default_rng(25)
    frame = {
        k: torch.from_numpy((r.random((1, 70, 130, 3)) * 255).astype(np.float32)).to(dev)
        for k in ("left", "right")
    }
    outs, grads = [], []
    for kw, warp in (({}, "auto"), (dict(corr_mode="torch"), "clamped")):
        net = get_stereo_net("Dispnet", seed=4, **kw)
        loss_fn = get_reprojection_loss("mean_SSIM_l1", warp_mode=warp)
        cuda_lib.reset_launches()
        out = net(frame["left"], frame["right"])
        grads.append(torch.autograd.grad(loss_fn(out["disparities"], frame), list(net.parameters())))
        outs.append([d.detach() for d in out["disparities"]])
        if not kw:
            assert {k: v for k, v in cuda_lib.LAUNCHES.items() if v} == {
                "corr_fwd_wide": 1, "corr_bwd_wide": 1, "warp_image_fwd": 1, "warp_image_bwd": 1,
            }
    for da, db in zip(*outs):
        scale = max(float(db.abs().max()), 1e-6)
        torch.testing.assert_close(da, db, rtol=1e-4, atol=1e-4 * scale)
    scale = max(float(g.abs().max()) for g in grads[1])
    assert scale > 0
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=5e-4 * scale)


# ------------------------------------------------- the tiled one-hot warps


@pytest.mark.parametrize(
    "shape,max_disp",
    [((2, 3, 9, 150), 40), ((1, 17, 3, 20), 40), ((1, 5, 4, 256), 300), ((1, 3, 320, 1216), 192)],
)
def test_tiled_image_warp_matches_plain_and_clamped_kernels(dev, shape, max_disp):
    """Forward and both gradients against the one-hot product over the
    padded row (its plain version) and against the clamped-window kernels,
    which compute the same function: widths that are no multiple of 128,
    one that is, a row narrower than the window, 17 channels (the offset
    gradient's slices of one channel each), a window wider than the row;
    offsets beyond both bounds, on them, and exactly 0."""
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


# the tiled offset gradient's slices of channels: MADNet's four feature
# shapes at 320x1216, channel counts that the slices do not divide (1, 3,
# 17, 33, 130), and a batch of 2
@pytest.mark.parametrize(
    "shape,max_neg",
    [
        ((1, 128, 10, 38), 6), ((1, 96, 20, 76), 12), ((1, 64, 40, 152), 24), ((1, 32, 80, 304), 48),
        ((1, 1, 6, 38), 6), ((1, 3, 6, 38), 6), ((2, 17, 5, 33), 12), ((1, 33, 4, 76), 12),
        ((1, 130, 10, 38), 6),
    ],
)
def test_tiled_offset_gradient_matches_plain_and_clamped_kernels(dev, shape, max_neg):
    """Both gradients of the tiled feature warp, as FULL asks for them,
    against the plain version and against ``warp_features_bwd``; the
    offset's alone gives the same bits; two runs agree bit for bit; one
    launch a call."""
    feats = _normal(shape, 32, dev)
    dx = _uniform((shape[0], 1, *shape[2:]), 33, dev, -max_neg - 10.0, 10.0)
    dx[..., 2::7] = -float(max_neg)
    dx[..., 4::9] = 4.0
    dx[..., -3:] = 2.5  # samples right of the row: a weight on a pad column
    g = _normal(shape, 34, dev)
    before = cuda_lib.LAUNCHES["warp_tile_features_bwd"]
    got = tops.warp_features_mxu_bwd(feats, dx, g, max_neg, 4)
    again = tops.warp_features_mxu_bwd(feats, dx, g, max_neg, 4)
    none, only_dx = tops.warp_features_mxu_bwd(feats, dx, g, max_neg, 4, need_feats=False)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["warp_tile_features_bwd"] == before + 3
    want = tops.warp_features_onehot_bwd(feats, dx, g, max_neg, 4)
    other = tops.warp_features_bwd_cuda(feats, dx, g, max_neg, 4)
    for a, b, c, name in zip(got, want, other, ("dfeats", "ddx")):
        _close(a, b, name)
        _close(a, c, f"{name} against warp_features_bwd")
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert none is None and torch.equal(only_dx, got[1])
    assert not bool(got[1][(dx < -max_neg) | (dx > 4)].any())


@pytest.mark.parametrize("kind", ["image", "features"])
def test_tiled_offset_gradient_has_no_window_limit(dev, kind):
    """An offset gradient alone whose clip window the earlier, staged
    kernel refused: 16 channels of (4,000 + 128 + 1 or 5) columns, 264 KB,
    over the 227 KB of shared memory a block can use. It runs and matches
    the plain version."""
    shape, bound = ((1, 16, 2, 5000), 4000) if kind == "image" else ((1, 16, 2, 7000), 4000)
    src = _normal(shape, 35, dev)
    g = _normal(shape, 36, dev)
    if kind == "image":
        off = _uniform((1, 1, *shape[2:]), 37, dev, -20.0, bound + 40.0)
        none, got = tops.warp_image_mxu_bwd(src, off, g, bound, need_img=False)
        want = tops.warp_image_onehot_bwd(src, off, g, bound)[1]
    else:
        off = _uniform((1, 1, *shape[2:]), 37, dev, -bound - 10.0, 10.0)
        none, got = tops.warp_features_mxu_bwd(src, off, g, bound, 4, need_feats=False)
        want = tops.warp_features_onehot_bwd(src, off, g, bound, 4)[1]
    torch.cuda.synchronize()
    assert none is None
    _close(got, want, f"{kind} offset gradient")


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


# ------------------------------------------------ the tiled source gradient


def _pile_up(dx, max_neg, max_pos):
    """Row 0: every output lands on columns 3 and 4; row 1: on column 2
    (its second tap, on column 3, has weight 0); row 2: on column 0 from
    the left (tap 0 outside the row, both taps clamped to column 0)."""
    xs = torch.arange(dx.shape[3], device=dx.device, dtype=torch.float32)
    for row, at in ((0, 3.5), (1, 2.0), (2, -0.5)):
        dx[:, 0, row] = (at - xs).clamp(-max_neg, max_pos)


# a pile-up of a row's outputs on one or two columns; offsets on the
# window's bounds, at 0 and right of the row at MADNet's scale 2; C = 1,
# 17, 130 and 300 (two and three groups of 128 channels); B = 2; rows past the 227 KB
# of shared memory the earlier row buffer could hold (W = 8,000 and 9,000,
# the second with a window of 306 outputs, two passes of 256)
_SOURCE_CASES = [
    ((1, 8, 3, 60), 64, True), ((2, 5, 4, 140), 140, True), ((1, 32, 80, 304), 48, False),
    ((1, 1, 6, 38), 6, False), ((1, 17, 5, 33), 12, False), ((1, 130, 10, 38), 6, False),
    ((1, 300, 4, 38), 6, False), ((2, 17, 4, 76), 12, False), ((1, 9, 2, 8000), 20, False),
    ((1, 16, 2, 9000), 300, False),
]


@pytest.mark.parametrize("shape,max_neg,pile", _SOURCE_CASES)
def test_tiled_source_gradient_matches_plain_and_clamped_kernels(dev, shape, max_neg, pile):
    """The source gradient alone (MAD's variant of the feature warp)
    against the plain version and ``warp_features_bwd``; the same bits as
    in both gradients together (FULL's variant); two runs agree bit for
    bit; one launch a call."""
    feats = _normal(shape, 50, dev)
    dx = _uniform((shape[0], 1, *shape[2:]), 51, dev, -max_neg - 10.0, 10.0)
    dx[..., 2::7] = -float(max_neg)
    dx[..., 3::8] = 0.0
    dx[..., 4::9] = 4.0
    dx[..., -3:] = 2.5  # samples right of the row: a weight on a pad column
    if pile:
        _pile_up(dx, max_neg, 4)
    g = _normal(shape, 52, dev)
    before = cuda_lib.LAUNCHES["warp_tile_features_bwd"]
    got, none = tops.warp_features_mxu_bwd(feats, dx, g, max_neg, 4, need_dx=False)
    again, _ = tops.warp_features_mxu_bwd(feats, dx, g, max_neg, 4, need_dx=False)
    both, _ = tops.warp_features_mxu_bwd(feats, dx, g, max_neg, 4)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["warp_tile_features_bwd"] == before + 3
    assert none is None
    want = tops.warp_features_onehot_bwd(feats, dx, g, max_neg, 4)[0]
    _close(got, want, "dfeats")
    _close(got, tops.warp_features_bwd_cuda(feats, dx, g, max_neg, 4)[0], "dfeats against warp_features_bwd")
    assert torch.equal(got, again) and torch.equal(got, both)
    if pile:  # the piled-up columns take every output of their rows
        for row, cols in ((0, slice(3, 5)), (1, slice(2, 3)), (2, slice(0, 1))):
            assert bool(want[:, :, row, cols].ne(0).all()) and bool(got[:, :, row, cols].ne(0).all())
            rest = torch.ones(shape[3], dtype=torch.bool, device=dev)
            rest[cols] = False
            assert not bool(want[:, :, row, rest].any()) and not bool(got[:, :, row, rest].any())


@pytest.mark.parametrize(
    "shape,max_disp", [((1, 3, 320, 1216), 192), ((2, 3, 4, 200), 192), ((1, 5, 2, 8200), 192)]
)
def test_tiled_image_source_gradient_matches_plain_and_clamped_kernels(dev, shape, max_disp):
    """The image instance of the source gradient, on no main path, at
    ``max_disp`` 192: disparities beyond both bounds, on them and at 0,
    against the plain version and ``warp_image_bwd``; bit-identical reruns."""
    img = _normal(shape, 53, dev)
    disp = _uniform((shape[0], 1, *shape[2:]), 54, dev, -20.0, max_disp + 40.0)
    disp[..., 3::11] = float(max_disp)
    disp[..., 5::13] = 0.0
    g = _normal(shape, 55, dev)
    got, none = tops.warp_image_mxu_bwd(img, disp, g, max_disp, need_disp=False)
    again, _ = tops.warp_image_mxu_bwd(img, disp, g, max_disp, need_disp=False)
    torch.cuda.synchronize()
    assert none is None
    _close(got, tops.warp_image_onehot_bwd(img, disp, g, max_disp)[0], "dimg")
    _close(got, tops.warp_image_bwd_cuda(img, disp, g, max_disp)[0], "dimg against warp_image_bwd")
    assert torch.equal(got, again)


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


# ------------------------------------------------ bf16: the precision modes


def _bf16_normal(shape, seed, dev):
    return _normal(shape, seed, dev).bfloat16()


def _assert_bf16_close(got, want, abs_terms, n_terms, what):
    """Every entry of bf16 ``got`` within one bf16 ulp of ``want``'s, plus
    what two fp32 sums of ``n_terms`` terms in other orders may differ by,
    2 (n_terms + 2) 2^-24 times the sum of the terms' magnitudes
    (``abs_terms``): both sides round an fp32 sum once, and where the sum
    cancels its order moves the small result by more than a bf16 ulp."""
    assert got.dtype == want.dtype == torch.bfloat16, what
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp(min=2.0**-126)
    tol = torch.exp2(torch.floor(torch.log2(mag)) - 7) + 2.0 * (n_terms + 2) * 2.0**-24 * abs_terms
    bad = (g - w).abs() > tol
    assert not bool(bad.any()), f"{what}: {int(bad.sum())} entries beyond the tolerance"


def _assert_corr_bf16(x, y, g, radius, out, dx, dy):
    """Forward and gradients of the bf16 instances against the plain versions."""
    xa, ya, ga = x.float().abs(), y.float().abs(), g.float().abs()
    _assert_bf16_close(out, tops.correlation_torch(x, y, radius), tops.correlation_torch(xa, ya, radius),
                       x.shape[1], "forward")
    want = tops.correlation_torch_bwd(x, y, g, radius)
    terms = tops.correlation_torch_bwd(xa, ya, ga, radius)
    for got, w, t, nm in zip((dx, dy), want, terms, ("dx", "dy")):
        _assert_bf16_close(got, w, t, 2 * radius + 1, nm)


# MADNet's scales, the register radii at an edge shape, DispNet's call and
# the wide kernels' edges: W < 2R+1, two and three chunks of shifts
_BF16_CASES = [
    ((1, 192, 5, 19), 2), ((1, 32, 80, 304), 2), ((2, 7, 5, 37), 1), ((2, 7, 5, 37), 3),
    ((1, 3, 2, 3), 4), ((1, 128, 80, 304), 40), ((1, 128, 5, 19), 40), ((2, 7, 3, 70), 40),
    ((1, 5, 2, 140), 50), ((1, 70, 2, 200), 100),
]


@pytest.mark.parametrize("shape,radius", _BF16_CASES)
def test_corr_bf16_instances_match_plain(dev, shape, radius):
    """bf16 inputs launch the bf16 instances, counted under their own
    names; forward and backward against the plain versions (fp32 sums, one
    rounding) within :func:`_assert_bf16_close`, the backward bit-identical
    in two runs. An fp32 gradient (a downstream promotion) is cast to bf16."""
    x, y = _bf16_normal(shape, 41, dev), _bf16_normal(shape, 42, dev)
    g = _bf16_normal((shape[0], 2 * radius + 1, *shape[2:]), 43, dev)
    xg, yg = x.clone().requires_grad_(), y.clone().requires_grad_()
    cuda_lib.reset_launches()
    out = tops.correlation(xg, yg, radius)
    dx, dy = torch.autograd.grad(out, (xg, yg), g.float())
    dx2, dy2 = tops.correlation_bwd_cuda(x, y, g, radius)
    torch.cuda.synchronize()
    wide = "_wide" if radius > MAX_REGISTER_RADIUS else ""
    assert {k: v for k, v in cuda_lib.LAUNCHES.items() if v} == {
        f"corr_fwd{wide}_bf16": 1, f"corr_bwd{wide}_bf16": 2}
    _assert_corr_bf16(x, y, g, radius, out, dx, dy)
    assert torch.equal(dx, dx2) and torch.equal(dy, dy2)


@pytest.mark.parametrize("shape", [(1, 192, 5, 19), (1, 32, 80, 304)])
def test_corr_wide_bf16_instances_take_a_register_radius(dev, shape):
    x, y = _bf16_normal(shape, 44, dev), _bf16_normal(shape, 45, dev)
    g = _bf16_normal((shape[0], 5, *shape[2:]), 46, dev)
    cuda_lib.reset_launches()
    _assert_corr_bf16(x, y, g, 2, tops.correlation_cuda(x, y, 2, wide=True),
                      *tops.correlation_bwd_cuda(x, y, g, 2, wide=True))
    assert {k: v for k, v in cuda_lib.LAUNCHES.items() if v} == {"corr_fwd_wide_bf16": 1, "corr_bwd_wide_bf16": 1}


def test_wrappers_reject_mixed_dtypes(dev):
    x = _normal((1, 4, 3, 8), 47, dev)
    g = torch.zeros(1, 5, 3, 8, device=dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tops.correlation_cuda(x, x.bfloat16(), 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tops.correlation_bwd_cuda(x.bfloat16(), x.bfloat16(), g, 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tops.correlation_cuda(x.half(), x.half(), 2)
    with pytest.raises(TypeError, match="float32 only"):
        tops.warp_features_cuda(x.bfloat16(), torch.zeros(1, 1, 3, 8, device=dev), 8, 4)
    with pytest.raises(TypeError, match="float32 only"):
        tops.warp_image_mxu(x[:, :3].bfloat16(), torch.zeros(1, 1, 3, 8, device=dev), 8)


@pytest.mark.parametrize("name", ["MADNet", "Dispnet"])
def test_models_under_bf16_act_launch_the_bf16_instances(dev, name):
    """A forward and backward of each model under 'bf16_act': every
    correlation runs a bf16 instance, none an fp32 one; the feature warps
    run their fp32 kernels on the widened features; MADNet's disparities
    are fp32, DispNet's bf16, as the reference's."""
    left = _uniform((1, 128, 256, 3), 48, dev, 0.0, 255.0)
    right = torch.roll(left, -4, dims=2)
    with tops.conv_precision("bf16_act"):
        assert not torch.backends.cudnn.allow_tf32
        model = get_stereo_net(name, seed=0)
        cuda_lib.reset_launches()
        out = model(left, right)
        sum(d.float().mean() for d in out["disparities"]).backward()
    torch.cuda.synchronize()
    launched = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    if name == "MADNet":
        assert launched == {"corr_fwd_bf16": 5, "corr_bwd_bf16": 5, "warp_features_fwd": 4, "warp_features_bwd": 4}
        assert all(d.dtype == torch.float32 for d in out["disparities"])
    else:
        assert launched == {"corr_fwd_wide_bf16": 1, "corr_bwd_wide_bf16": 1}
        assert all(d.dtype == torch.bfloat16 for d in out["disparities"])
    assert all(bool(torch.isfinite(d.float()).all()) for d in out["disparities"])
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in model.parameters())


def test_fused_session_under_bf16_act_refuses_a_changed_mode(dev):
    """A fused session captured under 'bf16_act' replays that mode, so a
    step under another mode raises instead of replaying a stale graph."""
    from real_time_self_adaptive_deep_stereo_torch.adapt import AdaptationEngine, FusedOnlineSession

    frames = _smooth_frames(3, 128, 256, 32)
    with tops.conv_precision("bf16_act"):
        eng = AdaptationEngine(get_stereo_net("MADNet", warp_mode="mxu", seed=0), warp_mode="mxu")
        sess = FusedOnlineSession(eng, mode="NONE", compute_metrics=False)
        cuda_lib.reset_launches()
        sess.step(frames[0])  # eager, then the capture
        sess.step(frames[1])  # a replay
        torch.cuda.synchronize()
        assert {k: v for k, v in cuda_lib.LAUNCHES.items() if v} == {
            "corr_fwd_bf16": 10, "warp_tile_features_fwd": 8}
    with pytest.raises(RuntimeError, match="bf16_act"):
        sess.step(frames[2])
    assert not torch.backends.cudnn.allow_tf32


# ---------------------------------------------- corr_fwd's channel slices

_MADNET_CORR = [(1, 192, 5, 19), (1, 128, 10, 38), (1, 96, 20, 76), (1, 64, 40, 152), (1, 32, 80, 304)]
# MADNet's five calls at 320x1216, and the edges of the slices: C = 1, 3
# and 1000 (one slice, three, 32 of 32 channels), W = 3 < 2R+1, H = 1 with B = 2
_CORR_FWD_CASES = [(shape, 2) for shape in _MADNET_CORR] + [
    ((1, 1, 5, 19), 2), ((1, 3, 4, 37), 3), ((1, 1000, 3, 11), 2), ((1, 8, 4, 3), 2), ((1, 8, 4, 3), 4),
    ((2, 16, 1, 40), 1),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,radius", _CORR_FWD_CASES)
def test_corr_fwd_slices_match_plain(dev, shape, radius, dtype):
    """``corr_fwd`` and ``corr_fwd_bf16`` against the plain version (fp32:
    1e-5; bf16: :func:`_assert_bf16_close`), one launch a call, two runs
    bit for bit."""
    x, y = _normal(shape, 56, dev).to(dtype), _normal(shape, 57, dev).to(dtype)
    name = "corr_fwd_bf16" if dtype == torch.bfloat16 else "corr_fwd"
    before = cuda_lib.LAUNCHES[name]
    got = tops.correlation_cuda(x, y, radius)
    again = tops.correlation_cuda(x, y, radius)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[name] == before + 2
    assert got.dtype == dtype and torch.equal(got, again)
    want = tops.correlation_torch(x, y, radius)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        terms = tops.correlation_torch(x.float().abs(), y.float().abs(), radius)
        _assert_bf16_close(got, want, terms, shape[1], "forward")
