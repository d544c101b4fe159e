"""Gradients of the PyTorch port's ops against the JAX package on the CPU.

The port's CUDA backward kernels (``corr_bwd``, ``warp_image_bwd``,
``warp_features_bwd``) run only on a GPU; here their plain PyTorch
versions are held against ``jax.vjp`` of the JAX functions, with the
Pallas kernels run in interpret mode. Inputs and cotangents are made with
numpy from a seed and handed to both packages; the port's op-level
functions take NCHW, so the tests transpose.

Tolerance: 1e-5 of the largest entry of the gradient compared (fp32 sums
taken in another order).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch import ops as tops
from real_time_self_adaptive_deep_stereo_tpu.ops import warp as jwarp
from real_time_self_adaptive_deep_stereo_tpu.ops import warp_pallas as jpallas
from real_time_self_adaptive_deep_stereo_tpu.ops.correlation import (
    correlation_jnp,
    correlation_pallas,
)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x_nhwc):
    """numpy NHWC -> torch NCHW."""
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=what)


def _jax_vjp(fn, a, b, g):
    _, vjp = jax.vjp(fn, jnp.asarray(a), jnp.asarray(b))
    return vjp(jnp.asarray(g))


def _autograd(fn, a, b, g):
    """Gradients of the port's ``fn`` (NCHW) through autograd, back in NHWC."""
    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    da, db = torch.autograd.grad(fn(ta, tb), (ta, tb), _t(g))
    return _nhwc(da), _nhwc(db)


# ---------------------------------------------------------------- correlation


@pytest.mark.parametrize("radius", [1, 2, 3, 4])
def test_correlation_bwd_matches_jax(radius):
    r = _rng(radius)
    x = r.normal(size=(2, 5, 23, 12)).astype(np.float32)
    y = r.normal(size=(2, 5, 23, 12)).astype(np.float32)
    g = r.normal(size=(2, 5, 23, 2 * radius + 1)).astype(np.float32)
    want_p = _jax_vjp(lambda a, b: correlation_pallas(a, b, radius, True), x, y, g)
    want_j = _jax_vjp(lambda a, b: correlation_jnp(a, b, radius), x, y, g)
    dx, dy = tops.correlation_torch_bwd(_t(x), _t(y), _t(g), radius)
    for want in (want_p, want_j):
        _close(_nhwc(dx), want[0], "dx")
        _close(_nhwc(dy), want[1], "dy")
    # autograd through the plain forward, and through the kernel wrapper,
    # which on CPU tensors is that plain forward
    for fn in (tops.correlation_torch, tops.correlation_cuda):
        ax, ay = _autograd(lambda a, b: fn(a, b, radius), x, y, g)
        _close(ax, want_p[0], "autograd dx")
        _close(ay, want_p[1], "autograd dy")


def test_correlation_bwd_narrower_than_the_window():
    """W = 3 with radius 4: every shift but the centre runs off the row."""
    r = _rng(5)
    x = r.normal(size=(1, 2, 3, 4)).astype(np.float32)
    y = r.normal(size=(1, 2, 3, 4)).astype(np.float32)
    g = r.normal(size=(1, 2, 3, 9)).astype(np.float32)
    want = _jax_vjp(lambda a, b: correlation_jnp(a, b, 4), x, y, g)
    dx, dy = tops.correlation_torch_bwd(_t(x), _t(y), _t(g), 4)
    _close(_nhwc(dx), want[0], "dx")
    _close(_nhwc(dy), want[1], "dy")


# ----------------------------------------------------------------------- warp


def _img_case(seed, w, max_disp):
    r = _rng(seed)
    img = r.normal(size=(2, 4, w, 3)).astype(np.float32)
    # crosses below 0 and above max_disp, never exactly on a bound
    disp = (r.random((2, 4, w, 1)) * (max_disp + 12) - 6).astype(np.float32)
    assert disp.min() < 0 and disp.max() > max_disp
    g = r.normal(size=img.shape).astype(np.float32)
    return img, disp, g


def _feat_case(seed, w, max_neg, max_pos=4):
    r = _rng(seed)
    feats = r.normal(size=(1, 4, w, 6)).astype(np.float32)
    dx = (r.random((1, 4, w, 1)) * -(max_neg + max_pos + 10) + max_pos + 5).astype(np.float32)
    assert dx.min() < -max_neg and dx.max() > max_pos
    g = r.normal(size=feats.shape).astype(np.float32)
    return feats, dx, g


@pytest.mark.parametrize("w,max_disp", [(150, 32), (20, 32)])
def test_warp_image_bwd_matches_pallas_and_shift(w, max_disp):
    """The plain backward of the image warp against the Pallas backward
    kernel (interpret mode) and against autodiff of the shift form, with
    offsets beyond both ends of the window and a row narrower than it."""
    img, disp, g = _img_case(11, w, max_disp)
    want_p = _jax_vjp(lambda a, b: jpallas.warp_image_pallas(a, b, max_disp, True), img, disp, g)
    want_s = _jax_vjp(lambda a, b: jwarp.warp_image_shift(a, b, max_disp), img, disp, g)
    dimg, ddisp = tops.warp_image_clamped_bwd(_t(img), _t(disp), _t(g), max_disp)
    assert float(np.abs(np.asarray(want_p[1])).max()) > 0
    for want in (want_p, want_s):
        _close(_nhwc(dimg), want[0], "dimg")
        _close(_nhwc(ddisp), want[1], "ddisp")
    a_img, a_disp = _autograd(lambda a, b: tops.warp_image_cuda(a, b, max_disp), img, disp, g)
    np.testing.assert_array_equal(a_img, _nhwc(dimg))
    np.testing.assert_array_equal(a_disp, _nhwc(ddisp))


@pytest.mark.parametrize("w,max_neg", [(140, 20), (12, 20)])
def test_warp_features_bwd_matches_pallas_and_shift(w, max_neg):
    feats, dx, g = _feat_case(12, w, max_neg)
    want_p = _jax_vjp(
        lambda a, b: jpallas.warp_features_pallas(a, b, max_neg, 4, True), feats, dx, g
    )
    want_s = _jax_vjp(
        lambda a, b: jwarp.warp_features_horizontal_shift(a, b, max_neg, 4), feats, dx, g
    )
    dfeats, ddx = tops.warp_features_clamped_bwd(_t(feats), _t(dx), _t(g), max_neg, 4)
    assert float(np.abs(np.asarray(want_p[1])).max()) > 0
    for want in (want_p, want_s):
        _close(_nhwc(dfeats), want[0], "dfeats")
        _close(_nhwc(ddx), want[1], "ddx")
    a_f, a_dx = _autograd(lambda a, b: tops.warp_features_cuda(a, b, max_neg, 4), feats, dx, g)
    np.testing.assert_array_equal(a_f, _nhwc(dfeats))
    np.testing.assert_array_equal(a_dx, _nhwc(ddx))


def test_gather_warps_bwd_match_jax():
    img, disp, g = _img_case(13, 50, 32)
    want = _jax_vjp(jwarp.warp_image, img, disp, g)
    got = _autograd(tops.warp_image, img, disp, g)
    _close(got[0], want[0], "dimg")
    _close(got[1], want[1], "ddisp")
    feats, dx, g = _feat_case(14, 50, 20)
    want = _jax_vjp(jwarp.warp_features_horizontal, feats, dx, g)
    got = _autograd(tops.warp_features_horizontal, feats, dx, g)
    _close(got[0], want[0], "dfeats")
    _close(got[1], want[1], "ddx")


def test_offsets_on_the_clip_bounds_follow_the_kernel_rule():
    """At an offset exactly on a clip bound the Pallas kernels' inclusive
    masks pass the whole gradient; so does ``torch.clamp`` in the plain
    versions. The JAX shift forms (``jnp.clip``) halve it there, which is
    why the other comparisons keep offsets off the bounds."""
    img, disp, g = _img_case(15, 64, 32)
    ties = np.zeros(disp.shape, bool)
    ties[:, :, 40::3] = True  # columns whose taps at x - 32 stay inside the row
    disp[ties] = 32.0
    want_p = _jax_vjp(lambda a, b: jpallas.warp_image_pallas(a, b, 32, True), img, disp, g)
    want_s = _jax_vjp(lambda a, b: jwarp.warp_image_shift(a, b, 32), img, disp, g)
    _, ddisp = tops.warp_image_clamped_bwd(_t(img), _t(disp), _t(g), 32)
    _close(_nhwc(ddisp), want_p[1], "ddisp, image warp")
    assert np.abs(np.asarray(want_p[1])[ties]).min() > 0
    np.testing.assert_allclose(
        np.asarray(want_s[1])[ties], 0.5 * np.asarray(want_p[1])[ties], rtol=1e-4, atol=1e-6
    )

    feats, dx, g = _feat_case(17, 64, 20)
    ties = np.zeros(dx.shape, bool)
    ties[:, :, 30:56:5] = True  # columns where both taps stay inside the row
    dx[ties] = np.where(_rng(18).random(int(ties.sum())) < 0.5, -20.0, 4.0)
    want_p = _jax_vjp(lambda a, b: jpallas.warp_features_pallas(a, b, 20, 4, True), feats, dx, g)
    _, ddx = tops.warp_features_clamped_bwd(_t(feats), _t(dx), _t(g), 20, 4)
    _close(_nhwc(ddx), want_p[1], "ddx, feature warp")
    assert np.abs(np.asarray(want_p[1])[ties]).min() > 0


def test_image_warp_at_zero_disparity_takes_the_gather_derivative():
    """At a disparity of exactly 0 the right tap x + 1 has weight 0. The
    Pallas kernel and the shift form never visit it (shift -1 lies
    outside their sweep 0..max_disp), so their ``ddisp`` there is
    ``sum_c g * v0``. The port's plain version and kernel keep both taps
    and return ``sum_c g * (v0 - v1)``, the derivative of the gather form
    ``warp_image``. On the main path such pixels come out of a relu whose
    own gradient is 0 there."""
    img, disp, g = _img_case(20, 48, 32)
    zero = np.zeros(disp.shape, bool)
    zero[:, :, 3:40:4] = True
    disp[zero] = 0.0
    want_g = _jax_vjp(jwarp.warp_image, img, disp.clip(0, 32), g)
    want_p = _jax_vjp(lambda a, b: jpallas.warp_image_pallas(a, b, 32, True), img, disp, g)
    dimg, ddisp = tops.warp_image_clamped_bwd(_t(img), _t(disp), _t(g), 32)
    inside = (disp >= 0) & (disp <= 32)
    _close(_nhwc(ddisp), np.asarray(want_g[1]) * inside, "ddisp vs the gather form")
    _close(_nhwc(dimg), want_p[0], "dimg")  # the zero-weight tap adds nothing to dimg
    v1 = np.roll(img, -1, axis=2)  # the tap x + 1 (no pixel of `zero` is in the last column)
    gap = np.asarray(want_p[1]) - _nhwc(ddisp)
    _close(gap[zero], (g * v1).sum(-1, keepdims=True)[zero], "what the Pallas kernel leaves out")
    assert np.abs(gap[~zero]).max() <= 1e-5 * np.abs(np.asarray(want_p[1])).max()


# ------------------------------------------- the CUDA kernels' source gradient


def _taps(off, w, image, lo, hi):
    """float32 mirror of ``image_tap`` / ``feature_tap`` in csrc/warp.cu
    for offsets [B,1,H,W]: weights and clamped columns of both taps."""
    xs = np.arange(w, dtype=np.float32)
    if image:
        cx = xs - np.clip(off, np.float32(0), np.float32(hi))
    else:
        cx = xs + np.clip(off, np.float32(-lo), np.float32(hi))
    x0 = np.floor(cx)
    x1 = x0 + 1
    if image:
        w1 = cx - x0
        w0 = 1 - w1
    else:
        w0 = (x1 - cx) * ((x0 >= 0) & (x0 <= w - 1))
        w1 = (cx - x0) * ((x1 >= 0) & (x1 <= w - 1))
    i0 = np.clip(x0, 0, w - 1).astype(np.int64)
    i1 = np.clip(x1, 0, w - 1).astype(np.int64)
    return w0.astype(np.float32), w1.astype(np.float32), i0, i1


def _image_source_gradient_by_walk(off, g, hi):
    """What ``warp_bwd_source_kernel<true>`` computes (NCHW numpy): the
    thread of source column v walks the outputs x in [v - 1, v + ceil(hi)]
    in increasing x and adds w * g where a tap's clamped column equals v."""
    w = g.shape[3]
    back, ahead = 1, math.ceil(hi)
    w0, w1, i0, i1 = _taps(off, w, True, 0, hi)
    dsrc = np.zeros_like(g)
    for v in range(w):
        for x in range(max(v - back, 0), min(v + ahead, w - 1) + 1):
            wgt = w0[..., x] * (i0[..., x] == v) + w1[..., x] * (i1[..., x] == v)  # [B,1,H]
            dsrc[..., v] += wgt * g[..., x]
    return dsrc


_WORD, _PASS = 32, 256  # outputs of a mask word, and of a pass (8 words)


def _feature_source_gradient_by_masks(off, g, lo, hi):
    """What ``feat_bwd_source_kernel`` computes (NCHW numpy), step by step,
    on the flattened H*W plane: column p is reached by the candidates
    [p - ahead, p + back] (ahead = floor(hi) + 1, back = ceil(lo)), taken
    as whole 32-output words; their taps are plane columns, and a tap of
    weight 0 is cropped. Per pass of 256 candidates the mask of those whose
    tap lands on p is built, then walked in increasing order, adding w * g
    for every channel."""
    b, c, h, w = g.shape
    n = h * w
    back, ahead = math.ceil(lo), math.floor(hi) + 1
    n_cands = (back + ahead + _WORD) // _WORD * _WORD
    w0, w1, i0, i1 = (a.reshape(b, n) for a in _taps(off, w, False, lo, hi))
    row = np.arange(n) // w * w
    t0 = np.where(w0 != 0, row + i0, -1)  # -1: cropped, lands on no column
    t1 = np.where(w1 != 0, row + i1, -1)
    gp = g.reshape(b, c, n)
    dsrc = np.zeros((b, c, n), np.float32)
    for p in range(n):
        for first in range(0, n_cands, _PASS):
            q = p - ahead + np.arange(first, min(first + _PASS, n_cands))
            q = q[(q >= 0) & (q < n)]
            for k in range(b):
                mask = (t0[k, q] == p) | (t1[k, q] == p)
                for x in q[mask]:  # increasing
                    wgt = w0[k, x] if t0[k, x] == p else w1[k, x]
                    dsrc[k, :, p] += wgt * gp[k, :, x]
    return dsrc.reshape(g.shape)


@pytest.mark.parametrize(
    "image,w,lo,hi",
    [(True, 70, 0, 24), (True, 10, 0, 24), (False, 70, 12, 4), (False, 9, 12, 4)],
    ids=["image", "image-narrow", "features", "features-narrow"],
)
def test_source_gradient_walk_covers_every_contribution(image, w, lo, hi):
    """The CUDA source-gradient kernels are gathers over a bounded walk
    instead of a scatter. This emulation of each walk in numpy (the image
    warp's column walk; the feature warp's candidates, masks and passes)
    equals the transpose that autograd computes, so the bounds miss no
    contribution: offsets lie beyond both ends of the window, and in the
    narrow cases the row is shorter than the walk."""
    r = _rng(19)
    src = r.normal(size=(2, 3, 4, w)).astype(np.float32)  # NCHW
    off = (r.random((2, 1, 4, w)) * (lo + hi + 16) - lo - 8).astype(np.float32)
    assert off.min() < -lo and off.max() > hi
    g = r.normal(size=src.shape).astype(np.float32)
    args = [torch.from_numpy(a) for a in (src, off, g)]
    if image:
        want, _ = tops.warp_image_clamped_bwd(*args, hi)
        got = _image_source_gradient_by_walk(off, g, hi)
    else:
        want, _ = tops.warp_features_clamped_bwd(*args, lo, hi)
        got = _feature_source_gradient_by_masks(off, g, lo, hi)
    _close(got, want.numpy(), "dsrc")
    if image:  # the fold: column 0 collects everything sampled left of the row
        assert np.abs(got[..., 0]).max() > np.abs(got[..., 1:]).mean()


def _piled(w, sign, reach, seed):
    """Offsets [1,1,3,w] that put every output's sample beyond one end of
    the row: left (sign -1, cx = -u) or right (sign +1, cx = w - 1 + u),
    u in [0, reach); a third of them lands within one column of the end,
    where one tap keeps its weight on column 0 or W - 1."""
    r = _rng(seed)
    u = (r.random((1, 1, 3, w)) * reach).astype(np.float32)
    u[..., ::3] = (r.random((1, 1, 3, w))[..., ::3] * 0.9).astype(np.float32)
    xs = np.arange(w, dtype=np.float32)
    return (-xs - u) if sign < 0 else (w - 1 - xs + u)


@pytest.mark.parametrize(
    "w,lo,hi,kind",
    [(20, 40, 4, "left"), (20, 6, 25, "right"), (1, 6, 4, "random"), (320, 300, 4, "random")],
    ids=["features-pile-left", "features-pile-right", "features-w1", "features-window-306"],
)
def test_feature_source_gradient_masks_match_the_pallas_kernel(w, lo, hi, kind):
    """The feature warp's source gradient by candidates, masks and passes
    (the emulation above) against the Pallas backward kernel in interpret
    mode and the plain version, where the walk is hardest: every output
    sampling left of the row (its taps of weight 0 clamp to column 0) or
    right of it (to column W - 1), W = 1, and a window of 306 outputs, two
    passes of 256."""
    r = _rng(23)
    feats = r.normal(size=(1, 2, 3, w)).astype(np.float32)  # NCHW
    if kind == "random":
        off = (r.random((1, 1, 3, w)) * (lo + hi + 16) - lo - 8).astype(np.float32)
        off[..., ::4] = np.float32(-0.5) if w == 1 else np.float32(-lo)
    else:
        off = _piled(w, -1 if kind == "left" else 1, 3.0, 24)
        assert (off < -np.arange(w) if kind == "left" else off > w - 1 - np.arange(w)).any()
    g = r.normal(size=feats.shape).astype(np.float32)
    nhwc = [a.transpose(0, 2, 3, 1) for a in (feats, off, g)]
    want = _jax_vjp(lambda a, b: jpallas.warp_features_pallas(a, b, lo, hi, True), *nhwc)[0]
    want = np.asarray(want).transpose(0, 3, 1, 2)
    assert np.abs(want).max() > 0
    got = _feature_source_gradient_by_masks(off, g, lo, hi)
    _close(got, want, "dfeats against the Pallas kernel")
    plain, _ = tops.warp_features_clamped_bwd(*(torch.from_numpy(a) for a in (feats, off, g)), lo, hi)
    _close(got, plain.numpy(), "dfeats against the plain version")
    if kind != "random":  # a pile: only the end column takes a gradient
        end = 0 if kind == "left" else w - 1
        rest = np.ones(w, bool)
        rest[end] = False
        assert np.abs(got[..., end]).max() > 0 and not got[..., rest].any()
