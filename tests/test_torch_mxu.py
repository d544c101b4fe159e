"""The port's one-hot warps and the CPU route of the tiled-kernel
wrappers against the JAX package on the CPU.

The JAX tiled kernels (``warp_image_mxu`` / ``warp_features_mxu``, Pallas)
run in interpret mode, as the JAX package's own tests run them; the JAX
one-hot functions run as they are. The port's ``*_mxu`` wrappers take the
plain route on CPU tensors: the one-hot functions with ``align=128``,
which clamp to the padded width as the tiled kernels do.

Inputs come from a numpy seed. Offsets go beyond both clip bounds, sit
exactly on them (where the tiled kernels and ``torch.clamp`` pass the
gradient; ``jnp.clip`` in the JAX one-hot functions halves it there, so
those are compared off the bounds), and include a disparity of exactly 0.

Tolerances: values 1e-5 absolute on unit-normal sources (the two
packages round ``w0*a + w1*b`` at different places), gradients 1e-4
relative plus 1e-5 absolute, the figures of the JAX package's own tests
of these kernels against its gather forms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch import ops as tops
from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net as torch_net
from real_time_self_adaptive_deep_stereo_torch.ops import warp as twarp
from real_time_self_adaptive_deep_stereo_torch.utils import checkpoint as tckpt
from real_time_self_adaptive_deep_stereo_tpu.models import get_stereo_net as jax_net
from real_time_self_adaptive_deep_stereo_tpu.ops import warp as jwarp
from real_time_self_adaptive_deep_stereo_tpu.ops import warp_pallas as jpallas

VAL_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _image_case(w, seed, on_bounds):
    """[1,6,w,3] image and a disparity in [-8, max_disp + 8] with max_disp
    = 24; ``on_bounds`` plants 0 and 24 exactly, also in the last column."""
    r = np.random.default_rng(seed)
    img = r.normal(size=(1, 6, w, 3)).astype(np.float32)
    disp = (r.random((1, 6, w, 1)) * 40 - 8).astype(np.float32)
    if on_bounds:
        disp[0, 0, 5::7] = 0.0
        disp[0, 1, 3::5] = 24.0
        disp[0, 2, -1] = 0.0  # the tap that reads the pad column
        disp[0, 3, 0] = 0.0
    g = r.normal(size=img.shape).astype(np.float32)
    return img, disp, g, 24


def _feature_case(w, seed, on_bounds):
    """[1,5,w,6] features and an offset in [-20, 10] with window [-12, 4]."""
    r = np.random.default_rng(seed)
    feats = r.normal(size=(1, 5, w, 6)).astype(np.float32)
    dx = (r.random((1, 5, w, 1)) * 30 - 20).astype(np.float32)
    if on_bounds:
        dx[0, 0, 2::7] = -12.0
        dx[0, 1, 3::5] = 4.0
        dx[0, 2, 1::4] = 0.0
        dx[0, 3, -3:] = 2.5  # samples right of the row
    g = r.normal(size=feats.shape).astype(np.float32)
    return feats, dx, g, 12, 4


def _jax_vjp(fn, src, off, g):
    out, vjp = jax.vjp(fn, jnp.asarray(src), jnp.asarray(off))
    dsrc, doff = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(dsrc), np.asarray(doff)


def _torch_vjp(fn, src, off, g):
    s, o = _nchw(src).requires_grad_(), _nchw(off).requires_grad_()
    out = fn(s, o)
    assert out.dtype == torch.float32
    dsrc, doff = torch.autograd.grad(out, (s, o), _nchw(g))
    return _nhwc(out), _nhwc(dsrc), _nhwc(doff)


def _assert_triple(got, want, what):
    for a, b, name, tol in zip(got, want, ("out", "dsrc", "doff"), (VAL_TOL, GRAD_TOL, GRAD_TOL)):
        np.testing.assert_allclose(a, b, err_msg=f"{what} {name}", **tol)


@pytest.mark.parametrize("w", [200, 140, 256])
def test_image_mxu_route_matches_jax_mxu_interpret(w):
    img, disp, g, s = _image_case(w, 100 + w, on_bounds=True)
    want = _jax_vjp(lambda i, d: jpallas.warp_image_mxu(i, d, s, True), img, disp, g)
    got = _torch_vjp(lambda i, d: tops.warp_image_mxu(i, d, s), img, disp, g)
    _assert_triple(got, want, f"image W={w}")
    # the backward wrapper alone gives the same, and skips what is not asked for
    dimg, ddisp = tops.warp_image_mxu_bwd(_nchw(img), _nchw(disp), _nchw(g), s)
    np.testing.assert_array_equal(_nhwc(dimg), got[1])
    np.testing.assert_array_equal(_nhwc(ddisp), got[2])
    assert tops.warp_image_mxu_bwd(_nchw(img), _nchw(disp), _nchw(g), s, need_img=False)[0] is None
    # the gradient passes at a disparity exactly on a bound
    on0 = disp[0, 0, 5::7, 0] == 0.0
    assert on0.all() and np.abs(got[2][0, 0, 5::7, 0]).max() > 0
    assert np.abs(got[2][0, 1, 3::5, 0]).max() > 0
    # beyond the bounds it is cut
    assert not got[2][disp < 0].any() and not got[2][disp > s].any()
    if w % 128:
        # disparity 0 in the last column: the second tap reads the zero pad
        # column, so ddisp is g*v0 summed over the channels, in both packages
        manual = float((g[0, 2, -1] * img[0, 2, -1]).sum())
        np.testing.assert_allclose(got[2][0, 2, -1, 0], manual, rtol=1e-5)
        np.testing.assert_allclose(want[2][0, 2, -1, 0], manual, rtol=1e-5)


@pytest.mark.parametrize("w", [200, 140, 256])
def test_features_mxu_route_matches_jax_mxu_interpret(w):
    feats, dx, g, n, p = _feature_case(w, 200 + w, on_bounds=True)
    want = _jax_vjp(lambda f, d: jpallas.warp_features_mxu(f, d, n, p, True), feats, dx, g)
    got = _torch_vjp(lambda f, d: tops.warp_features_mxu(f, d, n, p), feats, dx, g)
    _assert_triple(got, want, f"features W={w}")
    dfeats, ddx = tops.warp_features_mxu_bwd(_nchw(feats), _nchw(dx), _nchw(g), n, p)
    np.testing.assert_array_equal(_nhwc(dfeats), got[1])
    np.testing.assert_array_equal(_nhwc(ddx), got[2])
    assert tops.warp_features_mxu_bwd(_nchw(feats), _nchw(dx), _nchw(g), n, p, need_dx=False)[1] is None
    assert np.abs(got[2][0, 0, 2::7, 0]).max() > 0 and np.abs(got[2][0, 1, 3::5, 0]).max() > 0
    assert not got[2][dx < -n].any() and not got[2][dx > p].any()


def test_features_mxu_route_matches_jax_mxu_interpret_on_a_deep_row():
    """A narrow, deep row as MADNet's scale 5 has it, 130 channels of 38
    columns (no multiple of the tiled offset gradient's slices of
    channels), both gradients, offsets beyond, on and inside the window
    [-6, 4] and right of the row."""
    r = np.random.default_rng(238)
    feats = r.normal(size=(1, 3, 38, 130)).astype(np.float32)
    dx = (r.random((1, 3, 38, 1)) * 20 - 13).astype(np.float32)
    dx[0, 0, 2::7] = -6.0
    dx[0, 1, 3::5] = 4.0
    dx[0, 2, -3:] = 2.5
    g = r.normal(size=feats.shape).astype(np.float32)
    want = _jax_vjp(lambda f, d: jpallas.warp_features_mxu(f, d, 6, 4, True), feats, dx, g)
    got = _torch_vjp(lambda f, d: tops.warp_features_mxu(f, d, 6, 4), feats, dx, g)
    _assert_triple(got, want, "features C=130 W=38")
    assert np.abs(got[2][0, 0, 2::7, 0]).max() > 0 and np.abs(got[2][0, 1, 3::5, 0]).max() > 0
    assert not got[2][dx < -6].any() and not got[2][dx > 4].any()


@pytest.mark.parametrize("w", [200, 140, 256])
def test_onehot_matches_jax_onehot_and_clamped(w):
    """The one-hot functions (real width) against the JAX one-hot
    functions, off the clip bounds, and against the port's clip-then-gather
    forms everywhere, bounds and a disparity of exactly 0 included."""
    img, disp, g, s = _image_case(w, 300 + w, on_bounds=False)
    want = _jax_vjp(lambda i, d: jwarp.warp_image_onehot(i, d, s), img, disp, g)
    got = _torch_vjp(lambda i, d: twarp.warp_image_onehot(i, d, s), img, disp, g)
    _assert_triple(got, want, f"image onehot W={w}")
    feats, dx, gf, n, p = _feature_case(w, 400 + w, on_bounds=False)
    want = _jax_vjp(lambda f, d: jwarp.warp_features_onehot(f, d, n, p), feats, dx, gf)
    got = _torch_vjp(lambda f, d: twarp.warp_features_onehot(f, d, n, p), feats, dx, gf)
    _assert_triple(got, want, f"features onehot W={w}")

    img, disp, g, s = _image_case(w, 500 + w, on_bounds=True)
    a = _torch_vjp(lambda i, d: twarp.warp_image_onehot(i, d, s), img, disp, g)
    b = _torch_vjp(lambda i, d: twarp.warp_image_clamped(i, d, s), img, disp, g)
    _assert_triple(a, b, f"image onehot vs clamped W={w}")
    feats, dx, gf, n, p = _feature_case(w, 600 + w, on_bounds=True)
    a = _torch_vjp(lambda f, d: twarp.warp_features_onehot(f, d, n, p), feats, dx, gf)
    b = _torch_vjp(lambda f, d: twarp.warp_features_clamped(f, d, n, p), feats, dx, gf)
    _assert_triple(a, b, f"features onehot vs clamped W={w}")


def test_disparity_zero_agrees_between_tiled_and_clamped_routes():
    """At a disparity of exactly 0 away from the last column the tiled
    route, the clip-then-gather route (the plain version of the
    ``warp_image_bwd`` kernel) and the JAX tiled kernel give the same
    ``ddisp = sum_c g*(v0 - v1)``."""
    img, disp, g, s = _image_case(200, 7, on_bounds=False)
    disp[...] = 0.0
    disp[0, :, -1] = 1.0  # keep the pad-column tap out of this comparison
    tiled = _torch_vjp(lambda i, d: tops.warp_image_mxu(i, d, s), img, disp, g)
    clamped = _torch_vjp(lambda i, d: twarp.warp_image_clamped(i, d, s), img, disp, g)
    jax_tiled = _jax_vjp(lambda i, d: jpallas.warp_image_mxu(i, d, s, True), img, disp, g)
    _assert_triple(tiled, clamped, "tiled vs clamped at 0")
    _assert_triple(tiled, jax_tiled, "tiled vs JAX tiled at 0")
    manual = (g[0, :, :-1] * (img[0, :, :-1] - img[0, :, 1:])).sum(-1)
    np.testing.assert_allclose(tiled[2][0, :, :-1, 0], manual, **GRAD_TOL)


def test_mxu_wrappers_refuse_what_the_kernels_do_not_take():
    img, disp = torch.zeros(1, 3, 4, 140), torch.zeros(1, 1, 4, 140)
    with pytest.raises(TypeError, match="float32"):
        tops.warp_image_mxu(img.double(), disp)
    with pytest.raises(TypeError, match="float32"):
        tops.warp_features_mxu_bwd(img, disp, img.half())
    with pytest.raises(ValueError, match="negative"):
        tops.warp_features_mxu(img, disp, max_neg=-1)
    assert tops.warp_image_mxu(img, disp).dtype == torch.float32


def test_resolve_warp_mode_knows_the_new_modes():
    cpu = torch.device("cpu")
    assert twarp.WARP_MODES == ("auto", "gather", "clamped", "cuda", "onehot", "mxu")
    assert twarp.resolve_warp_mode("mxu", cpu) == "mxu"
    assert twarp.resolve_warp_mode("onehot", cpu) == "onehot"
    assert twarp.resolve_warp_mode("auto", cpu) == "gather"
    # auto stays on the clamped-window kernels on a card
    assert twarp.resolve_warp_mode("auto", torch.device("cuda", 0)) == "cuda"
    with pytest.raises(ValueError, match="unknown warp mode"):
        twarp.resolve_warp_mode("pallas", cpu)
    img, disp = torch.rand(1, 3, 4, 40), torch.rand(1, 1, 4, 40) * 5
    for mode in ("mxu", "onehot"):
        torch.testing.assert_close(
            tops.warp_image_by_mode(img, disp, mode, 8), twarp.warp_image_clamped(img, disp, 8),
            rtol=1e-5, atol=1e-6,
        )
        torch.testing.assert_close(
            tops.warp_features_by_mode(img, disp - 3, mode, 2, 1),
            twarp.warp_features_clamped(img, disp - 3, 2, 1),
            rtol=1e-5, atol=1e-6,
        )


@pytest.mark.parametrize("mode", ["mxu", "onehot"])
def test_madnet_forward_with_tiled_warps_matches_jax(mode, monkeypatch):
    """Full-width MADNet at 60x120 with ``warp_mode`` 'mxu' / 'onehot' in
    both packages, the JAX tiled kernel in interpret mode: 1e-4 of the
    largest disparity, as for the other warp modes."""
    h, w = 60, 120
    net = jax_net("MADNet", corr_mode="jnp", warp_mode=mode)
    params = net.init(jax.random.PRNGKey(0))
    r = np.random.default_rng(0)
    left = (r.random((1, h, w, 3)) * 255).astype(np.float32)
    right = (r.random((1, h, w, 3)) * 255).astype(np.float32)
    orig = jpallas.warp_features_mxu
    monkeypatch.setattr(
        jpallas, "warp_features_mxu", lambda f, d, n=64, p=4: orig(f, d, n, p, True)
    )
    want = [np.asarray(d) for d in net.forward(params, jnp.asarray(left), jnp.asarray(right))["disparities"]]
    tnet = torch_net("MADNet", corr_mode="torch", warp_mode=mode, device="cpu")
    tnet.load_state_dict(tckpt.params_from_jax(params))
    with torch.no_grad():
        got = [d.numpy() for d in tnet(torch.from_numpy(left), torch.from_numpy(right))["disparities"]]
    assert len(got) == len(want) == 6
    for i, (a, b) in enumerate(zip(got, want)):
        scale = max(float(np.abs(b).max()), 1e-6)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * scale, err_msg=f"disparities[{i}]")
