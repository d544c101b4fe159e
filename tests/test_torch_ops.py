"""The PyTorch port's ops against the JAX package on the CPU: correlation
(DispNet's radius 40 included), both warps in both semantics, the 2-D
bilinear sampler, conv and transposed conv, resize/pad/crop, the kernel
wrappers' CPU behaviour and the port's isolation from JAX.

Inputs are made with numpy from a seed and handed to both packages; the
port's op-level functions take NCHW, so the tests transpose."""

import ctypes
import importlib.util
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch import ops as tops
from real_time_self_adaptive_deep_stereo_torch.ops import conv as tconv
from real_time_self_adaptive_deep_stereo_tpu.ops import conv as jconv
from real_time_self_adaptive_deep_stereo_tpu.ops.correlation import (
    correlation_jnp,
    correlation_pallas,
)
from real_time_self_adaptive_deep_stereo_tpu.ops import resize as jresize
from real_time_self_adaptive_deep_stereo_tpu.ops import warp as jwarp
from real_time_self_adaptive_deep_stereo_tpu.ops import warp_pallas as jpallas

PORT_DIR = pathlib.Path(__file__).resolve().parent.parent / "real_time_self_adaptive_deep_stereo_torch"


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x_nhwc):
    """numpy NHWC -> torch NCHW."""
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------- correlation


@pytest.mark.parametrize("max_disp,stride", [(2, 1), (3, 2), (4, 1)])
def test_correlation_torch_matches_jnp(max_disp, stride):
    r = _rng(1)
    x = r.normal(size=(2, 5, 23, 12)).astype(np.float32)
    y = r.normal(size=(2, 5, 23, 12)).astype(np.float32)
    want = np.asarray(correlation_jnp(jnp.asarray(x), jnp.asarray(y), max_disp, stride))
    got = _nhwc(tops.correlation(_t(x), _t(y), max_disp, stride, mode="torch"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_correlation_kernel_wrapper_matches_pallas_interpret():
    r = _rng(2)
    x = r.normal(size=(1, 8, 40, 16)).astype(np.float32)
    y = r.normal(size=(1, 8, 40, 16)).astype(np.float32)
    want = np.asarray(correlation_pallas(jnp.asarray(x), jnp.asarray(y), 2, True))
    # on CPU tensors the kernel wrapper runs the kernel's plain version
    got = _nhwc(tops.correlation(_t(x), _t(y), 2, mode="cuda"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # 'auto' on the CPU is the plain version
    got_auto = _nhwc(tops.correlation(_t(x), _t(y), 2))
    np.testing.assert_allclose(got_auto, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_correlation_matches_pallas_interpret_at_madnet_scale_6(dtype):
    """MADNet's coarsest call, [1,192,5,19] at radius 2, where ``corr_fwd``
    and ``corr_fwd_bf16`` spread the 192 channels over 32 slices: the
    kernel wrapper on CPU tensors (its plain version) against the Pallas
    kernel in interpret mode. fp32 within 1e-5 (measured 3.4e-8: sums over
    C in another order); bf16 within one bf16 ulp of each entry (measured
    0: both sum in fp32 and round once)."""
    r = _rng(9)
    x = r.normal(size=(1, 5, 19, 192)).astype(np.float32)
    y = r.normal(size=(1, 5, 19, 192)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = correlation_pallas(jnp.asarray(x).astype(jdt), jnp.asarray(y).astype(jdt), 2, True)
    assert want.dtype == jdt
    want = np.asarray(want.astype(jnp.float32))
    tx, ty = _t(x).to(getattr(torch, dtype)), _t(y).to(getattr(torch, dtype))
    got = tops.correlation_cuda(tx, ty, 2)
    assert got.dtype == getattr(torch, dtype) and got.shape == (1, 5, 5, 19)
    got = _nhwc(got.float())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0**-126))) - 7)
        assert np.all(np.abs(got - want) <= ulp)


# DispNet-Corr1D's radius: 81 shifts, with W below and above 2R+1
@pytest.mark.parametrize("w", [19, 100])
def test_correlation_torch_matches_jnp_at_radius_40(w):
    r = _rng(6)
    x = r.normal(size=(1, 3, w, 6)).astype(np.float32)
    y = r.normal(size=(1, 3, w, 6)).astype(np.float32)
    want = np.asarray(correlation_jnp(jnp.asarray(x), jnp.asarray(y), 40))
    got = _nhwc(tops.correlation(_t(x), _t(y), 40))  # 'auto' on the CPU: the plain version
    assert got.shape == (1, 3, w, 81)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the kernel wrapper on CPU tensors is the same plain version
    np.testing.assert_array_equal(_nhwc(tops.correlation_cuda(_t(x), _t(y), 40)), got)


_WIDE_TILE, _WIDE_RUN, _WIDE_RUNS, _WIDE_CHANNELS = 64, 12, 7, 32  # corr_fwd_wide's tiling


def _corr_fwd_wide_by_tiles(x, y, radius):
    """What ``corr_fwd_wide_kernel`` computes (NCHW numpy), step by step:
    a block per (batch, row, chunk of 84 shifts, tile of 64 columns); its
    thread (quad t, run r) owns the columns w0 + 4t .. + 3 and the shifts
    k0 + 12r .. + 11. Per chunk of 32 channels the block stages x[c, tile]
    and the y window [c, w0 + k0 - R, + 148), zeros outside the row; per
    channel the thread slides a window of 8 staged y values, 4 at a step,
    and adds x[c, w0 + 4t + q] * window[q + s] to the sum of column q and
    shift 4 * step + s (in float64 here: the point is the indices). Each
    output the tiling stores is counted; returns (out, counts)."""
    b, c, h, w = x.shape
    k_all = 2 * radius + 1
    shifts = _WIDE_RUN * _WIDE_RUNS
    window = _WIDE_TILE + shifts
    quads = _WIDE_TILE // 4
    out = np.zeros((b, k_all, h, w))
    counts = np.zeros(out.shape, np.int64)
    t = np.arange(quads)[None, :]  # [run, quad]
    s0 = _WIDE_RUN * np.arange(_WIDE_RUNS)[:, None]
    for bb, hh, k0, w0 in np.ndindex(b, h, -(-k_all // shifts), -(-w // _WIDE_TILE)):
        k0, w0 = k0 * shifts, w0 * _WIDE_TILE
        acc = np.zeros((_WIDE_RUNS, quads, _WIDE_RUN, 4))
        for c0 in range(0, c, _WIDE_CHANNELS):
            nc = min(_WIDE_CHANNELS, c - c0)
            cols = w0 + np.arange(_WIDE_TILE)
            xs = np.where(cols < w, x[bb, c0 : c0 + nc, hh][:, np.minimum(cols, w - 1)], 0.0)
            cols = w0 + k0 - radius + np.arange(window)
            inside = (cols >= 0) & (cols < w)
            ys = np.where(inside, y[bb, c0 : c0 + nc, hh][:, np.clip(cols, 0, w - 1)], 0.0)
            for cc in range(nc):
                for step in range(_WIDE_RUN // 4):
                    v = ys[cc][4 * t + s0 + 4 * step + np.arange(8)[:, None, None]]  # [8, run, quad]
                    for s, q in np.ndindex(4, 4):
                        acc[:, :, 4 * step + s, q] += xs[cc][4 * t + q] * v[q + s]
        for r, tt, s, q in np.ndindex(_WIDE_RUNS, quads, _WIDE_RUN, 4):
            k, col = k0 + _WIDE_RUN * r + s, w0 + 4 * tt + q
            if k < k_all and col < w:
                out[bb, k, hh, col] = acc[r, tt, s, q] / c
                counts[bb, k, hh, col] += 1
    return out, counts


@pytest.mark.parametrize(
    "w,radius", [(1, 40), (19, 40), (63, 40), (65, 40), (130, 40), (70, 0), (70, 5)]
)
def test_corr_fwd_wide_tiling_matches_jnp(w, radius):
    """The tiling of ``corr_fwd_wide_kernel`` (the emulation above: column
    quads, runs of 12 shifts, chunks of 84 shifts and of 32 channels, zeros
    outside the row) stores every (column, shift) pair once and computes
    the cost volume of ``correlation_torch`` and the JAX package's
    ``correlation_jnp``: rows of 1 column to two tiles and one past them,
    33 channels (two chunks), radius 0, 5 (11 shifts, one run) and 40."""
    r = _rng(8)
    x = r.normal(size=(1, 33, 2, w)).astype(np.float32)  # NCHW
    y = r.normal(size=(1, 33, 2, w)).astype(np.float32)
    got, counts = _corr_fwd_wide_by_tiles(x, y, radius)
    assert (counts == 1).all()
    want = tops.correlation_torch(torch.from_numpy(x), torch.from_numpy(y), radius).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    nhwc = [jnp.asarray(a.transpose(0, 2, 3, 1)) for a in (x, y)]
    want = np.asarray(correlation_jnp(*nhwc, radius)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("w", [19, 100])
def test_correlation_bwd_matches_pallas_vjp_at_radius_40(w):
    """The plain backward, the plain version of ``corr_bwd_wide``, against
    the vjp of the Pallas kernel in interpret mode (``_corr_pallas_bwd``)."""
    r = _rng(7)
    x = r.normal(size=(1, 2, w, 5)).astype(np.float32)
    y = r.normal(size=(1, 2, w, 5)).astype(np.float32)
    g = r.normal(size=(1, 2, w, 81)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: correlation_pallas(a, b, 40, True), jnp.asarray(x), jnp.asarray(y))
    want = vjp(jnp.asarray(g))
    got = tops.correlation_bwd_cuda(_t(x), _t(y), _t(g), 40)  # CPU tensors: the plain version
    for a, b, nm in zip(got, want, ("dx", "dy")):
        b = np.asarray(b)
        np.testing.assert_allclose(_nhwc(a), b, rtol=0, atol=1e-5 * np.abs(b).max(), err_msg=nm)


def test_corr_auto_resolves_to_the_kernels_at_every_radius():
    """``correlation(mode='auto')`` on a stride-1 CUDA tensor runs the
    kernels at MADNet's radius 2 and DispNet's 40 alike: the register
    instances up to radius 4, the wide kernels beyond. It never picks the
    plain version there; at stride 2 or on the CPU it does."""
    # the module: the package's ``correlation`` is the function
    tcorr = importlib.import_module("real_time_self_adaptive_deep_stereo_torch.ops.correlation")
    for radius in (1, 2, 4, 5, 40, 100):
        assert tops.resolve_corr_mode("cuda", 1, radius) == "cuda"
        assert tops.resolve_corr_mode("cpu", 1, radius) == "torch"
        assert tops.resolve_corr_mode("cuda", 2, radius) == "torch"
    assert tcorr.MAX_REGISTER_RADIUS == 4
    assert [tcorr._is_wide(r, None) for r in (0, 1, 2, 4, 5, 40)] == [True, False, False, False, True, True]
    assert tcorr._is_wide(2, True) and not tcorr._is_wide(2, False)
    with pytest.raises(ValueError, match="max_disp 1..4"):
        tcorr._is_wide(40, False)
    with pytest.raises(ValueError, match="max_disp >= 0"):
        tops.resolve_corr_mode("cuda", 1, -1)


# ---------------------------------------------------------------- transposed conv


@pytest.mark.parametrize("k,stride", [(4, 2), (3, 2), (4, 1)])
@pytest.mark.parametrize("hw", [(6, 10), (7, 9)])
def test_conv2d_transpose_matches_jax(k, stride, hw):
    """TF SAME transposed conv, DispNet's 4x4 s2 and two other shapes, at
    even and odd sizes: the JAX kernel [kh, kw, out, in] goes to the port
    under ``params_from_jax``'s permutation, unflipped."""
    from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import params_from_jax

    r = _rng(8)
    x = r.normal(size=(2, *hw, 5)).astype(np.float32)
    params = {
        "w": r.normal(size=(k, k, 3, 5)).astype(np.float32),
        "b": r.normal(size=(3,)).astype(np.float32),
    }
    want = np.asarray(jconv.conv2d_transpose(params, jnp.asarray(x), strides=stride))
    sd = params_from_jax({"d": params})
    got = _nhwc(tops.conv2d_transpose(_t(x), sd["d.weight"], sd["d.bias"], stride))
    assert got.shape == (2, hw[0] * stride, hw[1] * stride, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------- warp


def test_bilinear_sampler_matches_jax():
    """Coordinates inside, between and outside the image (clamped indices,
    weights from the unclamped coordinates)."""
    r = _rng(9)
    img = r.normal(size=(2, 7, 11, 3)).astype(np.float32)
    coords = np.stack(
        [r.uniform(-4, 15, (2, 7, 11)), r.uniform(-3, 10, (2, 7, 11))], axis=-1
    ).astype(np.float32)
    coords[0, 0, :3] = [[-1.0, 2.0], [10.0, 6.0], [3.0, 3.0]]  # on edges and integers
    want = np.asarray(jwarp.bilinear_sampler(jnp.asarray(img), jnp.asarray(coords)))
    got = _nhwc(tops.bilinear_sampler(_t(img), _t(coords)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)




def _img_case(seed, w=200):
    r = _rng(seed)
    img = r.normal(size=(2, 6, w, 3)).astype(np.float32)
    # crosses below 0 and above max_disp=32
    disp = (r.random((2, 6, w, 1)) * 44 - 6).astype(np.float32)
    return img, disp


def _feat_case(seed, w=140):
    r = _rng(seed)
    feats = r.normal(size=(1, 5, w, 6)).astype(np.float32)
    # crosses below -max_neg=20 and above max_pos=4
    dx = (r.random((1, 5, w, 1)) * -30 + 8).astype(np.float32)
    return feats, dx


def test_warp_image_clamped_matches_shift_and_mxu():
    img, disp = _img_case(3)
    assert disp.min() < 0 and disp.max() > 32
    got = _nhwc(tops.warp_image_clamped(_t(img), _t(disp), 32))
    want_shift = np.asarray(jwarp.warp_image_shift(jnp.asarray(img), jnp.asarray(disp), 32))
    want_mxu = np.asarray(jpallas.warp_image_mxu(jnp.asarray(img), jnp.asarray(disp), 32, True))
    np.testing.assert_allclose(got, want_shift, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want_mxu, rtol=1e-6, atol=1e-6)
    # the kernel wrapper on CPU tensors is the same plain version
    wrapped = _nhwc(tops.warp_image_cuda(_t(img), _t(disp), 32))
    np.testing.assert_array_equal(wrapped, got)


def test_warp_features_clamped_matches_shift_and_mxu():
    feats, dx = _feat_case(4)
    assert dx.min() < -20 and dx.max() > 4 and feats.shape[2] % 128
    got = _nhwc(tops.warp_features_clamped(_t(feats), _t(dx), 20, 4))
    want_shift = np.asarray(
        jwarp.warp_features_horizontal_shift(jnp.asarray(feats), jnp.asarray(dx), 20, 4)
    )
    want_mxu = np.asarray(
        jpallas.warp_features_mxu(jnp.asarray(feats), jnp.asarray(dx), 20, 4, True)
    )
    np.testing.assert_allclose(got, want_shift, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want_mxu, rtol=1e-6, atol=1e-6)
    wrapped = _nhwc(tops.warp_features_cuda(_t(feats), _t(dx), 20, 4))
    np.testing.assert_array_equal(wrapped, got)


def test_gather_warps_match_jax():
    img, disp = _img_case(5, w=50)
    want = np.asarray(jwarp.warp_image(jnp.asarray(img), jnp.asarray(disp)))
    np.testing.assert_allclose(_nhwc(tops.warp_image(_t(img), _t(disp))), want, rtol=1e-6, atol=1e-6)
    feats, dx = _feat_case(6, w=50)
    want = np.asarray(jwarp.warp_features_horizontal(jnp.asarray(feats), jnp.asarray(dx)))
    got = _nhwc(tops.warp_features_horizontal(_t(feats), _t(dx)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_warp_modes_resolve_and_dispatch():
    cpu = torch.device("cpu")
    assert tops.resolve_warp_mode("auto", cpu) == "gather"
    assert tops.resolve_warp_mode("auto", torch.device("cuda")) == "cuda"
    assert tops.resolve_warp_mode("onehot", cpu) == "onehot"  # a mode of the port since the tiled warps
    with pytest.raises(ValueError):
        tops.resolve_warp_mode("pallas", cpu)
    img, disp = _img_case(7, w=60)
    ti, td = _t(img), _t(disp)
    np.testing.assert_array_equal(
        tops.warp_image_by_mode(ti, td, "auto", 32).numpy(), tops.warp_image(ti, td).numpy()
    )
    np.testing.assert_array_equal(
        tops.warp_image_by_mode(ti, td, "clamped", 32).numpy(),
        tops.warp_image_clamped(ti, td, 32).numpy(),
    )


def test_kernel_wrappers_reject_non_fp32():
    x = torch.zeros(1, 4, 3, 8, dtype=torch.float64)
    with pytest.raises(TypeError):
        tops.correlation_cuda(x, x, 2)
    with pytest.raises(TypeError):
        tops.warp_image_cuda(x, torch.zeros(1, 1, 3, 8), 8)
    with pytest.raises(TypeError):
        tops.warp_features_cuda(x, torch.zeros(1, 1, 3, 8), 8, 4)


# ----------------------------------------------------------------------- conv


@pytest.mark.parametrize("stride,hw", [(1, (9, 14)), (2, (16, 22)), (2, (9, 15))])
def test_conv2d_matches_jax(stride, hw):
    r = _rng(8)
    x = r.normal(size=(2, *hw, 5)).astype(np.float32)
    w = r.normal(size=(3, 3, 5, 7)).astype(np.float32)
    b = r.normal(size=(7,)).astype(np.float32)
    want = np.asarray(
        jconv.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), strides=stride)
    )
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    got = _nhwc(tconv.conv2d(_t(x), wt, torch.from_numpy(b), stride=stride))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dilated_conv2d_matches_jax():
    r = _rng(9)
    x = r.normal(size=(1, 20, 36, 4)).astype(np.float32)
    for rate in (1, 2, 4, 8, 16):
        w = r.normal(size=(3, 3, 4, 6)).astype(np.float32)
        b = r.normal(size=(6,)).astype(np.float32)
        want = np.asarray(
            jconv.dilated_conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), rate=rate)
        )
        wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
        got = _nhwc(tconv.dilated_conv2d(_t(x), wt, torch.from_numpy(b), rate=rate))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=f"rate {rate}")


def test_leaky_relu_and_init_conv():
    x = torch.tensor([-2.0, -0.5, 0.0, 3.0])
    np.testing.assert_allclose(tconv.leaky_relu(0.2)(x).numpy(), [-0.4, -0.1, 0.0, 3.0], rtol=1e-6)
    g = torch.Generator().manual_seed(0)
    w, b = tconv.init_conv(g, (16, 8, 3, 3))
    limit = np.sqrt(6.0 / (9 * 8 + 9 * 16))
    assert w.shape == (16, 8, 3, 3) and float(w.abs().max()) <= limit
    assert float(w.abs().max()) > 0.9 * limit and torch.count_nonzero(b) == 0


# --------------------------------------------------------------------- resize


@pytest.mark.parametrize(
    "in_hw,out_hw", [((6, 10), (96, 160)), ((64, 64), (32, 32)), ((5, 7), (10, 14)), ((8, 8), (8, 8))]
)
def test_resize_bilinear_matches_jax(in_hw, out_hw):
    x = _rng(10).normal(size=(2, *in_hw, 3)).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), *out_hw))
    got = _nhwc(tops.resize_bilinear(_t(x), *out_hw))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("target", [(4, 6), (12, 20), (4, 20), (12, 6)])
def test_crop_or_pad_matches_jax(target):
    x = _rng(11).normal(size=(2, 8, 10, 1)).astype(np.float32)
    want = np.asarray(jresize.crop_or_pad(jnp.asarray(x), *target))
    np.testing.assert_array_equal(_nhwc(tops.crop_or_pad(_t(x), *target)), want)


def test_pad_image_matches_jax():
    x = _rng(12).normal(size=(1, 100, 250, 3)).astype(np.float32)
    want = np.asarray(jresize.pad_image(jnp.asarray(x), 64))
    got = _nhwc(tops.pad_image(_t(x), 64))
    assert got.shape == (1, 128, 256, 3)
    np.testing.assert_array_equal(got, want)
    assert tops.padded_shape(320, 1216) == jresize.padded_shape(320, 1216) == (320, 1216)


def test_kernel_c_signatures_match_ctypes():
    """Each C entry point of csrc/*.cu takes exactly the ctypes argtypes the
    loader declares: a mismatch would pass garbage to the kernel on the card,
    where no compiler checks the call."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    def ctype(param):
        if "*" in param or "cudaStream_t" in param:
            return ctypes.c_void_p
        return {"int": ctypes.c_int, "float": ctypes.c_float}[param.split()[0]]

    declared = 0
    for lib, fns in cuda_lib._SIGNATURES.items():
        src = (cuda_lib.CSRC_DIR / f"{lib}.cu").read_text()
        for fn, argtypes in fns.items():
            m = re.search(rf"^int {fn}\(([^)]*)\)", src, re.M)
            assert m, f"{lib}.cu has no entry point {fn}"
            params = [p.strip() for p in m.group(1).split(",")]
            assert [ctype(p) for p in params] == argtypes, fn
            declared += 1
    assert set(cuda_lib.LAUNCHES) == {
        fn for fns in cuda_lib._SIGNATURES.values() for fn in fns if fn not in cuda_lib._HOST_ENTRIES
    }
    assert "graph_switch" in cuda_lib.LAUNCHES and len(cuda_lib._HOST_ENTRIES) == 2
    # correlation 8 (register and wide, each way, fp32 and bf16), warp 4,
    # warp_tile 4, graph_switch 3 (the launch and two host entries)
    assert declared == 19


def test_warp_grid_checks_follow_the_kernels_grids():
    """The wrappers' check of the launch grid, whose y and z axes hold at
    most 65535 blocks: the feature forwards put their channel groups on the
    x axis, so the batch alone bounds them; the image forwards walk the
    channels in a thread, so rows and batch bound them; the clamped-window
    image backward keeps its bounds, and the feature backward, tiled or
    not, and the tiled image backward have the pixels of the plane on the x
    axis, so batch and channel groups alone bound them: the source gradient
    takes 128 channels a block (32 slices of 4). Each tiled kernel of the
    feature warp has its clamped-window counterpart's grid, since it is a
    gather of the same form."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib
    from real_time_self_adaptive_deep_stereo_torch.ops import warp_kernels as wk

    assert set(wk._GRID) == {*cuda_lib._SIGNATURES["warp"], *cuda_lib._SIGNATURES["warp_tile"]}
    assert wk._GRID["warp_tile_image_fwd"] == wk._GRID["warp_image_fwd"] == (True, None)
    assert wk._GRID["warp_tile_features_fwd"] == wk._GRID["warp_features_fwd"] == (False, None)
    assert wk._GRID["warp_tile_features_bwd"] == wk._GRID["warp_features_bwd"] == (False, 128)
    for fn in ("warp_features_fwd", "warp_tile_features_fwd"):
        wk._check_grid(fn, (65535, 10**6, 70000, 2))
    for fn in ("warp_image_fwd", "warp_tile_image_fwd"):
        wk._check_grid(fn, (65535, 10**6, 65535, 2))
    for fn in ("warp_tile_image_bwd", "warp_tile_features_bwd", "warp_features_bwd"):
        wk._check_grid(fn, (1, 3, 65536, 1))
        wk._check_grid(fn, (1, 128 * 65535, 1, 1))
        wk._check_grid(fn, (255, 128 * 257, 1, 1))
    for fn, shape in [
        ("warp_features_fwd", (65536, 1, 1, 1)),
        ("warp_tile_features_fwd", (65536, 1, 1, 1)),
        ("warp_image_fwd", (1, 3, 65536, 1)),
        ("warp_tile_image_fwd", (1, 3, 65536, 1)),
        ("warp_tile_image_fwd", (65536, 3, 1, 1)),
        ("warp_features_bwd", (1, 128 * 65535 + 1, 1, 1)),
        ("warp_features_bwd", (256, 128 * 257, 1, 1)),
        ("warp_image_bwd", (1, 4 * 65535 + 1, 1, 1)),
        ("warp_image_bwd", (1, 3, 65536, 1)),
        ("warp_tile_image_bwd", (65536, 3, 1, 1)),
        ("warp_tile_features_bwd", (1, 128 * 65535 + 1, 1, 1)),
        ("warp_tile_features_bwd", (256, 128 * 257, 1, 1)),
    ]:
        with pytest.raises(ValueError, match="exceeds the launch grid"):
            wk._check_grid(fn, shape)


def test_ptxas_usage_picks_one_kernels_lines():
    """``ptxas_usage`` keeps the spill and register lines of the entry
    functions whose name holds the kernel's, and nothing of the others."""
    from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115warp_fwd_kernelEPKf' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_115warp_fwd_kernelEPKf",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 24 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122feat_gather_fwd_kernelEPKf' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_122feat_gather_fwd_kernelEPKf",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 32 registers, used 0 barriers",
    ])
    assert cuda_lib.ptxas_usage(log, "feat_gather_fwd_kernel") == [
        "8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "Used 32 registers, used 0 barriers",
    ]
    assert cuda_lib.ptxas_usage(log, "tile_feat_fwd_kernel") == []


# ------------------------------------------------------ chip_smoke.py helpers


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", PORT_DIR.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", [(1, 3, 6, 40), (1, 5, 4, 37)])
@pytest.mark.parametrize(
    "padding,mask",
    [("border", (False, True)), ("zeros", (True, False))],
    ids=["image-ddisp-alone", "features-dfeats-alone"],
)
def test_grid_sample_yardstick_is_autograds_backward(shape, padding, mask):
    """``chip_smoke.grid_sample_bwd``, the backward yardstick that a CUDA
    graph can capture, gives exactly what autograd gives through
    ``F.grid_sample`` on the same ``grid_for`` grid, for the gradient the
    main path asks for, and None for the other."""
    import torch.nn.functional as F

    cs = _chip_smoke()
    r = _rng(13)
    src = torch.from_numpy(r.normal(size=shape).astype(np.float32))
    g = torch.from_numpy(r.normal(size=shape).astype(np.float32))
    if padding == "border":  # the image warp samples at x - clip(disp, 0, 16)
        shift, sign = r.random((1, 1, *shape[2:])) * 16, -1.0
    else:  # the feature warp at x + clip(dx, -6, 4)
        shift, sign = r.random((1, 1, *shape[2:])) * 10 - 6, 1.0
    grid = cs.grid_for(torch.from_numpy(shift.astype(np.float32)), sign)
    got = cs.grid_sample_bwd(g, src, grid, padding, mask)
    s, gr = src.clone().requires_grad_(), grid.clone().requires_grad_()
    want = torch.autograd.grad(F.grid_sample(s, gr, "bilinear", padding, align_corners=True), (s, gr), g)
    for a, b, asked in zip(got, want, mask):
        if asked:
            assert torch.equal(a, b)
        else:
            assert a is None


# ------------------------------------------------------------------ isolation


def test_port_imports_no_jax():
    """Importing every port module leaves JAX and the JAX package out."""
    mods = sorted(
        "real_time_self_adaptive_deep_stereo_torch."
        + ".".join(p.relative_to(PORT_DIR).with_suffix("").parts)
        for p in PORT_DIR.rglob("*.py")
        if p.name != "__init__.py"
    )
    assert {f"real_time_self_adaptive_deep_stereo_torch.adapt.{m}" for m in ("arena", "fused")} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
        "'real_time_self_adaptive_deep_stereo_tpu'))]\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    subprocess.run(
        [sys.executable, "-c", code], check=True, cwd=PORT_DIR.parent, timeout=120
    )
    stmt = re.compile(
        r"^\s*(from|import)\s+(jax|real_time_self_adaptive_deep_stereo_tpu)\b", re.M
    )
    for p in [*PORT_DIR.rglob("*.py"), PORT_DIR.parent / "chip_smoke.py"]:
        assert not stmt.search(p.read_text()), p


def test_exact_grad_sums_keeps_the_forward_and_skips_the_bf16_rounding():
    """``chip_smoke.exact_grad_sums`` (phase 13 (d)'s diagnostic): under
    ``bf16_act`` MADNet's forward and loss stay bit for bit; every entry of
    the usual gradient is a bf16 value (cuDNN's and autograd's bf16 sums,
    rounded once) and lies within one bf16 ulp of the diagnostic's, whose
    sums are fp32 and mostly no bf16 value, give or take 1e-5 of the
    largest entry (the two fp32 sums of many terms in other orders, which
    shows where they cancel: at 8 of 3.8 million entries, each under 1e-5
    of the largest, up to 9 ulps of their own); outside the block the
    usual convolution is back."""
    from real_time_self_adaptive_deep_stereo_torch.losses import get_reprojection_loss
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.ops import conv, conv_precision

    cs = _chip_smoke()
    model = get_stereo_net("MADNet", device="cpu")
    params = list(model.parameters())
    left = torch.from_numpy((_rng(21).random((1, 64, 128, 3)) * 255).astype(np.float32))
    frame = {"left": left, "right": torch.roll(left, -3, 2)}
    loss_fn = get_reprojection_loss("mean_SSIM_l1", reduced=True)
    before = conv._conv
    runs = []
    with conv_precision("bf16_act"):
        for sums in (cs.contextlib.nullcontext, cs.exact_grad_sums):
            with sums():
                out = model(frame["left"], frame["right"])
                loss = loss_fn(out["disparities"], frame)
                g = torch.cat([t.reshape(-1) for t in torch.autograd.grad(loss, params)])
            runs.append((out["full_res_disp"].detach(), loss.detach(), g))
    assert conv._conv is before
    (d0, l0, g0), (d1, l1, g1) = runs
    assert torch.equal(d0, d1) and torch.equal(l0, l1)
    assert torch.equal(g0.bfloat16().float(), g0)
    assert float((g1.bfloat16().float() == g1).float().mean()) < 0.5
    ulp = torch.exp2(torch.floor(torch.log2(g1.abs().clamp(min=2.0**-126))) - 7)
    assert bool(((g0 - g1).abs() <= ulp + 1e-5 * float(g1.abs().max())).all())
