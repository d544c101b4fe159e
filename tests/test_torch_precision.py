"""The port's precision modes ``highest``, ``default``, ``bf16`` and
``bf16_act`` against the JAX package's on the CPU, and the bf16 correlation.

The JAX package is switched only through its own ``set_conv_precision``,
restored in a ``finally``; the port through ``conv_precision``. Weights and
inputs are made with numpy from a seed and handed to both.

Tolerances, each with what was measured here:

* One convolution (``conv2d``, ``dilated_conv2d``, ``conv2d_transpose``):
  the dtype equal, the values within 1e-3 of the largest entry (measured:
  0 under ``bf16`` and ``bf16_act``, 1.5e-7 for the fp32 transposed
  convolution, whose sums run in another order). ``default`` equals
  ``highest`` exactly on the CPU in both packages, where neither has TF32.
* The bf16 correlation at radius 2 and 40, against the Pallas kernel in
  interpret mode: the forward equal (measured max abs 0: both sum in fp32
  and round once). The gradients against the reference's bf16-arithmetic
  backward within 1e-2 (radius 2) and 3e-2 (radius 40) of the largest
  entry (measured 5.3e-3 and 1.7e-2: the reference rounds to bf16 at every
  shift, the port once), and against fp32 arithmetic on the same bf16
  values, rounded once, within one bf16 ulp of each entry (measured 0).
* MADNet and DispNet-Corr1D at 64x128 under ``bf16`` and ``bf16_act``:
  every disparity has the reference's dtype and lies within MAX_TOL = 2e-2
  of the largest disparity. DispNet agrees bit for bit under ``bf16_act``.
  Elsewhere the port's mean error is of the size of the mode's own gap from
  ``highest`` (its ratio to that gap measured 0.40-1.21 over weight seeds
  0-3): the convolutions' fp32 sums run in another order than XLA's, one
  bf16 ulp apart at 0.01% of their outputs, and each later rounding to bf16
  spreads those differences. So the mean cannot tell the port from one that
  ignored the mode. What does is the share of the entries, among those
  where the reference in the mode differs from the reference at
  ``highest``, that lie closer to the mode's: at least FWD_SHARE = 0.3
  (measured 0.41-1.0 over seeds 0-3; 0.60-1.0 at the seed used), while the
  port run at ``highest`` against the same reference scores at most 0.031,
  which a control test asserts fails.
* One MAD step under ``bf16_act`` (MADNet block 2; DispNet block 3, whose
  gradient goes back through the correlation): the loss and the block loss
  within 1e-3 and 1e-2 relative (MADNet) and 1e-5 (DispNet); the gradient
  and the parameter change within 1e-2 (MADNet) and 3e-2 (DispNet) of their
  largest entry; and at least STEP_SHARE = 0.5 of the gradient's entries,
  among those where the reference's ``bf16_act`` and ``highest`` steps
  differ, closer to the ``bf16_act`` one. Measured over weight seeds 0-3:
  MADNet loss 1.5e-4 to 5.7e-4, block loss 2.6e-4 to 4.8e-3, gradient 1.1e-3
  to 6.5e-3, share 0.64-0.77; DispNet loss and block loss 8e-7 to 1.1e-6,
  gradient 4.1e-3 to 1.4e-2, share 0.87-0.91. The port stepped at
  ``highest`` against the same reference (the control test): MADNet loss
  1.9e-4 to 5.1e-3 and block loss 5.3e-3 to 2.1e-2, DispNet loss 2.1e-3 to
  1.3e-2, gradients 2e-3 to 1.4e-2, share 0 in both. So MADNet's loss and
  both gradients are of the size of the mode's own effect; the share
  separates both models, DispNet's loss too. DispNet's gradient differs most
  because the reference's correlation backward rounds to bf16 at every
  shift and the port's once (the radius-40 tolerance above).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch import ops as tops
from real_time_self_adaptive_deep_stereo_torch.adapt import AdaptationEngine as TorchEngine
from real_time_self_adaptive_deep_stereo_torch.adapt import FusedOnlineSession
from real_time_self_adaptive_deep_stereo_torch.adapt import OnlineAdaptationSession as TorchSession
from real_time_self_adaptive_deep_stereo_torch.adapt import blocks as tblocks
from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net as torch_net
from real_time_self_adaptive_deep_stereo_torch.ops import conv as tconv
from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import (
    flatten_params,
    params_from_jax,
    params_to_jax,
)
from real_time_self_adaptive_deep_stereo_torch.utils.device import resolve_device
from real_time_self_adaptive_deep_stereo_tpu.adapt import AdaptationEngine as JaxEngine
from real_time_self_adaptive_deep_stereo_tpu.adapt import blocks as jblocks
from real_time_self_adaptive_deep_stereo_tpu.models import get_stereo_net as jax_net
from real_time_self_adaptive_deep_stereo_tpu.ops import conv as jconv
from real_time_self_adaptive_deep_stereo_tpu.ops.correlation import correlation_jnp, correlation_pallas

MODES = ("highest", "default", "bf16", "bf16_act")
H, W = 64, 128
LR = 1e-4
CONV_TOL = 1e-3
MAX_TOL = 2e-2
FWD_SHARE = 0.3
STEP_SHARE = 0.5


class _jax_precision:
    """The JAX package under precision ``p`` for a block, then ``highest``
    again (its default) whatever happens."""

    def __init__(self, p):
        self.p = p

    def __enter__(self):
        jconv.set_conv_precision(self.p)

    def __exit__(self, *exc):
        jconv.set_conv_precision("highest")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return _np(t.permute(0, 2, 3, 1))


def _bf16_values(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 (to nearest even) and back to float32."""
    return _np(torch.from_numpy(np.array(a, np.float32)).bfloat16())


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """The spacing of bf16 at each entry of ``a`` (8 significant bits)."""
    mag = np.maximum(np.abs(a).astype(np.float64), 2.0**-126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


# ------------------------------------------------------------------ convolutions
@pytest.fixture(scope="module")
def conv_inputs():
    r = np.random.default_rng(0)
    return {
        "x": r.standard_normal((1, 20, 24, 16)).astype(np.float32),  # NHWC
        "w": (0.2 * r.standard_normal((3, 3, 16, 24))).astype(np.float32),  # HWIO
        "wt": (0.2 * r.standard_normal((4, 4, 24, 16))).astype(np.float32),  # [kh, kw, out, in]
        "b": (0.1 * r.standard_normal(24)).astype(np.float32),
    }


def _jax_conv(op, inp):
    x = jnp.asarray(inp["x"])
    if op == "conv2d":
        return jconv.conv2d({"w": inp["w"], "b": inp["b"]}, x, strides=2)
    if op == "dilated_conv2d":
        return jconv.dilated_conv2d({"w": inp["w"], "b": inp["b"]}, x, rate=2)
    return jconv.conv2d_transpose({"w": inp["wt"], "b": inp["b"]}, x, strides=2)


def _torch_conv(op, inp):
    x = torch.from_numpy(inp["x"]).permute(0, 3, 1, 2)
    b = torch.from_numpy(inp["b"])
    if op == "conv2d_transpose":  # [kh, kw, out, in] -> [in, out, kh, kw]
        return tops.conv2d_transpose(x, torch.from_numpy(inp["wt"]).permute(3, 2, 0, 1), b, 2)
    w = torch.from_numpy(inp["w"]).permute(3, 2, 0, 1)  # HWIO -> OIHW
    if op == "conv2d":
        return tops.conv2d(x, w, b, 2)
    return tops.dilated_conv2d(x, w, b, 2)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("op", ["conv2d", "dilated_conv2d", "conv2d_transpose"])
def test_conv_matches_jax_in_every_mode(conv_inputs, op, mode):
    with _jax_precision(mode):
        want = _jax_conv(op, conv_inputs)
    if mode == "default":
        # no TF32 on the CPU: 'default' is 'highest', bit for bit, in both packages
        np.testing.assert_array_equal(np.asarray(want), np.asarray(_jax_conv(op, conv_inputs)))
    with tops.conv_precision(mode):
        got = _torch_conv(op, conv_inputs)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    want = np.asarray(want.astype(jnp.float32))
    got = _nhwc(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=CONV_TOL * np.abs(want).max())
    if mode == "default":
        with tops.conv_precision("highest"):
            np.testing.assert_array_equal(_nhwc(_torch_conv(op, conv_inputs)), got)


def test_leaky_relu_rounds_its_slope_to_bf16_as_jax():
    """JAX's weak-typed 0.2 becomes bf16 on a bf16 input; the port's slope
    follows the input's dtype, so the epilogues agree bit for bit."""
    r = np.random.default_rng(1)
    y = r.standard_normal(4096).astype(np.float32)
    for alpha in (0.1, 0.2):
        for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
            want = np.asarray(jconv.leaky_relu(alpha)(jnp.asarray(y).astype(jdt)).astype(jnp.float32))
            got = _np(tops.leaky_relu(alpha)(torch.from_numpy(y).to(dt)))
            np.testing.assert_array_equal(got, want)


def test_bf16_bias_gradient_sums_in_fp32():
    """Under bf16_act the bias is added in bf16, and its gradient sums the
    bf16 output gradient over every pixel. The port sums in fp32 and rounds
    once; the JAX package (XLA on the CPU) sums in bf16, which loses the
    small terms of a long sum: on 64x192 terms of +-1/n, 60% positive, it
    reads 0.1797 where the sum is 0.2025 (11% off), the port 0.2031 (the
    sum of the bf16 terms, rounded to bf16). This is why DispNet's last bias moves apart from
    the JAX package's under bf16_act (``tests/test_torch_spatial_dispnet.py``;
    ``ROADMAP.md`` section 3)."""
    r = np.random.default_rng(0)
    n = 64 * 192
    cot = (np.where(r.random((1, 64, 192, 1)) < 0.6, 1.0, -1.0) / n).astype(np.float32)
    x = r.standard_normal((1, 64, 192, 32)).astype(np.float32)
    w = (0.05 * r.standard_normal((3, 3, 32, 1))).astype(np.float32)
    exact = float(cot.sum(dtype=np.float64))

    def jax_loss(b):
        y = jconv.conv2d({"w": w, "b": b}, jnp.asarray(x), activation=lambda v: v)
        return jnp.sum(y.astype(jnp.float32) * cot)

    with _jax_precision("bf16_act"):
        want = float(jax.grad(jax_loss)(jnp.zeros(1, jnp.float32))[0])
    with tops.conv_precision("bf16_act"):
        b = torch.zeros(1, requires_grad=True)
        y = tops.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w).permute(3, 2, 0, 1), b, 1,
                        activation=lambda v: v)
        assert y.dtype == torch.bfloat16
        (y.float() * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    # the sum, in float64, of the output gradient rounded to bf16, rounded to bf16 once
    assert float(b.grad[0]) == float(_bf16_values(np.float32(_bf16_values(cot).sum(dtype=np.float64))))
    assert abs(want - exact) > 0.05 * exact  # the JAX package's bf16 sum


# ------------------------------------------------------------------ correlation
CORR_CASES = {2: ((1, 12, 40, 8), 1e-2), 40: ((1, 6, 100, 4), 3e-2)}  # NHWC, gradient tolerance


@pytest.fixture(scope="module")
def corr_reference():
    """Per radius: bf16 inputs (as float32 values), the Pallas forward in
    interpret mode and the reference's bf16 backward, and fp32 arithmetic
    on the same values."""
    out = {}
    r = np.random.default_rng(2)
    for radius, (shape, _) in CORR_CASES.items():
        x, y = _bf16_values(r.standard_normal(shape)), _bf16_values(r.standard_normal(shape))
        g = _bf16_values(r.standard_normal(shape[:3] + (2 * radius + 1,)))

        @jax.jit
        def pallas_fwd_bwd(x, y, g, radius=radius):
            out, vjp = jax.vjp(lambda a, b: correlation_pallas(a, b, radius, True), x, y)
            return (out, *vjp(g))

        @jax.jit
        def fp32_fwd_bwd(x, y, g, radius=radius):
            out, vjp = jax.vjp(lambda a, b: correlation_jnp(a, b, radius), x, y)
            return (out, *vjp(g))

        bf = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, y, g)]
        pallas = [np.asarray(a.astype(jnp.float32)) for a in pallas_fwd_bwd(*bf)]
        assert all(a.dtype == jnp.bfloat16 for a in pallas_fwd_bwd(*bf))
        fp32 = [np.asarray(a) for a in fp32_fwd_bwd(jnp.asarray(x), jnp.asarray(y), jnp.asarray(g))]
        out[radius] = (x, y, g, pallas, fp32)
    return out


def _nchw_bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous().bfloat16()


@pytest.mark.parametrize("radius", sorted(CORR_CASES))
def test_bf16_correlation_forward_equals_the_pallas_kernel(corr_reference, radius):
    x, y, _, (want, _, _), (fp32, _, _) = corr_reference[radius]
    tx, ty = _nchw_bf16(x), _nchw_bf16(y)
    plain = tops.correlation_torch(tx, ty, radius)
    wrapped = tops.correlation_cuda(tx, ty, radius)  # CPU tensors: the plain version
    auto = tops.correlation(tx, ty, radius)
    for got in (plain, wrapped, auto):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_nhwc(got), want)
    # fp32 arithmetic on the same values, rounded once, within one bf16 ulp
    assert np.all(np.abs(_nhwc(plain) - _bf16_values(fp32)) <= _bf16_ulp(fp32))


@pytest.mark.parametrize("radius", sorted(CORR_CASES))
def test_bf16_correlation_backward_matches_the_reference(corr_reference, radius):
    x, y, g, (_, jdx, jdy), (_, dx32, dy32) = corr_reference[radius]
    tol = CORR_CASES[radius][1]
    tx, ty, tg = _nchw_bf16(x), _nchw_bf16(y), _nchw_bf16(g)
    explicit = tops.correlation_torch_bwd(tx, ty, tg, radius)
    wrapped = tops.correlation_bwd_cuda(tx, ty, tg, radius)
    xg, yg = tx.clone().requires_grad_(), ty.clone().requires_grad_()
    # autograd through the plain forward, handed an fp32 gradient as a
    # downstream promotion would
    autograd = torch.autograd.grad(tops.correlation(xg, yg, radius), (xg, yg), tg.float())
    for dx, dy in (explicit, wrapped, autograd):
        for got, ref, f32, nm in ((dx, jdx, dx32, "dx"), (dy, jdy, dy32, "dy")):
            assert got.dtype == torch.bfloat16, nm
            got = _nhwc(got)
            # the reference computes in bf16, the port in fp32 rounded once
            np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max(), err_msg=nm)
            assert np.all(np.abs(got - _bf16_values(f32)) <= _bf16_ulp(f32)), nm
    for a, b in zip(explicit, wrapped):
        assert torch.equal(a, b)


def test_correlation_wrappers_take_one_dtype_of_two():
    x = torch.randn(1, 4, 3, 16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tops.correlation_cuda(x, x.bfloat16(), 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tops.correlation_cuda(x.double(), x.double(), 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tops.correlation_bwd_cuda(x.bfloat16(), x.bfloat16(), torch.zeros(1, 5, 3, 16), 2)
    # the warp kernels take fp32 alone; the by-mode dispatchers widen bf16
    with pytest.raises(TypeError, match="float32 only"):
        tops.warp_features_cuda(x.bfloat16(), torch.zeros(1, 1, 3, 16), 8, 4)
    with pytest.raises(TypeError, match="float32 only"):
        tops.warp_features_mxu(x.bfloat16(), torch.zeros(1, 1, 3, 16), 8, 4)
    with pytest.raises(TypeError, match="float32 only"):
        tops.warp_image_mxu(x[:, :3].bfloat16(), torch.zeros(1, 1, 3, 16), 8)


@pytest.mark.parametrize("mode", ["gather", "clamped", "onehot"])
def test_warps_by_mode_widen_bf16_inputs(mode):
    r = np.random.default_rng(3)
    feats = torch.from_numpy(_bf16_values(r.standard_normal((1, 5, 4, 40))))
    dx = torch.from_numpy(_bf16_values(r.uniform(-9, 5, (1, 1, 4, 40))))
    img = torch.from_numpy(_bf16_values(r.standard_normal((1, 3, 4, 40))))
    disp = torch.from_numpy(_bf16_values(r.uniform(0, 9, (1, 1, 4, 40))))
    for got, want in (
        (tops.warp_features_by_mode(feats.bfloat16(), dx.bfloat16(), mode, 8, 4),
         tops.warp_features_by_mode(feats, dx, mode, 8, 4)),
        (tops.warp_image_by_mode(img.bfloat16(), disp.bfloat16(), mode, 16),
         tops.warp_image_by_mode(img, disp, mode, 16)),
    ):
        assert got.dtype == torch.float32
        assert torch.equal(got, want)


# ------------------------------------------------------------------ models
def _frame(seed=0, d=5):
    """A smooth stereo pair (a few sinusoids per channel), the right image
    the left one shifted by ``d`` px, with its target."""
    r = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0 : W + d].astype(np.float32)
    base = np.zeros((H, W + d, 3), np.float32)
    for c in range(3):
        for _ in range(4):
            fx, fy = r.uniform(0.02, 0.2, 2)
            px, py = r.uniform(0, 2 * np.pi, 2)
            base[..., c] += r.uniform(10, 40) * np.sin(2 * np.pi * fx * xs + px) * np.cos(
                2 * np.pi * fy * ys + py
            )
    base = np.clip(base + 128, 0, 255).astype(np.float32)
    target = np.full((1, H, W, 1), float(d), np.float32)
    target[:, :, :d] = 0.0
    return {"left": base[None, :, :W].copy(), "right": base[None, :, d:].copy(), "target": target}


def _madnet_params(seed):
    """JAX MADNet weights with small non-zero biases; each estimator's last
    conv is tamed (weights x0.02, bias -0.3: a disparity of 6 px) and so is
    the context net's, so that the disparities are a few pixels wide and
    smooth in the weights. Untamed, Xavier weights predict hundreds of
    pixels, where any rounding moves the warps by whole pixels."""
    params = jax_net("MADNet").init(jax.random.PRNGKey(seed))
    r = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.01 * r.standard_normal(a.shape).astype(np.float32) if a.ndim == 1 else a,
        params,
    )
    for k in (6, 5, 4, 3, 2):
        layer = params[f"estimator_{k}"]["disp6"]
        layer["w"], layer["b"] = layer["w"] * 0.02, layer["b"] - 0.3
    params["context"]["context7"]["w"] = params["context"]["context7"]["w"] * 0.02
    return params


def _dispnet_params(seed):
    """JAX DispNet-Corr1D weights, each prediction layer tamed (weights
    x0.02, a bias that predicts about 6 px at its scale), as the DispNet
    parity tests make them."""
    params = jax_net("Dispnet", corr_mode="jnp").init(jax.random.PRNGKey(seed))
    r = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.01 * r.standard_normal(a.shape).astype(np.float32) if a.ndim == 1 else a,
        params,
    )
    for k, name in enumerate(["prediction", "up1", "up2", "up3", "up4", "up5"]):
        layer = params[name]["predict"] if name != "prediction" else params[name]
        layer["w"] = layer["w"] * 0.02
        layer["b"] = layer["b"] + np.float32(6.0 / 2 ** (k + 1))
    return params


# name: (weights, model options, MAD block config, block stepped,
#        (loss, block loss) relative tolerance, step gradient tolerance)
MODELS = {
    "MADNet": (_madnet_params, dict(warp_mode="gather"), "block_config/MadNet_full.json", 2, (1e-3, 1e-2), 1e-2),
    "Dispnet": (_dispnet_params, {}, "block_config/dispnet_full_6.json", 3, (1e-5, 1e-5), 3e-2),
}


def _closer_share(got, want, highest):
    """Among the entries where the reference in a mode (``want``) and the
    reference at ``highest`` differ, the share at which ``got`` lies closer
    to ``want``: about 0 for a port that ignored the mode, 1 for one that
    rounds as the reference does."""
    got, want, highest = (np.concatenate([np.ravel(a) for a in x]) for x in (got, want, highest))
    differ = want != highest
    assert differ.any()
    return float(np.mean(np.abs(got - want)[differ] < np.abs(got - highest)[differ]))


@pytest.fixture(scope="module")
def model_reference():
    """Per model: weights and the JAX disparities under each mode (a fresh
    net and jit per mode: the mode is read while tracing)."""
    frame = _frame()
    out = {}
    for name, (make, kw, *_) in MODELS.items():
        params = make(1)
        disps = {}
        for mode in ("highest", "bf16", "bf16_act"):
            with _jax_precision(mode):
                net = jax_net(name, corr_mode="jnp", **kw)
                o = jax.jit(net.forward)(params, jnp.asarray(frame["left"]), jnp.asarray(frame["right"]))
                disps[mode] = [(str(d.dtype), np.asarray(d.astype(jnp.float32))) for d in o["disparities"]]
        out[name] = (params, disps)
    return frame, out


def _port_disparities(name, params, frame, mode):
    with tops.conv_precision(mode):
        net = torch_net(name, corr_mode="torch", device="cpu", **MODELS[name][1])
        net.load_state_dict(params_from_jax(params))
        with torch.no_grad():
            o = net(torch.from_numpy(frame["left"]), torch.from_numpy(frame["right"]))
    assert o["full_res_disp"] is o["disparities"][-1]
    return o["disparities"]


def _forward_share(got, disps, mode):
    return _closer_share([_np(g) for g in got], [d for _, d in disps[mode]], [d for _, d in disps["highest"]])


@pytest.mark.parametrize("mode", ["bf16", "bf16_act"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_forward_matches_jax_in_bf16_modes(model_reference, name, mode):
    frame, out = model_reference
    params, disps = out[name]
    got = _port_disparities(name, params, frame, mode)
    assert len(got) == len(disps[mode])
    for i, (g, (jdt, want), (_, highest)) in enumerate(zip(got, disps[mode], disps["highest"])):
        # MADNet's heads emit fp32 in every mode, DispNet's bf16 under bf16_act
        assert str(g.dtype).replace("torch.", "") == jdt, f"disparities[{i}]"
        g = _np(g)
        assert g.shape == want.shape == (1, H, W, 1)
        np.testing.assert_allclose(g, want, rtol=0, atol=MAX_TOL * np.abs(highest).max(), err_msg=f"disparities[{i}]")
    # the port rounds as the reference does in this mode
    assert _forward_share(got, disps, mode) >= FWD_SHARE


@pytest.mark.parametrize("mode", ["bf16", "bf16_act"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_forward_check_fails_the_port_at_highest(model_reference, name, mode):
    """The control: the port run at ``highest`` fails the share check
    against the reference in ``mode``."""
    frame, out = model_reference
    params, disps = out[name]
    assert _forward_share(_port_disparities(name, params, frame, "highest"), disps, mode) < FWD_SHARE


def _flat(tree):
    return {k: np.asarray(v, np.float32) for k, v in flatten_params(tree).items()}


def _step_kw(name):
    kw = MODELS[name][1]
    return dict(kw, bulkhead=True) if name == "MADNet" else kw


@pytest.fixture(scope="module")
def step_reference(model_reference):
    """Per model: the JAX engine's MAD step on the model's block under
    ``highest`` and ``bf16_act``, as (new params, new optimizer state, results),
    and the trained leaves."""
    frame, out = model_reference
    steps = {}
    for name, (_, _, config, k, *_) in MODELS.items():
        params = out[name][0]
        steps[name] = {}
        for mode in ("highest", "bf16_act"):
            with _jax_precision(mode):
                jnet = jax_net(name, corr_mode="jnp", **_step_kw(name))
                blocks = jblocks.make_blocks(jblocks.load_block_config(config), jnet.layer_to_path)
                jeng = JaxEngine(jnet, blocks, lr=LR)
                new_p, new_o, res = jeng.adapt_block(k)(
                    jax.tree_util.tree_map(jnp.array, params), jeng.init_opt(params),
                    {n: jnp.asarray(v) for n, v in frame.items()},
                )
                losses = {n: float(res[n]) for n in ("loss", "block_loss")}
                steps[name][mode] = (_flat(new_p), _flat(new_o["acc"]), losses)
        steps[name]["trained"] = {"/".join(p) + "/" + leaf for p in jeng.blocks[k].paths for leaf in ("w", "b")}
    return steps


def _port_step(name, params, frame, mode):
    """The port's engine, one MAD step on the model's block under ``mode``:
    (engine, results, new params, gradients)."""
    _, _, config, k, *_ = MODELS[name]
    with tops.conv_precision(mode):
        tnet = torch_net(name, corr_mode="torch", device="cpu", **_step_kw(name))
        tnet.load_state_dict(params_from_jax(params))
        teng = TorchEngine(tnet, tblocks.make_blocks(tblocks.load_block_config(config), tnet), lr=LR, device="cpu")
        res = teng.adapt_block(k, frame)
    return teng, res, _flat(params_to_jax(tnet.state_dict())), _flat(params_to_jax(teng.opt["acc"]))


def _step_share(acc_got, steps):
    names = sorted(acc_got)
    return _closer_share([acc_got[n] for n in names], [steps["bf16_act"][1][n] for n in names],
                         [steps["highest"][1][n] for n in names])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_mad_step_matches_jax_under_bf16_act(model_reference, step_reference, name):
    """MADNet block 2 (with the bulkhead); DispNet block 3, whose gradient
    runs back through the bf16 correlation."""
    frame, out = model_reference
    params = out[name][0]
    *_, (loss_tol, block_loss_tol), grad_tol = MODELS[name]
    steps = step_reference[name]
    want, acc_want, res_j = steps["bf16_act"]
    teng, res_t, got, acc_got = _port_step(name, params, frame, "bf16_act")
    assert teng.precision == "bf16_act"
    np.testing.assert_allclose(float(res_t["loss"]), res_j["loss"], rtol=loss_tol)
    np.testing.assert_allclose(float(res_t["block_loss"]), res_j["block_loss"], rtol=block_loss_tol)
    # the master weights, their gradients and the optimizer state stay fp32
    assert all(p.dtype == torch.float32 for p in teng.model.parameters())
    acc_scale = max(np.abs(v).max() for v in acc_want.values())
    assert acc_scale > 0
    old = _flat(params)
    trained = steps["trained"]
    change_scale = max(np.abs(want[n] - old[n]).max() for n in trained)
    for n in sorted(acc_got):
        np.testing.assert_allclose(acc_got[n], acc_want[n], rtol=0, atol=grad_tol * acc_scale, err_msg=n)
        if n in trained:
            ulp = np.spacing(np.abs(old[n]).max().astype(np.float32))
            np.testing.assert_allclose(
                got[n] - old[n], want[n] - old[n], rtol=0, atol=grad_tol * change_scale + ulp, err_msg=n
            )
        else:
            np.testing.assert_array_equal(got[n], old[n], err_msg=n)
    # the gradient rounds as the reference's bf16_act step does
    assert _step_share(acc_got, steps) >= STEP_SHARE


@pytest.mark.parametrize("name", sorted(MODELS))
def test_mad_step_check_fails_the_port_at_highest(model_reference, step_reference, name):
    """The control: the port stepped at ``highest`` fails the share check
    against the reference's ``bf16_act`` step; DispNet's also fails the
    loss tolerance."""
    frame, out = model_reference
    _, res_t, _, acc_got = _port_step(name, out[name][0], frame, "highest")
    assert _step_share(acc_got, step_reference[name]) < STEP_SHARE
    if name == "Dispnet":
        loss_tol = MODELS[name][4][0]
        assert abs(float(res_t["loss"]) - step_reference[name]["bf16_act"][2]["loss"]) > loss_tol * abs(
            step_reference[name]["bf16_act"][2]["loss"]
        )


# ------------------------------------------------------------------ plumbing
def test_tf32_flags_follow_the_mode_through_resolve_device():
    for mode in MODES:
        with tops.conv_precision(mode):
            assert tops.get_conv_precision() == mode
            # someone else's setting is overwritten by the next entry point
            torch.backends.cudnn.allow_tf32 = mode != "default"
            torch.backends.cuda.matmul.allow_tf32 = True
            resolve_device("cpu")
            assert torch.backends.cudnn.allow_tf32 == (mode == "default")
            assert torch.backends.cuda.matmul.allow_tf32 is False
    assert tops.get_conv_precision() == "highest"
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


def test_conv_precision_context_restores_the_mode():
    with tops.conv_precision("bf16"):
        with pytest.raises(KeyError):
            with tops.conv_precision("bf16_act"):
                assert tops.get_conv_precision() == "bf16_act"
                raise KeyError("inside")
        assert tops.get_conv_precision() == "bf16"
    assert tops.get_conv_precision() == "highest"


def test_unknown_precision_raises():
    with pytest.raises(ValueError, match="unknown conv precision"):
        tops.set_conv_precision("fp8")
    with pytest.raises(ValueError, match="unknown conv precision"):
        with tops.conv_precision("HIGHEST"):
            pass
    assert tconv.get_conv_precision() == "highest"


def test_sessions_refuse_a_step_after_the_mode_changed():
    """An engine records the mode it was built under; a step under another
    raises in the engine, the host session and the fused session (whose
    graphs would replay the old mode)."""
    frame = _frame(1)
    with tops.conv_precision("bf16_act"):
        net = torch_net("MADNet", warp_mode="gather", bulkhead=True, device="cpu")
        blocks = tblocks.make_blocks(tblocks.load_block_config("block_config/MadNet_full.json"), net)
        eng = TorchEngine(net, blocks, lr=LR, device="cpu")
        fused = FusedOnlineSession(eng, mode="MAD", sample_mode="SEQUENTIAL", max_steps=4)
        host = TorchSession(eng, mode="MAD", sample_mode="SEQUENTIAL")
        fused.step(frame)
        assert fused.fetch_disp()().dtype == np.float32
    for mode in ("highest", "bf16"):
        with tops.conv_precision(mode):
            with pytest.raises(RuntimeError, match="bf16_act"):
                fused.step(frame)
            with pytest.raises(RuntimeError, match="bf16_act"):
                host.step(frame)
            with pytest.raises(RuntimeError, match="bf16_act"):
                eng.infer(frame)
    assert int(fused.finalize()["steps"]) == 1


def test_fused_session_fetches_a_bf16_disparity_widened():
    """DispNet under bf16_act returns bf16 disparities; numpy has no bf16,
    so a fetched disparity is widened to float32, losslessly."""
    frame = _frame(2)
    with tops.conv_precision("bf16_act"):
        net = torch_net("Dispnet", device="cpu")
        eng = TorchEngine(net, lr=LR, device="cpu")
        sess = FusedOnlineSession(eng, mode="NONE")
        sess.step(frame)
        assert sess.last_disp.dtype == torch.bfloat16
        host = sess.fetch_disp()()
    assert host.dtype == np.float32 and host.shape == (1, H, W, 1)
    np.testing.assert_array_equal(host, _np(sess.last_disp))
    assert np.isfinite(sess.finalize()["loss"]).all()
