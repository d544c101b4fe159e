"""The PyTorch port's DispNet-Corr1D against the JAX DispNet on the CPU:
forward in both variants, the weight converter, the MAD blocks and one
engine step of MAD and of FULL adaptation.

Full-width DispNet (the published widths) with JAX weights carried across
with ``params_from_jax``, at 70x130: not a multiple of 64, so the REFLECT
pad and the centre crop run. Both packages run their plain correlation
on the CPU ('jnp' in JAX, the port's plain version). Tolerances: the
disparities within 1e-4 of the largest, the figure the JAX package holds
against TF1; a step's parameter change and gradient within 5e-4 of the
largest entry, the float32 noise of a backward pass through the whole
network (``tests/test_torch_adapt.py`` gives the measurement).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch.adapt import AdaptationEngine as TorchEngine
from real_time_self_adaptive_deep_stereo_torch.adapt import OnlineAdaptationSession as TorchSession
from real_time_self_adaptive_deep_stereo_torch.adapt import blocks as tblocks
from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net as torch_net
from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import (
    flatten_params,
    params_from_jax,
    params_to_jax,
)
from real_time_self_adaptive_deep_stereo_tpu.adapt import AdaptationEngine as JaxEngine
from real_time_self_adaptive_deep_stereo_tpu.adapt import blocks as jblocks
from real_time_self_adaptive_deep_stereo_tpu.models import get_stereo_net as jax_net

H, W = 70, 130
RTOL = 1e-4
GRAD_TOL = 5e-4
LR = 1e-4
BLOCK_CONFIG = "block_config/dispnet_full_6.json"


def _jax_params(correlation, seed):
    """JAX DispNet weights with small non-zero biases, so that the bias
    mapping is exercised too. Each prediction layer is tamed (weights
    x0.02, a bias that predicts about 6 px at its scale): with Xavier
    weights alone the relu of ``_make_disp`` zeroes some predictions
    everywhere, and a block whose prediction is all zero gets no
    gradient."""
    net = jax_net("Dispnet", correlation=correlation, corr_mode="jnp")
    params = net.init(jax.random.PRNGKey(seed))
    r = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.01 * r.standard_normal(a.shape).astype(np.float32) if a.ndim == 1 else a,
        params,
    )
    # _make_disp multiplies the prediction of block upK by 2**(K+1)
    for k, name in enumerate(["prediction", "up1", "up2", "up3", "up4", "up5"]):
        layer = params[name]["predict"] if name != "prediction" else params[name]
        layer["w"] = layer["w"] * 0.02
        layer["b"] = layer["b"] + np.float32(6.0 / 2 ** (k + 1))
    return params


def _frame(seed):
    """A smooth stereo pair (a few sinusoids per channel), the right image
    the left one shifted by 6 px, with its target disparity."""
    r = np.random.default_rng(seed)
    d = 6
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


@pytest.fixture(scope="module")
def nets():
    """Per variant: the JAX net, its weights and its forward on one frame."""
    frame = _frame(0)
    out = {}
    for corr in (True, False):
        net = jax_net("Dispnet", correlation=corr, corr_mode="jnp")
        params = _jax_params(corr, seed=1 if corr else 2)
        o = jax.jit(net.forward)(params, jnp.asarray(frame["left"]), jnp.asarray(frame["right"]))
        out[corr] = (net, params, [np.asarray(d) for d in o["disparities"]])
    return frame, out


def _torch_net(params, correlation=True):
    net = torch_net("Dispnet", correlation=correlation, corr_mode="torch", device="cpu")
    net.load_state_dict(params_from_jax(params))
    return net


@pytest.mark.parametrize("correlation", [True, False], ids=["corr1d", "simple"])
def test_dispnet_forward_matches_jax(nets, correlation):
    frame, out = nets
    _, params, want = out[correlation]
    net = _torch_net(params, correlation)
    left, right = torch.from_numpy(frame["left"]), torch.from_numpy(frame["right"])
    with torch.no_grad():
        o = net(left, right)
        split = net.estimate_from_features(net.extract_features(left, right))
    got = [d.numpy() for d in o["disparities"]]
    assert o["full_res_disp"] is o["disparities"][-1]
    assert len(got) == len(want) == 7
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (1, H, W, 1)
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * scale, err_msg=f"disparities[{i}]")
    # the split forward is the whole forward
    for a, b in zip(split["disparities"], o["disparities"]):
        assert torch.equal(a, b)


def test_dispnet_parameters_and_names_match_jax(nets):
    _, out = nets
    for corr in (True, False):
        jnet, params, _ = out[corr]
        net = torch_net("Dispnet", correlation=corr, device="cpu")
        sd, conv = net.state_dict(), params_from_jax(params)
        assert set(sd) == set(conv)
        for k, v in conv.items():
            assert tuple(sd[k].shape) == tuple(v.shape), k
        assert ("conv_redir.weight" in sd) == corr
        assert net.tf_name_map() == jnet.tf_name_map()
        assert net.num_adaptable_predictions == jnet.num_adaptable_predictions == 6
    # a transposed kernel [kh, kw, out, in] becomes ConvTranspose2d's [in, out, kh, kw]
    assert tuple(sd["up5.deconv.weight"].shape) == (1024, 512, 4, 4)
    for name in ("conv1a", "conv2b", "conv3/1", "conv6", "up3/up_predict", "prediction", "corr"):
        assert net.layer_to_path(name) == jnet.layer_to_path(name), name


def test_dispnet_params_roundtrip(nets):
    """``params_to_jax(params_from_jax(tree))`` gives the JAX tree back
    exactly, transposed kernels included."""
    _, out = nets
    for corr in (True, False):
        params = out[corr][1]
        back = flatten_params(params_to_jax(params_from_jax(params)))
        want = flatten_params(params)
        assert set(back) == set(want)
        for k in want:
            assert back[k].shape == want[k].shape, k
            np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_dispnet_blocks_partition_params_as_jax(nets):
    _, out = nets
    jnet, params, _ = out[True]
    net = _torch_net(params)
    groups = tblocks.load_block_config(BLOCK_CONFIG)
    tb = tblocks.make_blocks(groups, net)
    jb = jblocks.make_blocks(jblocks.load_block_config(BLOCK_CONFIG), jnet.layer_to_path)
    assert len(tb) == len(jb) == net.num_adaptable_predictions
    assert [b.paths for b in tb] == [b.paths for b in jb]
    names = [n for b in tb for n in b.names]
    assert sorted(names) == sorted(net.state_dict())  # every parameter, once
    assert {"conv2.weight", "up2.deconv.bias"} <= set(tb[3].names)
    assert tb[5].names == ["prediction.weight", "prediction.bias"]
    # the default config is the reference's 5-group file, as in JAX
    path = tblocks.default_block_config_path("Dispnet")
    assert path.endswith("dispnet_full.json")
    assert tblocks.load_block_config(path) == jblocks.load_block_config(
        jblocks.default_block_config_path("Dispnet")
    )


@pytest.fixture(scope="module")
def jax_engine(nets):
    _, out = nets
    jnet, params, _ = out[True]
    blocks = jblocks.make_blocks(jblocks.load_block_config(BLOCK_CONFIG), jnet.layer_to_path)
    return JaxEngine(jnet, blocks, lr=LR), params


def _torch_engine(params):
    net = _torch_net(params)
    blocks = tblocks.make_blocks(tblocks.load_block_config(BLOCK_CONFIG), net)
    return TorchEngine(net, blocks, lr=LR, device="cpu")


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_params(tree).items()}


def _assert_step_matches(params, teng, new_jax, opt_jax, trained):
    """Each trained tensor's change within GRAD_TOL of the largest change
    (plus one rounding of the parameter), every other tensor unchanged,
    and the momentum accumulator (the gradient) within GRAD_TOL of its
    largest entry."""
    old, want = _flat(params), _flat(new_jax)
    got = _flat(params_to_jax(teng.model.state_dict()))
    assert set(got) == set(want)
    scale = max(np.abs(want[k] - old[k]).max() for k in trained)
    assert scale > 0
    for k in sorted(got):
        if k in trained:
            ulp = np.spacing(np.abs(old[k]).max().astype(np.float32))
            np.testing.assert_allclose(
                got[k] - old[k], want[k] - old[k], rtol=0, atol=GRAD_TOL * scale + ulp, err_msg=k
            )
        else:
            np.testing.assert_array_equal(got[k], old[k], err_msg=k)
    acc_want, acc_got = _flat(opt_jax["acc"]), _flat(params_to_jax(teng.opt["acc"]))
    acc_scale = max(np.abs(v).max() for v in acc_want.values())
    assert acc_scale > 0
    for k in sorted(acc_got):
        np.testing.assert_allclose(acc_got[k], acc_want[k], rtol=0, atol=GRAD_TOL * acc_scale, err_msg=k)


def _copy(tree):
    # the JAX steps donate their params and optimizer state
    return jax.tree_util.tree_map(lambda x: x.copy(), tree)


@pytest.mark.parametrize("k", [3, 5], ids=["block3-conv2-through-the-correlation", "block5-prediction"])
def test_dispnet_mad_step_matches_jax(nets, jax_engine, k):
    """Block 3 (up2, conv2) takes its gradient back through the
    correlation; block 5 (the final prediction) stops before it."""
    frame, _ = nets
    jeng, params = jax_engine
    new_p, new_o, res_j = jeng.adapt_block(k)(
        _copy(params), jeng.init_opt(params), {n: jnp.asarray(v) for n, v in frame.items()}
    )
    teng = _torch_engine(params)
    res_t = teng.adapt_block(k, frame)
    np.testing.assert_allclose(float(res_t["loss"]), float(res_j["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(res_t["block_loss"]), float(res_j["block_loss"]), rtol=1e-5)
    trained = {"/".join(p) + "/" + leaf for p in jeng.blocks[k].paths for leaf in ("w", "b")}
    _assert_step_matches(params, teng, new_p, new_o, trained)


def test_dispnet_full_step_matches_jax(nets, jax_engine):
    frame, _ = nets
    jeng, params = jax_engine
    new_p, new_o, res_j = jeng.adapt_full(
        _copy(params), jeng.init_opt(params), {n: jnp.asarray(v) for n, v in frame.items()}
    )
    teng = _torch_engine(params)
    res_t = teng.adapt_full(frame)
    np.testing.assert_allclose(float(res_t["loss"]), float(res_j["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(res_t["epe"]), float(res_j["epe"]), rtol=1e-4)
    _assert_step_matches(params, teng, new_p, new_o, set(_flat(params)))


def test_dispnet_mad_session_runs_with_6_group_config(nets):
    """Two frames of a MAD session over ``dispnet_full_6.json``: finite
    losses, and each frame trains its SEQUENTIAL block alone."""
    frame, out = nets
    teng = _torch_engine(out[True][1])
    sess = TorchSession(teng, mode="MAD", sample_mode="SEQUENTIAL", ssim_th=1e9, seed=0)
    assert len(teng.blocks) == 6
    for k in range(2):
        before = {n: p.detach().clone() for n, p in teng.model.named_parameters()}
        res = sess.step(frame)
        assert np.isfinite(res["loss"]) and tuple(res["disp"].shape) == (1, H, W, 1)
        changed = {n for n, p in teng.model.named_parameters() if not torch.equal(p, before[n])}
        assert changed and changed <= set(teng.blocks[k].names)
    assert sess.stats.fetch_counter == [1, 1, 0, 0, 0, 0]
