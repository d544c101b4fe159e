"""The PyTorch port's MADNet against the JAX MADNet on the CPU, and the
weight converter and npz checkpoints between the two packages.

Full-width MADNet with random JAX weights carried across with
``params_from_jax``, at 60x120 (not a multiple of 64, so the REFLECT pad
and the centre crop run). Each warp mode is pinned: a random-weight
MADNet produces disparities beyond the clamp windows, where ``gather``
and the clamped semantics differ. Tolerance: 1e-4 relative to the
largest disparity, the figure the JAX package holds against TF1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch.models import MADNet as TorchMADNet
from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net as torch_net
from real_time_self_adaptive_deep_stereo_torch.utils import checkpoint as tckpt
from real_time_self_adaptive_deep_stereo_tpu.models import get_stereo_net as jax_net
from real_time_self_adaptive_deep_stereo_tpu.utils import checkpoint as jckpt

H, W = 60, 120
RTOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    net = jax_net("MADNet", corr_mode="jnp")
    params = net.init(jax.random.PRNGKey(0))
    # non-zero biases so the bias mapping is exercised too
    r = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.01 * r.standard_normal(a.shape).astype(np.float32) if a.ndim == 1 else a,
        params,
    )
    left = (r.random((1, H, W, 3)) * 255).astype(np.float32)
    right = (r.random((1, H, W, 3)) * 255).astype(np.float32)
    return params, left, right


@pytest.fixture(scope="module")
def jax_outputs(setup):
    params, left, right = setup
    outs = {}
    for mode in ("gather", "shift"):
        net = jax_net("MADNet", corr_mode="jnp", warp_mode=mode)
        o = jax.jit(net.forward)(params, jnp.asarray(left), jnp.asarray(right))
        outs[mode] = [np.asarray(d) for d in o["disparities"]]
    return outs


def _torch_forward(params, left, right, warp_mode):
    net = torch_net("MADNet", corr_mode="torch", warp_mode=warp_mode, device="cpu")
    net.load_state_dict(tckpt.params_from_jax(params))
    with torch.no_grad():
        o = net(torch.from_numpy(left), torch.from_numpy(right))
    assert o["full_res_disp"] is o["disparities"][-1]
    return [d.numpy() for d in o["disparities"]]


def _assert_disparities_close(got, want):
    assert len(got) == len(want) == 6
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (1, H, W, 1)
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * scale, err_msg=f"disparities[{i}]")


@pytest.mark.parametrize("port_mode,jax_mode", [("gather", "gather"), ("clamped", "shift")])
def test_madnet_forward_matches_jax(setup, jax_outputs, port_mode, jax_mode):
    params, left, right = setup
    got = _torch_forward(params, left, right, port_mode)
    _assert_disparities_close(got, jax_outputs[jax_mode])


def test_madnet_warp_modes_differ_out_of_window(jax_outputs):
    """The random-weight disparities do leave the clamp windows, so the
    two pinned comparisons above test different semantics."""
    diff = max(float(np.abs(a - b).max()) for a, b in zip(jax_outputs["gather"], jax_outputs["shift"]))
    assert diff > 1e-3


def test_madnet_parameter_groups_match_jax(setup):
    params, _, _ = setup
    net = TorchMADNet(device="cpu")
    sd = net.state_dict()
    conv = tckpt.params_from_jax(params)
    assert set(sd) == set(conv)
    for k, v in conv.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    groups = {k.split(".")[0] for k in sd}
    assert groups == {"pyramid", "context"} | {f"estimator_{k}" for k in (2, 3, 4, 5, 6)}
    assert net.layer_to_path("left/conv3") == ("pyramid", "conv3")
    assert net.layer_to_path("fgc-volume-filtering-4/disp2") == ("estimator_4", "disp2")
    assert net.tf_name_map() == jax_net("MADNet").tf_name_map()


def test_params_from_jax_roundtrip(setup):
    params, _, _ = setup
    back = tckpt.params_to_jax(tckpt.params_from_jax(params))
    flat_a, flat_b = jckpt.flatten_params(params), tckpt.flatten_params(back)
    assert set(flat_a) == set(flat_b)
    for k in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_a[k]), flat_b[k])
    # the flat npz form converts the same as the tree
    flat_sd = tckpt.params_from_jax(flat_a)
    tree_sd = tckpt.params_from_jax(params)
    assert all(torch.equal(flat_sd[k], tree_sd[k]) for k in tree_sd)


def test_jax_saved_npz_loads_into_port(setup, jax_outputs, tmp_path):
    params, left, right = setup
    path = str(tmp_path / "madnet.npz")
    jckpt.save_params(path, params)
    loaded = tckpt.load_params(path)
    got = _torch_forward(loaded, left, right, "gather")
    _assert_disparities_close(got, jax_outputs["gather"])
    # and the port writes a file the JAX package reads back unchanged
    path2 = str(tmp_path / "port.npz")
    tckpt.save_params(path2, tckpt.params_to_jax(tckpt.params_from_jax(loaded)))
    flat = jckpt.flatten_params(jckpt.load_params(path2))
    for k, v in jckpt.flatten_params(params).items():
        np.testing.assert_array_equal(flat[k], np.asarray(v))


def test_entry_points_need_cuda_or_cpu():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_net("Dispnet", device="cpu")
    if not torch.cuda.is_available():  # no silent fallback to the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            torch_net("MADNet")
