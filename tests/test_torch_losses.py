"""The PyTorch port's loss registry and its supervised and proxy factories
against the JAX package on the CPU, and one proxy-adaptation step of the
engine. Inputs are made with numpy from a seed and handed to both
packages (NHWC in both)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch.adapt import AdaptationEngine as TorchEngine
from real_time_self_adaptive_deep_stereo_torch.adapt import blocks as tblocks
from real_time_self_adaptive_deep_stereo_torch.losses import factory as tloss
from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net as torch_net
from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import (
    flatten_params,
    params_from_jax,
    params_to_jax,
)
from real_time_self_adaptive_deep_stereo_tpu.adapt import AdaptationEngine as JaxEngine
from real_time_self_adaptive_deep_stereo_tpu.adapt import blocks as jblocks
from real_time_self_adaptive_deep_stereo_tpu.losses import factory as jloss
from real_time_self_adaptive_deep_stereo_tpu.models import get_stereo_net as jax_net

MASKED = {"l1", "l2", "mean_l1", "mean_l2", "sum_l1", "sum_l2", "mean_huber", "sum_huber"}


def _pair(seed, shape=(2, 12, 17, 3)):
    r = np.random.default_rng(seed)
    # differences on both sides of the Huber switch at +1
    return (r.random(shape) * 4).astype(np.float32), (r.random(shape) * 4).astype(np.float32)


def test_registries_list_what_jax_lists():
    assert set(tloss.SUPERVISED_LOSS) == set(jloss.SUPERVISED_LOSS)
    assert set(tloss.PIXELWISE_LOSSES) == set(jloss.PIXELWISE_LOSSES)
    assert set(tloss.ALL_LOSSES) == set(jloss.ALL_LOSSES)
    with pytest.raises(KeyError, match="Unknown loss"):
        tloss.get_supervised_loss("no_such_loss")


@pytest.mark.parametrize("name", sorted(jloss.ALL_LOSSES))
def test_loss_matches_jax(name):
    """Value (1e-5 relative) and gradient with respect to the prediction
    (1e-5 of its largest entry) of every registered loss."""
    # the JAX package's Sobel filter takes single-channel maps only
    x, y = _pair(1, (2, 12, 17, 1) if name == "smoothness" else (2, 12, 17, 3))
    mask = (np.random.default_rng(2).random(x.shape) < 0.7).astype(np.float32)
    args_j = [jnp.asarray(x), jnp.asarray(y)] + ([jnp.asarray(mask)] if name in MASKED else [])
    tx = torch.from_numpy(x).requires_grad_()
    args_t = [tx, torch.from_numpy(y)] + ([torch.from_numpy(mask)] if name in MASKED else [])
    want = np.asarray(jloss.ALL_LOSSES[name](*args_j))
    got = tloss.ALL_LOSSES[name](*args_t)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    want_g = np.asarray(jax.grad(lambda a: jnp.sum(jloss.ALL_LOSSES[name](a, *args_j[1:])))(args_j[0]))
    (got_g,) = torch.autograd.grad(got.sum(), tx)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0, atol=1e-5 * max(np.abs(want_g).max(), 1e-12))


def test_unregistered_primitives_match_jax():
    x, y = _pair(3)
    x, y = x - 2, y - 2
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jx_, jy = jnp.asarray(x), jnp.asarray(y)
    np.testing.assert_allclose(
        float(tloss.sign_and_elementwise(tx, ty)), float(jloss.sign_and_elementwise(jx_, jy)), rtol=1e-6
    )
    np.testing.assert_allclose(
        float(tloss.cos_similarity(tx, ty, normalize=True)),
        float(jloss.cos_similarity(jx_, jy, normalize=True)),
        rtol=1e-5,
    )
    # the Huber switch is on the signed difference: a difference below -1
    # stays quadratic
    np.testing.assert_allclose(float(tloss.huber(torch.tensor(-3.0), torch.tensor(0.0))), 4.5)
    np.testing.assert_allclose(float(tloss.huber(torch.tensor(3.0), torch.tensor(0.0))), 2.5)


def _label_case(seed):
    r = np.random.default_rng(seed)
    h, w = 24, 40
    inputs = {
        "left": (r.random((1, h, w, 3)) * 255).astype(np.float32),
        "target": (r.random((1, h, w, 1)) * 250 - 20).astype(np.float32).clip(0),  # zeros: invalid
        "proxy": (r.random((1, h, w, 1)) * 250 - 20).astype(np.float32),  # <= 0 and >= 192: invalid
    }
    ds = [(r.random((1, hh, ww, 1)) * 30).astype(np.float32) for hh, ww in ((6, 10), (12, 20), (24, 40))]
    return inputs, ds


@pytest.mark.parametrize("factory", ["get_supervised_loss", "get_proxy_loss"])
@pytest.mark.parametrize("name,multiscale", [("mean_l1", False), ("mean_l1", True), ("sum_huber", True)])
def test_label_loss_factories_match_jax(factory, name, multiscale):
    inputs, ds = _label_case(4)
    kw = dict(multiScale=multiscale, max_disp=192) if factory == "get_supervised_loss" else dict(
        multiScale=multiscale, weights=[0.1] * 10
    )
    want = getattr(jloss, factory)(name, **kw)(
        [jnp.asarray(d) for d in ds], {k: jnp.asarray(v) for k, v in inputs.items()}
    )
    got = getattr(tloss, factory)(name, **kw)(
        [torch.from_numpy(d) for d in ds], {k: torch.from_numpy(v) for k, v in inputs.items()}
    )
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    parts_j = getattr(jloss, factory)(name, multiScale=True, reduced=False)(
        [jnp.asarray(d) for d in ds], {k: jnp.asarray(v) for k, v in inputs.items()}
    )
    parts_t = getattr(tloss, factory)(name, multiScale=True, reduced=False)(
        [torch.from_numpy(d) for d in ds], {k: torch.from_numpy(v) for k, v in inputs.items()}
    )
    np.testing.assert_allclose([float(p) for p in parts_t], [float(p) for p in parts_j], rtol=1e-5)


def test_proxy_adaptation_step_matches_jax():
    """One MAD step on block 0 with ``adaptation='proxy'``: the block loss
    (weights 0.1), the full loss (weights 0.01) and the gradient, held to
    5e-4 of its largest entry (the float32 noise of a backward pass, see
    ``test_torch_adapt.py``)."""
    h = w = 64
    r = np.random.default_rng(5)
    frame = {
        "left": (r.random((1, h, w, 3)) * 255).astype(np.float32),
        "right": (r.random((1, h, w, 3)) * 255).astype(np.float32),
        "target": (r.random((1, h, w, 1)) * 60).astype(np.float32),
        "proxy": (r.random((1, h, w, 1)) * 230 - 20).astype(np.float32),
    }
    net = jax_net("MADNet", corr_mode="jnp")
    params = net.init(jax.random.PRNGKey(0))
    blocks = jblocks.make_blocks(jblocks.load_block_config("block_config/MadNet_full.json"), net.layer_to_path)
    jeng = JaxEngine(net, blocks, lr=1e-4, adaptation="proxy")
    _, opt_j, res_j = jeng.adapt_block(0)(
        jax.tree_util.tree_map(lambda x: x.copy(), params),
        jeng.init_opt(params),
        {k: jnp.asarray(v) for k, v in frame.items()},
    )

    model = torch_net("MADNet", device="cpu")
    model.load_state_dict(params_from_jax(params))
    tb = tblocks.make_blocks(tblocks.load_block_config("block_config/MadNet_full.json"), model)
    teng = TorchEngine(model, tb, lr=1e-4, adaptation="proxy", device="cpu")
    res_t = teng.adapt_block(0, frame)
    np.testing.assert_allclose(float(res_t["loss"]), float(res_j["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(res_t["block_loss"]), float(res_j["block_loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(res_t["block_loss"]) / float(res_t["loss"]), 10.0, rtol=0.5)
    want = {k: np.asarray(v) for k, v in flatten_params(opt_j["acc"]).items()}
    got = {k: np.asarray(v) for k, v in flatten_params(params_to_jax(teng.opt["acc"])).items()}
    scale = max(np.abs(v).max() for v in want.values())
    assert scale > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=5e-4 * scale, err_msg=k)
