"""The PyTorch port's MAD/FULL adaptation against the JAX package on the
CPU: blocks, optimizers, the engine's steps and the host session.

Frames are made with numpy from a seed and handed to both packages;
weights go from JAX to the port through ``params_from_jax`` and adapted
weights come back through ``params_to_jax``. On the CPU both packages
run their plain ops ('gather' warps, plain correlation).

Tolerances. A step's parameter change ``new - old`` and the optimizer's
accumulator (the gradient, after one momentum step) are compared to
GRAD_TOL = 5e-4 of their largest entry. That is the float32 noise of a
backward pass through the whole network: against a float64 run of the
port on the full step's frame, the port's float32 gradient lies within
5.5e-5 of the largest entry and the JAX package's within 1.9e-4, and the
two float32 gradients within 1.6e-4 of each other. The parameter change
also gets one float32 rounding of the parameter itself, since
``old - lr*acc`` is rounded once in each package. Losses agree to 1e-5
relative on the first frame and to 1e-4 along a trajectory, as the JAX
package's own fused-vs-host tests allow; the EPE of a trajectory to 1e-3
(these random-weight disparities are some 90 px off and move by the
gradients' noise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch.adapt import AdaptationEngine as TorchEngine
from real_time_self_adaptive_deep_stereo_torch.adapt import OnlineAdaptationSession as TorchSession
from real_time_self_adaptive_deep_stereo_torch.adapt import blocks as tblocks
from real_time_self_adaptive_deep_stereo_torch.adapt import get_sampler as t_sampler
from real_time_self_adaptive_deep_stereo_torch.adapt import softmax as t_softmax
from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net as torch_net
from real_time_self_adaptive_deep_stereo_torch.utils import optim as toptim
from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import (
    flatten_params,
    params_from_jax,
    params_to_jax,
)
from real_time_self_adaptive_deep_stereo_tpu.adapt import AdaptationEngine as JaxEngine
from real_time_self_adaptive_deep_stereo_tpu.adapt import OnlineAdaptationSession as JaxSession
from real_time_self_adaptive_deep_stereo_tpu.adapt import blocks as jblocks
from real_time_self_adaptive_deep_stereo_tpu.models import get_stereo_net as jax_net
from real_time_self_adaptive_deep_stereo_tpu.utils import optim as joptim

H, W = 64, 64  # the JAX adaptation tests' own size
BLOCK_CONFIG = "block_config/MadNet_full.json"
LR = 1e-4
GRAD_TOL = 5e-4


def _frames(seed, n):
    """Stereo pairs a network can follow: a smooth texture (a few
    sinusoids per channel), the right image being the left one shifted by
    a known disparity. On white-noise images the photometric loss is so
    rough in the weights that two float32 runs drift apart tenfold a
    step; on these they stay within 1e-6."""
    r = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0 : W + 16].astype(np.float32)
    out = []
    for i in range(n):
        d = 3 + i
        base = np.zeros((H, W + 16, 3), np.float32)
        for c in range(3):
            for _ in range(6):
                fx, fy = r.uniform(0.02, 0.25, 2)
                px, py = r.uniform(0, 2 * np.pi, 2)
                base[..., c] += r.uniform(10, 40) * np.sin(2 * np.pi * fx * xs + px) * np.cos(
                    2 * np.pi * fy * ys + py
                )
        base = np.clip(base + 128, 0, 255).astype(np.float32)
        target = np.full((1, H, W, 1), float(d), np.float32)
        target[:, :, :d] = 0.0
        out.append(
            {"left": base[None, :, :W].copy(), "right": base[None, :, d : W + d].copy(), "target": target}
        )
    return out


def _jframe(f):
    return {k: jnp.asarray(v) for k, v in f.items()}


def _copy(tree):
    # the JAX steps donate their params and optimizer state
    return jax.tree_util.tree_map(lambda x: x.copy(), tree)


class _Jax:
    """One JAX net, its blocks and its engines, built once per module so
    that every jitted step compiles once."""

    def __init__(self, bulkhead):
        self.net = jax_net("MADNet", corr_mode="jnp", bulkhead=bulkhead)
        self.bulkhead = bulkhead
        self.params = self.net.init(jax.random.PRNGKey(0))
        groups = jblocks.load_block_config(BLOCK_CONFIG)
        self.blocks = jblocks.make_blocks(groups, self.net.layer_to_path)
        self._engines = {}

    def engine(self, **kw):
        key = tuple(sorted(kw.items()))
        if key not in self._engines:
            self._engines[key] = JaxEngine(self.net, self.blocks, lr=LR, **kw)
        return self._engines[key]

    def torch_engine(self, **kw):
        """A fresh port engine on the CPU with the same weights."""
        model = torch_net("MADNet", device="cpu", bulkhead=self.bulkhead)
        model.load_state_dict(params_from_jax(self.params))
        blocks = tblocks.make_blocks(tblocks.load_block_config(BLOCK_CONFIG), model)
        return TorchEngine(model, blocks, lr=LR, device="cpu", **kw)


@pytest.fixture(scope="module")
def jx():
    return _Jax(bulkhead=False)


@pytest.fixture(scope="module")
def jx_bulkhead():
    return _Jax(bulkhead=True)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_params(tree).items()}


def _block_keys(jx, ks):
    """Flat JAX keys ('pyramid/conv12/w') of the parameters in blocks ks."""
    return {
        "/".join(p) + "/" + leaf for k in ks for p in jx.blocks[k].paths for leaf in ("w", "b")
    }


def _assert_step_matches(jx, teng, new_jax, opt_jax, trained, slot="acc"):
    """The port's parameters after a step against JAX's: the change of
    every trained tensor within GRAD_TOL of the largest change (plus one
    rounding of the parameter), every other tensor bit-identical to
    before, and the optimizer slot ``slot`` within GRAD_TOL of its
    largest entry."""
    old = _flat(jx.params)
    want = _flat(new_jax)
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
            np.testing.assert_array_equal(want[k], old[k], err_msg=k)
    slot_want = _flat(opt_jax[slot])
    slot_got = _flat(params_to_jax(teng.opt[slot]))
    slot_scale = max(np.abs(v).max() for v in slot_want.values())
    assert slot_scale > 0
    for k in sorted(slot_got):
        np.testing.assert_allclose(
            slot_got[k], slot_want[k], rtol=0, atol=GRAD_TOL * slot_scale, err_msg=f"{slot} {k}"
        )
        if k not in trained:
            assert not slot_got[k].any(), k


def _assert_outputs_match(res_t, res_j, rtol=1e-5):
    one_pixel = 1.0 / (H * W)
    np.testing.assert_allclose(float(res_t["loss"]), float(res_j["loss"]), rtol=rtol)
    np.testing.assert_allclose(float(res_t["epe"]), float(res_j["epe"]), rtol=1e-4)
    # count metrics: a pixel at the threshold may flip under 1e-6 noise
    np.testing.assert_allclose(float(res_t["bad3"]), float(res_j["bad3"]), atol=1.01 * one_pixel)
    np.testing.assert_allclose(float(res_t["d1"]), float(res_j["d1"]), atol=101 * one_pixel)


# --------------------------------------------------------------------- blocks


def test_blocks_partition_params_as_jax(jx):
    teng = jx.torch_engine()
    assert len(teng.blocks) == len(jx.blocks) == 5
    state = teng.model.state_dict()
    seen = []
    for tb, jb in zip(teng.blocks, jx.blocks):
        assert tb.paths == jb.paths
        want = sorted(
            "/".join(p) + "/" + leaf for p in jb.paths for leaf in jb.extract(jx.params)["/".join(p)]
        )
        got = sorted(n.replace(".", "/").replace("weight", "w").replace("bias", "b") for n in tb.names)
        assert got == want
        for name, param in tb.named_params().items():
            assert param is dict(teng.model.named_parameters())[name]
            assert param.shape == state[name].shape
        seen += tb.names
    # block 0 = scale 6: estimator_6 + pyramid conv11/conv12; left/ and
    # right/ name the same convs; the five blocks cover every parameter once
    assert {"estimator_6.disp1.weight", "pyramid.conv12.bias"} <= set(teng.blocks[0].names)
    assert {"context.context7.weight", "pyramid.conv1.weight"} <= set(teng.blocks[4].names)
    assert sorted(seen) == sorted(state)
    shared = tblocks.make_blocks([["left/conv1", "right/conv1", "no-such-layer"]], teng.model)
    assert shared[0].names == ["pyramid.conv1.weight", "pyramid.conv1.bias"]
    assert tblocks.load_block_config(tblocks.default_block_config_path("MADNet")) == (
        jblocks.load_block_config(jblocks.default_block_config_path("MADNet"))
    )


# ------------------------------------------------------------------ optimizer


def _opt_case(seed):
    r = np.random.default_rng(seed)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [
        {k: (r.normal(size=s) * 10.0 ** r.integers(-3, 2)).astype(np.float32) for k, s in shapes.items()}
        for _ in range(3)
    ]
    return params, grads


def test_momentum_matches_jax():
    params, grads = _opt_case(1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jacc = joptim.momentum_init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tacc = toptim.momentum_init(tp)
    for g in grads:
        jp, jacc = joptim.momentum_update(jp, jacc, {k: jnp.asarray(v) for k, v in g.items()}, 0.01, 0.9)
        toptim.momentum_update(tp, tacc, {k: torch.from_numpy(v) for k, v in g.items()}, 0.01, 0.9)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(tacc[k].numpy(), np.asarray(jacc[k]), rtol=1e-6, atol=1e-7)


def test_adam_matches_jax():
    params, grads = _opt_case(2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = joptim.adam_init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in params]  # a list works as a dict does
    tstate = toptim.adam_init(tp)
    for g in grads:
        jp, jstate = joptim.adam_update(jp, jstate, {k: jnp.asarray(v) for k, v in g.items()}, 0.01)
        tstate["t"] += 1
        toptim.adam_update(
            tp, tstate["m"], tstate["v"], [torch.from_numpy(g[k]) for k in params], 0.01, tstate["t"]
        )
        assert tstate["t"] == int(jstate.t)
        for i, k in enumerate(params):
            np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(tstate["m"][i].numpy(), np.asarray(jstate.m[k]), rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(tstate["v"][i].numpy(), np.asarray(jstate.v[k]), rtol=1e-6, atol=1e-12)
    # the bias-corrected step size is computed in float32, as in JAX
    for t in (1, 2, 7, 1000):
        tf_ = jnp.float32(t)
        want = float(0.01 * jnp.sqrt(1.0 - 0.999**tf_) / (1.0 - 0.9**tf_))
        np.testing.assert_allclose(toptim.adam_lr_t(0.01, t), want, rtol=1e-6)


# --------------------------------------------------------------------- engine


def test_adapt_full_step_matches_jax(jx):
    frame = _frames(10, 1)[0]
    jeng = jx.engine()
    new_p, new_o, res_j = jeng.adapt_full(_copy(jx.params), jeng.init_opt(jx.params), _jframe(frame))
    teng = jx.torch_engine()
    res_t = teng.adapt_full(frame)
    _assert_outputs_match(res_t, res_j)
    _assert_step_matches(jx, teng, new_p, new_o, trained=set(_flat(jx.params)))
    assert "block_loss" not in res_t
    assert all(p.requires_grad for p in teng.model.parameters())


@pytest.mark.parametrize("k", [0, 4])
def test_adapt_block_step_matches_jax(jx, k):
    frame = _frames(11, 1)[0]
    jeng = jx.engine()
    new_p, new_o, res_j = jeng.adapt_block(k)(
        _copy(jx.params), jeng.init_opt(jx.params), _jframe(frame)
    )
    teng = jx.torch_engine()
    res_t = teng.adapt_block(k, frame)
    _assert_outputs_match(res_t, res_j)
    np.testing.assert_allclose(float(res_t["block_loss"]), float(res_j["block_loss"]), rtol=1e-5)
    _assert_step_matches(jx, teng, new_p, new_o, trained=_block_keys(jx, [k]))
    # the returned loss is the full loss of the pre-step forward: what
    # infer gives on the untouched weights
    fresh = jx.torch_engine().infer(frame)
    assert float(res_t["loss"]) == float(fresh["loss"])
    assert torch.equal(res_t["disp"], fresh["disp"])
    assert not res_t["disp"].requires_grad
    assert all(p.requires_grad for p in teng.model.parameters())


def test_adapt_block_with_reprojection_scale_matches_jax(jx):
    frame = _frames(12, 1)[0]
    jeng = jx.engine(reprojection_scale=2)
    new_p, new_o, res_j = jeng.adapt_block(2)(
        _copy(jx.params), jeng.init_opt(jx.params), _jframe(frame)
    )
    teng = jx.torch_engine(reprojection_scale=2)
    res_t = teng.adapt_block(2, frame)
    _assert_outputs_match(res_t, res_j)
    np.testing.assert_allclose(float(res_t["block_loss"]), float(res_j["block_loss"]), rtol=1e-5)
    assert abs(float(res_t["block_loss"]) - float(res_t["loss"])) > 1e-4  # the scale bites
    _assert_step_matches(jx, teng, new_p, new_o, trained=_block_keys(jx, [2]))


def test_adapt_blocks_adam_matches_jax_and_shares_one_step_count(jx):
    """Two blocks in one step with Adam: both gradients at the pre-step
    parameters, both updates read the pre-step ``t``, which then advances
    by 2; a second step (one block, listed twice) advances it by 1."""
    frames = _frames(13, 2)
    jeng = jx.engine(optimizer="adam")
    p1, o1, res_j = jeng.adapt_blocks([1, 3])(
        _copy(jx.params), jeng.init_opt(jx.params), _jframe(frames[0])
    )
    teng = jx.torch_engine(optimizer="adam")
    teng.init_opt()
    res_t = teng.adapt_blocks([3, 1], frames[0])
    assert int(o1["t"]) == teng.opt["t"] == 2
    _assert_outputs_match(res_t, res_j)
    np.testing.assert_allclose(
        res_t["block_loss"].numpy(), np.asarray(res_j["block_loss"]), rtol=1e-5
    )
    # Adam's first step is lr * g / (|g| + eps'), the gradient's sign: the
    # moments carry the comparison of the gradients, and the step itself is
    # compared where the gradient stands clear of its float32 noise
    trained = _block_keys(jx, [1, 3])
    old, want, got = _flat(jx.params), _flat(p1), _flat(params_to_jax(teng.model.state_dict()))
    moments = {s_: (_flat(o1[s_]), _flat(params_to_jax(teng.opt[s_]))) for s_ in ("m", "v")}
    scales = {s_: max(np.abs(v).max() for v in w.values()) for s_, (w, _) in moments.items()}
    n_clear = 0
    for k in sorted(got):
        for s_, (want_s, got_s) in moments.items():
            tol = (1 if s_ == "m" else 2) * GRAD_TOL * scales[s_]
            np.testing.assert_allclose(got_s[k], want_s[k], rtol=0, atol=tol, err_msg=f"{s_} {k}")
        if k in trained:
            clear = np.abs(moments["m"][0][k]) > 0.01 * scales["m"]
            n_clear += int(clear.sum())
            np.testing.assert_allclose(
                (got[k] - old[k])[clear], (want[k] - old[k])[clear], rtol=0, atol=0.1 * LR, err_msg=k
            )
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2.01 * LR, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], old[k], err_msg=k)
            assert not moments["m"][1][k].any() and not moments["v"][1][k].any(), k
    assert n_clear > 1000

    p1_torch = {k: v.clone() for k, v in teng.model.state_dict().items()}
    p2, o2, res_j2 = jeng.adapt_blocks([1, 1])(p1, o1, _jframe(frames[1]))
    res_t2 = teng.adapt_blocks([1, 1], frames[1])
    assert int(o2["t"]) == teng.opt["t"] == 3
    assert res_t2["block_loss"].shape == (1,)
    _assert_outputs_match(res_t2, res_j2, rtol=1e-4)
    trained = {n for n in teng.blocks[1].names}
    for name, v in teng.model.state_dict().items():
        assert torch.equal(v, p1_torch[name]) == (name not in trained), name
    want, got = _flat(p2), _flat(params_to_jax(teng.model.state_dict()))
    for k in _block_keys(jx, [1]):
        # both took a step of about lr_t * m/sqrt(v); hold them to 1% of lr
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=0.01 * LR, err_msg=k)


# -------------------------------------------------------------------- session


def _run_both(jx, frames, **kw):
    jsess = JaxSession(jx.engine(), _copy(jx.params), **kw)
    jout = [jsess.step(_jframe(f)) for f in frames]
    tsess = TorchSession(jx.torch_engine(), **kw)
    tout = [tsess.step(f) for f in frames]
    return jsess, jout, tsess, tout


def _assert_trajectories_match(jsess, jout, tsess, tout, growth=1.0):
    """Per-frame loss to 1e-4 and EPE to 1e-3, both times ``growth`` for
    each frame after the second."""
    for i, (j, t) in enumerate(zip(jout, tout)):
        drift = growth ** max(0, i - 1)
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4 * drift, err_msg=f"frame {i}")
        np.testing.assert_allclose(t["epe"], j["epe"], rtol=1e-3 * drift, err_msg=f"frame {i}")
    assert tsess.stats.fetch_counter == jsess.stats.fetch_counter
    assert tsess.stats.reset_counter == jsess.stats.reset_counter
    assert tsess.stats.steps == jsess.stats.steps == len(jout)
    # a score is uf (0.01) times a difference of losses that agree to 1e-4
    np.testing.assert_allclose(tsess.scores, jsess.scores, rtol=1e-3, atol=1e-7)
    np.testing.assert_array_equal(tsess.stats.sample_distribution, tsess.scores)


def _assert_params_match(jsess, tsess, lr_steps, rel=1e-3):
    """Adapted weights against JAX's: each took ``lr_steps`` steps of lr
    times an accumulated gradient; hold them to ``rel`` of the largest move."""
    want = _flat(jsess.params)
    got = _flat(params_to_jax(tsess.engine.model.state_dict()))
    old = _flat(params_to_jax({k: v for k, v in tsess.params0.items()}))
    scale = max(np.abs(want[k] - old[k]).max() for k in want)
    assert scale > 0 and lr_steps > 0
    for k in want:
        ulp = np.spacing(np.abs(old[k]).max().astype(np.float32))
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=rel * scale + lr_steps * ulp, err_msg=k)


def test_mad_sequential_session_matches_jax_with_bulkhead(jx_bulkhead):
    """The main path: MADNet with the bulkhead, MAD, one block a frame in
    turn, as ``cli/adapt.py`` builds it."""
    frames = _frames(20, 5)
    kw = dict(mode="MAD", sample_mode="SEQUENTIAL", ssim_th=1e9, seed=0)
    jsess, jout, tsess, tout = _run_both(jx_bulkhead, frames, **kw)
    _assert_trajectories_match(jsess, jout, tsess, tout)
    assert tsess.stats.fetch_counter == [1, 1, 1, 1, 1]
    assert np.count_nonzero(tsess.scores) == 4  # the block trained last has no reward yet
    _assert_params_match(jsess, tsess, lr_steps=1)


def test_mad_sequential_session_matches_jax(jx):
    frames = _frames(21, 5)
    kw = dict(mode="MAD", sample_mode="SEQUENTIAL", ssim_th=1e9, seed=0)
    jsess, jout, tsess, tout = _run_both(jx, frames, **kw)
    _assert_trajectories_match(jsess, jout, tsess, tout)
    _assert_params_match(jsess, tsess, lr_steps=1)


def test_mad_fixed_session_matches_jax(jx):
    frames = _frames(22, 5)
    kw = dict(mode="MAD", sample_mode="FIXED", fixed_id=4, ssim_th=1e9, seed=0)
    jsess, jout, tsess, tout = _run_both(jx, frames, **kw)
    _assert_trajectories_match(jsess, jout, tsess, tout)
    assert tsess.stats.fetch_counter == [0, 0, 0, 0, 5]
    _assert_params_match(jsess, tsess, lr_steps=5)
    # only block 4 moved
    untouched = {n for b in tsess.engine.blocks[:4] for n in b.names}
    for name, v in tsess.engine.model.state_dict().items():
        assert torch.equal(v, tsess.params0[name]) == (name in untouched), name


def test_full_session_matches_jax(jx):
    frames = _frames(23, 5)
    jsess, jout, tsess, tout = _run_both(jx, frames, mode="FULL", ssim_th=1e9)
    # FULL moves every weight of this random-weight network on every frame,
    # and the two float32 runs drift apart about tenfold a frame (measured
    # over three seeds: 1e-7, 2e-6, 3e-6, 7e-5, 2e-4 of the loss), so the
    # first two frames carry the comparison and the rest the control flow
    for j, t in zip(jout[:2], tout[:2]):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
    _assert_trajectories_match(jsess, jout, tsess, tout, growth=10.0)
    assert tsess.n_actions == 1 and tsess.stats.fetch_counter == [0]
    # after that drift the last gradients differ by a few percent of the
    # largest; a lost momentum carry or a skipped step would be off by all of it
    _assert_params_match(jsess, tsess, lr_steps=5, rel=5e-2)


def test_session_dilation_and_sample_frequency_match_jax(jx):
    """Blocks are resampled every 2nd frame and trained every 2nd frame;
    the scores are updated on every frame."""
    frames = _frames(24, 5)
    kw = dict(
        mode="MAD", sample_mode="SEQUENTIAL", dilation=2, sample_frequency=2, ssim_th=1e9, seed=0
    )
    jsess, jout, tsess, tout = _run_both(jx, frames, **kw)
    _assert_trajectories_match(jsess, jout, tsess, tout)
    assert tsess.stats.fetch_counter == [1, 1, 1, 0, 0]
    _assert_params_match(jsess, tsess, lr_steps=1)


def test_reset_safeguard_matches_jax(jx):
    """A threshold below every loss resets after each frame: the weights
    go back to the pristine ones in place, the optimizer state stays."""
    frames = _frames(25, 3)
    kw = dict(mode="MAD", sample_mode="SEQUENTIAL", ssim_th=-1.0, seed=0)
    jsess, jout, tsess, tout = _run_both(jx, frames, **kw)
    _assert_trajectories_match(jsess, jout, tsess, tout)
    assert tsess.stats.reset_counter == 3
    live = dict(tsess.engine.model.named_parameters())
    for name, p0 in tsess.params0.items():
        assert torch.equal(live[name], p0)
        assert live[name].data_ptr() != p0.data_ptr()
    acc = tsess.engine.opt["acc"]
    assert any(bool(a.any()) for a in acc.values())
    want_acc = _flat(jsess.opt["acc"])
    got_acc = _flat(params_to_jax(acc))
    scale = max(np.abs(v).max() for v in want_acc.values())
    for k in want_acc:
        np.testing.assert_allclose(got_acc[k], want_acc[k], rtol=0, atol=GRAD_TOL * scale, err_msg=k)


def test_probability_sampling_follows_the_scores():
    """PROBABILITY sampling is compared by distribution, not step by step:
    the first pick follows softmax(scores) (chi-square against the exact
    law at alpha = 0.001, df = 3, critical value 16.27)."""
    scores = np.array([0.1, 1.2, -0.4, 0.6])
    probs = t_softmax(scores)
    for m in (1, 2):
        s = t_sampler("PROBABILITY", m, seed=7)
        first = [int(s.sample(probs)[0]) for _ in range(4000)]
        counts = np.bincount(first, minlength=4).astype(np.float64)
        expected = probs * counts.sum()
        assert float(((counts - expected) ** 2 / expected).sum()) < 16.27


def test_session_and_engine_refuse_what_they_cannot_run(jx):
    teng = jx.torch_engine()
    with pytest.raises(ValueError, match="unknown adaptation mode"):
        TorchSession(teng, mode="SOME")
    with pytest.raises(ValueError, match="blocks"):
        TorchSession(TorchEngine(teng.model, device="cpu"), mode="MAD")
    with pytest.raises(ValueError, match="unknown adaptation kind"):
        TorchEngine(teng.model, device="cpu", adaptation="supervised")
    with pytest.raises(ValueError, match="unknown optimizer"):
        TorchEngine(teng.model, device="cpu", optimizer="sgd")
    with pytest.raises(KeyError):
        TorchSession(teng, mode="MAD", sample_mode="NOPE")
