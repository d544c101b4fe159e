"""The port's flat arena and fused device session on the CPU, against the
JAX package's ``FusedOnlineSession`` and against the port's own host
session (which ``tests/test_torch_adapt.py`` holds against JAX).

On the CPU the fused session runs its step function eagerly; on the card
the same function is captured into CUDA graphs (``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold a replay against the eager step there).

Frames are smooth stereo pairs made with numpy from a seed (white noise
makes trajectories chaotic). Tolerances, as in ``test_torch_adapt.py``:
against JAX, a trajectory's loss to 1e-4 and EPE to 1e-3 relative (times
ten a frame for FULL, whose float32 runs drift apart that fast), scores
to 1e-3 relative. Against the port's host session the fused session runs
the same ops in the same order, so losses, metrics and weights are held
to 1e-6 relative (the flat update may fuse differently from the
per-tensor one); the host session keeps its scores in float64, the fused
one in float32 on the device, as the JAX pair does: 1e-3 relative.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch.adapt import AdaptationEngine as TorchEngine
from real_time_self_adaptive_deep_stereo_torch.adapt import FusedOnlineSession as TorchFused
from real_time_self_adaptive_deep_stereo_torch.adapt import OnlineAdaptationSession as TorchHost
from real_time_self_adaptive_deep_stereo_torch.adapt import arena as tarena
from real_time_self_adaptive_deep_stereo_torch.adapt import blocks as tblocks
from real_time_self_adaptive_deep_stereo_torch.adapt import softmax as t_softmax
from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net as torch_net
from real_time_self_adaptive_deep_stereo_torch.utils import optim as toptim
from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import params_from_jax
from real_time_self_adaptive_deep_stereo_tpu.adapt import AdaptationEngine as JaxEngine
from real_time_self_adaptive_deep_stereo_tpu.adapt import blocks as jblocks
from real_time_self_adaptive_deep_stereo_tpu.adapt.arena import build_arena as jax_build_arena
from real_time_self_adaptive_deep_stereo_tpu.adapt.fused import FusedOnlineSession as JaxFused
from real_time_self_adaptive_deep_stereo_tpu.models import get_stereo_net as jax_net

H, W = 64, 64
BLOCK_CONFIG = "block_config/MadNet_full.json"
LR = 1e-4
SAME_OPS = dict(rtol=1e-6, atol=1e-9)
# two runs of the same session: the CPU's threaded conv backward sums in an
# order that varies from run to run, in the last digit of a weight, which
# later frames carry into the disparity
RERUN = dict(rtol=1e-5, atol=1e-5)


def _frames(seed, n):
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


class _Setup:
    """The JAX net, weights and blocks, built once per module, and fresh
    port engines on the CPU with the same weights."""

    def __init__(self):
        self.net = jax_net("MADNet", corr_mode="jnp")
        self.params = self.net.init(jax.random.PRNGKey(0))
        self.blocks = jblocks.make_blocks(
            jblocks.load_block_config(BLOCK_CONFIG), self.net.layer_to_path
        )
        self.state = params_from_jax(self.params)

    def jax_fused(self, optimizer="momentum", **kw):
        eng = JaxEngine(self.net, self.blocks, lr=LR, optimizer=optimizer)
        params = jax.tree_util.tree_map(lambda x: x.copy(), self.params)
        return JaxFused(eng, params, max_steps=8, seed=0, **kw)

    def engine(self, **kw):
        model = torch_net("MADNet", device="cpu")
        model.load_state_dict(self.state)
        blocks = tblocks.make_blocks(tblocks.load_block_config(BLOCK_CONFIG), model)
        return TorchEngine(model, blocks, lr=LR, device="cpu", **kw)

    def fused(self, optimizer="momentum", **kw):
        kw.setdefault("max_steps", 8)
        return TorchFused(self.engine(optimizer=optimizer), **kw)

    def host(self, optimizer="momentum", **kw):
        return TorchHost(self.engine(optimizer=optimizer), **kw)


@pytest.fixture(scope="module")
def su():
    return _Setup()


@pytest.fixture
def one_thread():
    """One intra-op thread for the test: the CPU's threaded conv backward
    then sums in one order in both sessions, which are compared at 1e-6."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(sess, frames):
    for f in frames:
        sess.step(f)
    return sess.finalize()


def _host_stats(sess, frames):
    out = [sess.step(f) for f in frames]
    return {
        "loss": np.array([o["loss"] for o in out]),
        "epe": np.array([o["epe"] for o in out]),
        "bad3": np.array([o["bad3"] for o in out]),
        "d1": np.array([o["d1"] for o in out]),
        "scores": sess.scores,
        "fetch_counter": np.array(sess.stats.fetch_counter),
        "reset_count": sess.stats.reset_counter,
        "steps": sess.stats.steps,
    }


def _weights(sess):
    return {k: v.detach().clone() for k, v in sess.engine.model.state_dict().items()}


def _assert_same_as_host(fused_sess, got, host_sess, want):
    for k in ("loss", "epe", "bad3", "d1"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **SAME_OPS)
    np.testing.assert_array_equal(got["fetch_counter"], want["fetch_counter"])
    assert int(got["reset_count"]) == want["reset_count"]
    assert got["steps"] == want["steps"]
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-3, atol=1e-7)
    a, b = _weights(fused_sess), _weights(host_sess)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=1e-9, msg=k)


def _assert_same_weights(a, b):
    """Two runs of the same steps: the CPU's threaded conv backward sums
    in an order that varies from run to run, in the last digit."""
    torch.testing.assert_close(a.arena.flat, b.arena.flat, rtol=1e-5, atol=1e-9)


def _assert_matches_jax(got, want, growth=1.0):
    assert got["steps"] == want["steps"]
    for i in range(want["steps"]):
        drift = growth ** max(0, i - 1)
        np.testing.assert_allclose(got["loss"][i], want["loss"][i], rtol=1e-4 * drift, err_msg=f"frame {i}")
        np.testing.assert_allclose(got["epe"][i], want["epe"][i], rtol=1e-3 * drift, err_msg=f"frame {i}")
    np.testing.assert_array_equal(got["fetch_counter"], np.asarray(want["fetch_counter"]))
    assert int(got["reset_count"]) == int(want["reset_count"])
    np.testing.assert_allclose(got["scores"], np.asarray(want["scores"]), rtol=1e-3, atol=1e-7)


# ---------------------------------------------------------------------- arena


def test_arena_layout_matches_jax_and_views_alias_the_module(su):
    eng = su.engine()
    named = dict(eng.model.named_parameters())
    before = {k: v.detach().clone() for k, v in named.items()}
    arena = tarena.build_arena(eng.model, eng.blocks)
    jspec = jax_build_arena(su.params, su.blocks)
    assert arena.block_ranges == jspec.block_ranges
    assert arena.size == jspec.size == sum(p.numel() for p in named.values())
    # the same tensors at the same offsets, in the same order
    rename = lambda path: ".".join(path[:-1]) + (".weight" if path[-1] == "w" else ".bias")  # noqa: E731
    assert [(n, off, size) for n, _, off, size in arena.entries] == [
        (rename(path), off, size) for path, _, off, size in jspec.entries
    ]
    for k, (s, e) in enumerate(arena.block_ranges):
        assert e - s == sum(p.numel() for p in eng.blocks[k].params)
        assert arena.block_slice(arena.flat, k).data_ptr() == arena.flat[s:].data_ptr()
    # the module's own parameters are views of the vector, values kept
    lo, hi = arena.flat.data_ptr(), arena.flat.data_ptr() + 4 * arena.size
    for name, shape, off, size in arena.entries:
        p = named[name]
        assert p is dict(eng.model.named_parameters())[name]
        assert lo <= p.data_ptr() < hi and p.data_ptr() == arena.flat[off:].data_ptr()
        assert p.grad.data_ptr() == arena.grad[off:].data_ptr() and tuple(p.shape) == shape
        assert torch.equal(p.detach(), before[name])
        assert torch.equal(arena.flat[off : off + size].view(shape), before[name])
    assert torch.equal(arena.flat, arena.flat0) and arena.flat0.data_ptr() != arena.flat.data_ptr()
    # a write to the vector is a write to the module, and the other way round
    s, e = arena.block_ranges[2]
    arena.flat[s:e] += 1.0
    for name in eng.blocks[2].names:
        assert torch.equal(named[name].detach(), before[name] + 1.0)
    with torch.no_grad():
        named["pyramid.conv1.bias"].zero_()
    _, shape, off, size = next(en for en in arena.entries if en[0] == "pyramid.conv1.bias")
    assert not arena.flat[off : off + size].any()
    # load_state_dict copies in place: the views survive
    eng.model.load_state_dict(su.state)
    assert torch.equal(arena.flat, arena.flat0)
    assert named["pyramid.conv1.bias"].data_ptr() == arena.flat[off:].data_ptr()
    host = arena.spec.unravel_host(arena.flat.numpy())
    assert set(host) == set(named)
    np.testing.assert_array_equal(host["context.context7.weight"], before["context.context7.weight"].numpy())
    assert arena.spec.block_ids().tolist().count(4) == arena.block_ranges[4][1] - arena.block_ranges[4][0]


def test_arena_rejects_overlapping_blocks(su):
    model = su.engine().model
    overlapping = [
        tblocks.Block(0, [("estimator_6",), ("pyramid", "conv12")], model),
        tblocks.Block(1, [("estimator_5",), ("pyramid", "conv12")], model),  # conv12 again
    ]
    with pytest.raises(ValueError, match="more than one MAD block"):
        tarena.build_arena(model, overlapping)
    # tensors of no block go last
    spec = tarena.ArenaSpec({n: p.shape for n, p in model.named_parameters()}, overlapping[:1])
    assert spec.block_ranges == [(0, sum(p.numel() for p in overlapping[0].params))]
    assert spec.size == sum(p.numel() for p in model.parameters())
    assert (spec.block_ids() == -1).sum() == spec.size - spec.block_ranges[0][1]


def test_adam_step_size_from_a_device_count_matches_the_host_one():
    """``t`` as a tensor: the step size is a float32 tensor equal to the
    Python-int path's, and an update with it equals an update with the int."""
    for t in (1, 2, 7, 1000):
        lr_t = toptim.adam_lr_t(0.01, torch.tensor(t, dtype=torch.int32))
        assert isinstance(lr_t, torch.Tensor) and lr_t.dtype == torch.float32 and lr_t.dim() == 0
        np.testing.assert_allclose(float(lr_t), toptim.adam_lr_t(0.01, t), rtol=1e-6)
    r = np.random.default_rng(0)
    p0, g = (torch.from_numpy(r.normal(size=(7,)).astype(np.float32)) for _ in range(2))
    runs = []
    for t in (3, torch.tensor(3, dtype=torch.int32)):
        p, m, v = p0.clone(), torch.full_like(p0, 0.1), torch.full_like(p0, 0.2)
        toptim.adam_update([p], [m], [v], [g], 0.01, t)
        runs.append((p, m, v))
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


# -------------------------------------------------- against the JAX fused session


@pytest.mark.parametrize("shared_forward", [False, True])
def test_fused_mad_sequential_matches_jax_fused(su, shared_forward):
    frames = _frames(30, 6)
    kw = dict(mode="MAD", sample_mode="SEQUENTIAL", ssim_th=1e9, shared_forward=shared_forward)
    want = _run(su.jax_fused(**kw), [{k: jnp.asarray(v) for k, v in f.items()} for f in frames])
    sess = su.fused(**kw)
    got = _run(sess, frames)
    _assert_matches_jax(got, want)
    assert got["fetch_counter"].tolist() == [2, 1, 1, 1, 1]
    assert np.count_nonzero(got["scores"]) == 5
    np.testing.assert_allclose(got["bad3"], want["bad3"], atol=1.01 / (H * W))
    np.testing.assert_allclose(got["d1"], want["d1"], atol=101.0 / (H * W))


def test_fused_full_with_dilation_matches_jax_fused(su):
    frames = _frames(31, 5)
    kw = dict(mode="FULL", dilation=2, ssim_th=1e9)
    want = _run(su.jax_fused(**kw), [{k: jnp.asarray(v) for k, v in f.items()} for f in frames])
    sess = su.fused(**kw)
    got = _run(sess, frames)
    _assert_matches_jax(got, want, growth=10.0)
    np.testing.assert_allclose(got["loss"][:2], want["loss"][:2], rtol=1e-5)
    assert got["fetch_counter"].tolist() == [0] and got["scores"].tolist() == [0.0]
    # frames 0, 2 and 4 trained
    assert float((sess.arena.flat - sess.arena.flat0).abs().max()) > 0
    assert "t" not in sess.opt and bool(sess.opt["acc"][0].any())


def test_fused_mad_adam_matches_jax_fused_and_counts_on_the_device(su):
    """Adam over four steps: the step count lives on the device and
    advances once a step, so the bias correction follows it (a count
    frozen at 1 would take steps three times too large by the fourth)."""
    frames = _frames(32, 4)
    kw = dict(mode="MAD", sample_mode="FIXED", fixed_id=3, ssim_th=1e9)
    jsess = su.jax_fused(optimizer="adam", **kw)
    want = _run(jsess, [{k: jnp.asarray(v) for k, v in f.items()} for f in frames])
    sess = su.fused(optimizer="adam", **kw)
    got = _run(sess, frames)
    # Adam's first steps are lr * sign(g): where a gradient is float32
    # noise the two packages step apart by up to 2*lr, which the loss of
    # the later frames sees
    np.testing.assert_allclose(got["loss"][:1], want["loss"][:1], rtol=1e-5)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-3)
    np.testing.assert_allclose(got["epe"], want["epe"], rtol=5e-3)
    assert got["fetch_counter"].tolist() == [0, 0, 0, 4, 0]
    t = sess.opt["t"]
    assert isinstance(t, torch.Tensor) and t.dtype == torch.int32 and int(t) == 4
    assert int(jsess.state["opt"]["t"]) == 4
    # the moved weights against JAX's: both took four steps of about lr
    jflat = np.asarray(jsess.state["params"])
    s, e = sess.arena.block_ranges[3]
    moved_j = np.abs(jflat[s:e] - np.asarray(jsess._params0)[s:e])
    moved_t = (sess.arena.flat[s:e] - sess.arena.flat0[s:e]).abs().numpy()
    assert 2.0 * LR < moved_t.max() <= 4.01 * LR
    np.testing.assert_allclose(np.sort(moved_t)[-1000:].mean(), np.sort(moved_j)[-1000:].mean(), rtol=0.05)
    assert not (sess.arena.flat[:s] != sess.arena.flat0[:s]).any()
    assert not (sess.arena.flat[e:] != sess.arena.flat0[e:]).any()


# --------------------------------------------- against the port's host session


@pytest.mark.parametrize("arena", [True, False])
def test_fused_two_blocks_a_frame_match_the_host_session(su, arena, one_thread):
    frames = _frames(33, 4)
    kw = dict(mode="MAD", sample_mode="SEQUENTIAL", num_blocks=2, ssim_th=1e9)
    host = su.host(optimizer="adam", seed=0, **kw)
    want = _host_stats(host, frames)
    sess = su.fused(optimizer="adam", arena=arena, **kw)
    got = _run(sess, frames)
    _assert_same_as_host(sess, got, host, want)
    assert got["fetch_counter"].tolist() == [1, 2, 2, 2, 1]
    assert int(sess.opt["t"]) == host.engine.opt["t"] == 8  # once per block trained
    assert (sess.spec is not None) == arena


def test_fused_fixed_id_list_matches_the_host_session(su):
    frames = _frames(34, 3)
    kw = dict(mode="MAD", sample_mode="FIXED", num_blocks=2, fixed_id=[3, 1], ssim_th=1e9)
    host = su.host(seed=0, **kw)
    want = _host_stats(host, frames)
    sess = su.fused(**kw)
    got = _run(sess, frames)
    _assert_same_as_host(sess, got, host, want)
    assert got["fetch_counter"].tolist() == [0, 3, 0, 3, 0]
    # exactly the two blocks' ranges moved
    moved = (sess.arena.flat != sess.arena.flat0).nonzero().flatten()
    ranges = [sess.arena.block_ranges[k] for k in (1, 3)]
    assert all(any(s <= int(i) < e for s, e in ranges) for i in (moved.min(), moved.max()))
    for k in (0, 2, 4):
        s, e = sess.arena.block_ranges[k]
        assert torch.equal(sess.arena.flat[s:e], sess.arena.flat0[s:e])
    with pytest.raises(ValueError, match="len\\(fixed_id\\) == num_blocks"):
        su.fused(mode="MAD", sample_mode="FIXED", fixed_id=[1, 2], num_blocks=1)


@pytest.mark.parametrize("arena", [True, False])
def test_fused_dilation_sample_frequency_and_reset_match_the_host_session(su, arena):
    """Blocks resampled and trained every 2nd frame, scores updated on
    every frame, and a threshold below every loss: the reset restores the
    pristine weights on the device after each frame, the optimizer state
    stays."""
    frames = _frames(35, 5)
    kw = dict(mode="MAD", sample_mode="SEQUENTIAL", dilation=2, sample_frequency=2, ssim_th=-1.0)
    host = su.host(seed=0, **kw)
    want = _host_stats(host, frames)
    sess = su.fused(arena=arena, **kw)
    got = _run(sess, frames)
    _assert_same_as_host(sess, got, host, want)
    assert got["fetch_counter"].tolist() == [1, 1, 1, 0, 0] and int(got["reset_count"]) == 5
    for p, p0 in zip(sess._params, sess._params0):
        assert torch.equal(p, p0) and p.data_ptr() != p0.data_ptr()
    assert any(bool(a.any()) for a in sess.opt["acc"])
    # without the reset the same steps move the weights
    free = su.fused(arena=arena, **{**kw, "ssim_th": 1e9})
    _run(free, frames)
    assert any(not torch.equal(p, p0) for p, p0 in zip(free._params, free._params0))


def test_fused_step_trains_exactly_the_sampled_blocks_range(su):
    sess = su.fused(mode="MAD", sample_mode="SEQUENTIAL", ssim_th=1e9)
    for i, f in enumerate(_frames(36, 5)):
        before = sess.arena.flat.clone()
        sess.step(f)
        moved = (sess.arena.flat != before).nonzero().flatten()
        s, e = sess.arena.block_ranges[i]
        assert moved.numel() > 0 and s <= int(moved.min()) and int(moved.max()) < e, i
        # the gradient landed in the block's slice of the flat gradient vector
        assert bool(sess.arena.grad[s:e].any())
    assert all(p.requires_grad for p in sess.engine.model.parameters())


@pytest.mark.parametrize("mode", ["MAD", "NONE"])
def test_fused_without_metrics_needs_no_target_and_keeps_the_trajectory(su, mode):
    frames = _frames(37, 3)
    kw = dict(mode=mode, sample_mode="SEQUENTIAL", ssim_th=1e9)
    ref = su.fused(**kw)
    _run(ref, frames)
    bare = su.fused(compute_metrics=False, **kw)
    got = _run(bare, [{k: v for k, v in f.items() if k != "target"} for f in frames])
    assert bare.metrics is None and "loss" not in got and got["steps"] == 3
    torch.testing.assert_close(bare.last_disp, ref.last_disp, **RERUN)
    _assert_same_weights(bare, ref)
    if mode == "MAD":
        np.testing.assert_allclose(got["scores"], ref.finalize()["scores"], rtol=1e-4, atol=1e-9)
        assert float(bare.loss_t1) > 0  # the controller keeps the loss
    else:
        assert float(bare.loss_t1) == 0.0 and not bare.opt


def test_step_chunk_equals_sequential_steps(su):
    frames = _frames(38, 4)
    kw = dict(mode="MAD", sample_mode="SEQUENTIAL", ssim_th=1e9)
    seq = su.fused(**kw)
    disps = []
    for f in frames:
        seq.step(f)
        disps.append(seq.last_disp.clone())
    chunked = su.fused(**kw)
    chunked.step_chunk({k: np.stack([f[k] for f in frames]) for k in frames[0]}, unroll=2)
    assert tuple(chunked.last_disp.shape) == (4, 1, H, W, 1)
    torch.testing.assert_close(chunked.last_disp, torch.stack(disps), **RERUN)
    a, b = seq.finalize(), chunked.finalize()
    for k in ("loss", "epe", "bad3", "d1"):
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **RERUN)
    np.testing.assert_allclose(a["scores"], b["scores"], rtol=1e-4, atol=1e-9)
    np.testing.assert_array_equal(a["fetch_counter"], b["fetch_counter"])
    _assert_same_weights(seq, chunked)
    assert b["steps"] == 4


def test_serve_and_step_pipelined_equal_blocking_steps_one_frame_stale(su):
    frames = _frames(39, 4)
    kw = dict(mode="MAD", sample_mode="SEQUENTIAL", ssim_th=1e9)
    ref = su.fused(**kw)
    want = []
    for f in frames:
        ref.step(f)
        want.append(ref.fetch_disp()())
    assert want[0].shape == (1, H, W, 1) and not np.array_equal(want[0], want[1])
    served = list(su.fused(**kw).serve(iter(frames)))
    assert len(served) == 4
    for a, b in zip(served, want):
        np.testing.assert_allclose(a, b, **RERUN)
    piped = su.fused(**kw)
    out = [piped.step_pipelined(f) for f in frames]
    assert out[0] is None
    for a, b in zip(out[1:], want[:-1]):  # frame i's call returns frame i-1's disparity
        np.testing.assert_allclose(a, b, **RERUN)
    np.testing.assert_allclose(piped.flush_disp(), want[-1], **RERUN)
    assert piped.flush_disp() is None
    np.testing.assert_allclose(piped.finalize()["loss"], ref.finalize()["loss"], **RERUN)
    with pytest.raises(RuntimeError, match="before the first step"):
        su.fused(**kw).fetch_disp()


def test_disp_dtype_casts_the_returned_disparity_only(su):
    frames = _frames(40, 2)
    kw = dict(mode="MAD", sample_mode="SEQUENTIAL", ssim_th=1e9)
    ref, half = su.fused(**kw), su.fused(disp_dtype=torch.float16, **kw)
    a, b = _run(ref, frames), _run(half, frames)
    assert half.last_disp.dtype == torch.float16 and ref.last_disp.dtype == torch.float32
    assert half.fetch_disp()().dtype == np.float16
    torch.testing.assert_close(half.last_disp.float(), ref.last_disp, rtol=1e-3, atol=0.05)
    for k in ("loss", "epe"):  # state and metrics stay float32
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **RERUN)
    _assert_same_weights(ref, half)


@pytest.mark.parametrize("arena", [True, False])
def test_snapshot_params_is_stable_across_later_steps(su, arena):
    frames = _frames(41, 3)
    sess = su.fused(mode="MAD", sample_mode="FIXED", fixed_id=4, ssim_th=1e9, arena=arena)
    sess.step(frames[0])
    want = {k: v.detach().clone().numpy() for k, v in sess.current_params().items()}
    get = sess.snapshot_params()
    for f in frames[1:]:  # the live weights move on, in place
        sess.step(f)
    snap = get()
    assert set(snap) == set(want)
    for k in want:
        np.testing.assert_array_equal(snap[k], want[k], err_msg=k)
        assert snap[k].shape == want[k].shape
    live = sess.current_params()
    assert any(not np.array_equal(live[k].detach().numpy(), want[k]) for k in want)
    # current_params are the module's own tensors
    assert live["context.context7.weight"].data_ptr() == (
        sess.engine.model.context["context7"].weight.data_ptr()
    )
    sess.block_until_ready()


def test_device_samplers_follow_their_laws():
    """``_sample`` by distribution, as the JAX package tests its own:
    chi-square of the first pick against the exact law at alpha = 0.001
    (df = 3, critical value 16.27): PROBABILITY ~ softmax(scores), RANDOM
    uniform, for one and for two blocks (Gumbel top-k draws in
    Plackett-Luce order); and the deterministic samplers."""
    n, draws, crit = 4, 4000, 16.27
    scores = torch.tensor([0.1, 1.2, -0.4, 0.6])
    probs = t_softmax(scores.numpy().astype(np.float64))

    def first_picks(mode, m, seed):
        stub = SimpleNamespace(n_actions=n, num_blocks=m, sample_mode=mode, fixed_id=0, sample_frequency=1)
        gen = torch.Generator().manual_seed(seed)
        ids = [TorchFused._sample(stub, scores, gen, 0) for _ in range(draws)]
        assert ids[0].dtype == torch.int32 and tuple(ids[0].shape) == (m,)
        assert all(len(set(i.tolist())) == m for i in ids[:50])  # without replacement
        return np.bincount([int(i[0]) for i in ids], minlength=n).astype(np.float64)

    def chi2(counts, p):
        exp = p * counts.sum()
        return float(((counts - exp) ** 2 / exp).sum())

    for m in (1, 2):
        assert chi2(first_picks("PROBABILITY", m, 7), probs) < crit
        assert chi2(first_picks("RANDOM", m, 11), np.full(n, 1.0 / n)) < crit
    stub = SimpleNamespace(n_actions=n, num_blocks=2, sample_mode="ARGMAX", fixed_id=[2, 0], sample_frequency=2)
    assert TorchFused._sample(stub, scores, None, 0).tolist() == [1, 3]
    stub.sample_mode = "SEQUENTIAL"
    assert [TorchFused._sample(stub, scores, None, s).tolist() for s in (0, 1, 2, 7)] == [
        [0, 1], [0, 1], [1, 2], [3, 0]
    ]
    stub.sample_mode = "FIXED"
    assert TorchFused._sample(stub, scores, None, 5).tolist() == [2, 0]


def test_fused_probability_session_reads_its_blocks_and_counts_them(su):
    """PROBABILITY: the session draws on the device with its own seeded
    generator and reads the ids back; with ``shared_forward`` it does not
    need them. Same seed, same draws."""
    frames = _frames(42, 4)
    kw = dict(mode="MAD", sample_mode="PROBABILITY", ssim_th=1e9, seed=5)
    runs = []
    for shared in (False, True, False):
        sess = su.fused(shared_forward=shared, **kw)
        picked = []
        for f in frames:
            sess.step(f)
            picked.append(int(sess.cur_blocks[0]))
        stats = sess.finalize()
        assert stats["fetch_counter"].tolist() == [picked.count(k) for k in range(5)]
        assert np.isfinite(stats["loss"]).all()
        runs.append((picked, stats["loss"]))
    assert runs[0][0] == runs[1][0] == runs[2][0]
    np.testing.assert_allclose(runs[0][1], runs[2][1], **RERUN)
    np.testing.assert_allclose(runs[0][1], runs[1][1], rtol=1e-5)


class NoShardingStub(torch.nn.Module):
    """A model that does not say it runs on a rank's columns (no
    ``width_sharding``), as a model with an op of no sharded form would."""

    name = "Stub"

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))


def test_fused_session_refuses_what_it_cannot_run(su):
    eng = su.engine()
    # width sharding (a mesh without streams) runs a model with
    # width_sharding (MADNet, DispNet), with either loss, and refuses one
    # without it
    one_rank = SimpleNamespace(get_group=lambda axis: SimpleNamespace(size=lambda: 1, rank=lambda: 0))
    with pytest.raises(NotImplementedError, match="Stub has no width-sharded form"):
        TorchFused(TorchEngine(NoShardingStub(), device="cpu"), mode="NONE", mesh=one_rank)
    assert TorchFused(su.engine(adaptation="proxy"), mesh=one_rank)._sharded
    # without streams stream_impl is kept and unused, as in the JAX session
    assert TorchFused(eng, mode="NONE", stream_impl="vmap").stream_impl == "vmap"
    with pytest.raises(ValueError, match="unknown mode"):
        TorchFused(eng, mode="SOME")
    with pytest.raises(ValueError, match="blocks"):
        TorchFused(TorchEngine(eng.model, device="cpu"), mode="MAD")
    with pytest.raises(KeyError):
        TorchFused(eng, mode="MAD", sample_mode="NOPE")
    with pytest.raises(ValueError, match="shared_forward requires"):
        TorchFused(eng, mode="FULL", shared_forward=True)
    with pytest.raises(ValueError, match="shared_forward requires"):
        TorchFused(eng, mode="MAD", num_blocks=2, shared_forward=True)
    with pytest.raises(ValueError, match="shared_forward requires"):
        TorchFused(su.engine(optimizer="adam"), mode="MAD", shared_forward=True)
    with pytest.raises(ValueError, match="CUDA device"):
        TorchFused(eng, mode="NONE", use_graphs=True)
    sess = TorchFused(eng, su.state, mode="NONE", max_steps=2)  # weights as an argument
    assert not sess.use_graphs and sess.n_actions == 1
    # the ring's last row takes the frames beyond max_steps
    stats = _run(sess, _frames(43, 3))
    assert stats["steps"] == 3 and stats["loss"].shape == (2,)


def test_sessions_of_a_thread_share_one_side_stream(monkeypatch):
    """Every session of a thread on a device captures on one side stream
    (cuBLAS keeps a workspace for each stream it meets, for the life of the
    process); another thread or device gets a stream of its own. The
    stream is a stand-in: this checks the choice, not CUDA."""
    import threading

    from real_time_self_adaptive_deep_stereo_torch.adapt import fused as tfused

    made = []
    monkeypatch.setattr(tfused, "_SIDE_STREAMS", {})
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: made.append(device) or object())
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    first = tfused._side_stream(cuda0)
    assert tfused._side_stream(cuda0) is first
    assert tfused._side_stream(cuda1) is not first
    other = []
    t = threading.Thread(target=lambda: other.append(tfused._side_stream(cuda0)))
    t.start()
    t.join()
    assert other[0] is not first and tfused._side_stream(cuda0) is first
    assert made == [cuda0, cuda1, cuda0]
