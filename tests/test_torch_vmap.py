"""The port's batched streams (``FusedOnlineSession(num_streams=N,
stream_impl="vmap")``) and the kernel Functions' ``vmap`` rules, on the
CPU.

Under ``vmap`` one function of a stream's arena row, sampled block and
frame runs over all the streams at once (``torch.func``): every
convolution with per-stream weights becomes one grouped convolution, and
every kernel Function folds the streams into its batch axis. Two streams
at 64x128 on smooth frames made with numpy from seeds
(``tests/test_torch_streams.py``).

* Against the JAX two-stream ``stream_impl="vmap"`` session, each stream on
  its own frames: MAD (SEQUENTIAL, the shared-forward step) and NONE over
  3 frames, each stream's loss and EPE within 2e-5 relative
  (``tests/test_adapt.py::test_multistream_session_matches_single``), the
  fetch counters equal. FULL over 2 frames: the first frame within 2e-5,
  the second within ``test_torch_fused.py``'s trajectory bound against
  JAX (loss 1e-4, EPE 1e-3): FULL steps every weight, and a grouped
  convolution rounds apart from a plain one by 1e-6, which the first
  step's gradient of the random-weight network carries to 2e-3 of its
  largest entry (measured on these frames).
* Against the port's single sessions, seeds ``[0, 0]`` on the same frames:
  MAD PROBABILITY (the two packages' generators differ, so PROBABILITY is
  held to the port's own shared-forward session) and NONE, 3 frames, loss
  and EPE within 2e-5, fetch counters equal, weights within the 1e-5 of
  two runs of one session; FULL, its first step's weights within 1e-2 of
  the step's largest entry.
* ``step_chunk`` with a ``[K, N]`` prefix against K steps.
* One graph key a branch (what the card captures), whatever the streams.
* The batching rules: each of the five kernel Functions, forward and
  backward, under ``vmap(grad(...))`` with the launchers replaced by the
  plain versions (in this test only): one "launch" a vmapped call, values
  and gradients equal to the unbatched calls'; an input without a stream
  axis is broadcast.
* The constructor's refusals, as the JAX session's.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch.adapt import FusedOnlineSession as TorchFused
from tests.test_torch_fused import _Setup
from tests.test_torch_streams import H, W, _frames, _stack

corr = importlib.import_module("real_time_self_adaptive_deep_stereo_torch.ops.correlation")
wk = importlib.import_module("real_time_self_adaptive_deep_stereo_torch.ops.warp_kernels")
warp = importlib.import_module("real_time_self_adaptive_deep_stereo_torch.ops.warp")

N = 2
STREAM_RTOL = 2e-5  # tests/test_adapt.py::test_multistream_session_matches_single
TRAJ = dict(loss=1e-4, epe=1e-3)  # tests/test_torch_fused.py::_assert_matches_jax, frame 1
RERUN = dict(rtol=1e-5, atol=1e-5)
FULL_STEP_RTOL = 1e-2  # of the first step's largest change
KW = dict(ssim_th=1e9)  # max_steps 8 and, for JAX, seed 0: _Setup
VMAP = dict(num_streams=N, stream_impl="vmap")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def su():
    return _Setup()


def _run(sess, frames):
    for f in frames:
        sess.step(f)
    return sess.finalize()


MODES = {
    "MAD": (dict(mode="MAD", sample_mode="SEQUENTIAL"), 3),
    "NONE": (dict(mode="NONE"), 3),
    "FULL": (dict(mode="FULL"), 2),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_vmap_streams_match_the_jax_vmap_session(su, mode):
    kw, n = MODES[mode]
    frames = _stack([_frames(90, n), _frames(91, n)])
    want = _run(su.jax_fused(**kw, **KW, **VMAP), [{k: jnp.asarray(v) for k, v in f.items()} for f in frames])
    sess = su.fused(**kw, **KW, **VMAP)
    got = _run(sess, frames)
    assert got["loss"].shape == (N, n) and got["steps"] == n
    for s in range(N):
        for k in ("loss", "epe"):
            if mode == "FULL":
                np.testing.assert_allclose(got[k][s, 0], want[k][s, 0], rtol=STREAM_RTOL, err_msg=k)
                np.testing.assert_allclose(got[k][s, 1], want[k][s, 1], rtol=TRAJ[k], err_msg=k)
            else:
                np.testing.assert_allclose(got[k][s], want[k][s], rtol=STREAM_RTOL, err_msg=f"{k} {s}")
        np.testing.assert_array_equal(got["fetch_counter"][s], np.asarray(want["fetch_counter"][s]))
    if mode == "MAD":
        assert sess.shared_forward  # forced by vmap
        assert got["fetch_counter"].tolist() == [[1, 1, 1, 0, 0]] * N
    if mode != "NONE":  # the streams saw different frames, so their weights went apart
        assert not torch.equal(sess.arena.flat[0], sess.arena.flat[1])


def test_vmap_mad_and_none_match_single_sessions(su):
    """Seeds [0, 0] on the same frames: both streams follow the session with
    seed 0 (MAD: its shared-forward step, which vmap runs)."""
    frames = _frames(92, 3)
    both = [{k: np.stack([v, v]) for k, v in f.items()} for f in frames]
    for kw in (dict(mode="MAD", sample_mode="PROBABILITY", **KW), dict(mode="NONE")):
        single = su.fused(seed=0, shared_forward=kw["mode"] == "MAD", **kw)
        want = _run(single, frames)
        sess = su.fused(seed=[0, 0], **kw, **VMAP)
        got = _run(sess, both)
        params = sess.current_params()
        for s in range(N):
            for k in ("loss", "epe"):
                np.testing.assert_allclose(got[k][s], want[k], rtol=STREAM_RTOL, err_msg=f"{kw['mode']} {k}")
            np.testing.assert_array_equal(got["fetch_counter"][s], want["fetch_counter"])
            np.testing.assert_allclose(got["scores"][s], want["scores"], rtol=1e-4, atol=1e-9)
            for name, w in single.current_params().items():
                torch.testing.assert_close(params[name][s], w, **RERUN, msg=name)
        if kw["mode"] == "MAD":
            assert int(np.asarray(want["fetch_counter"]).sum()) == 3


def test_vmap_full_first_step_matches_a_single_session(su):
    frames = _frames(93, 2)
    single = su.fused(mode="FULL", seed=0, **KW)
    flat0 = single.arena.flat.clone()
    want = _run(single, frames[:1])
    sess = su.fused(mode="FULL", seed=[0, 0], **KW, **VMAP)
    got = _run(sess, [{k: np.stack([v, v]) for k, v in f.items()} for f in frames[:1]])
    step = single.arena.flat - flat0
    for s in range(N):
        np.testing.assert_allclose(got["loss"][s], want["loss"], rtol=STREAM_RTOL)
        err = float((sess.arena.flat[s] - flat0 - step).abs().max())
        assert err <= FULL_STEP_RTOL * float(step.abs().max()), err
        torch.testing.assert_close(sess.opt["acc"][0][s], single.opt["acc"][0], rtol=0,
                                   atol=FULL_STEP_RTOL * float(single.opt["acc"][0].abs().max()))


def test_vmap_step_chunk_with_a_stream_prefix_equals_steps(su):
    frames = _stack([_frames(94, 3), _frames(95, 3)])
    kw = dict(mode="MAD", sample_mode="SEQUENTIAL", seed=0, **KW, **VMAP)
    seq = _run(su.fused(**kw), frames)
    chunked = su.fused(**kw)
    chunked.step_chunk({k: np.stack([f[k] for f in frames]) for k in frames[0]})
    assert tuple(chunked.last_disp.shape) == (3, N, 1, H, W, 1)
    got = chunked.finalize()
    for k in ("loss", "epe", "d1", "scores"):
        np.testing.assert_allclose(got[k], seq[k], rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(got["fetch_counter"], seq["fetch_counter"])


def test_vmap_dispatches_one_graph_key_a_branch(su):
    """The card captures one graph a key: under vmap a frame-batch is one
    key, its branch, whatever the streams sample (PROBABILITY, four
    streams), and with dilation 2 the frames between train steps take the
    forward-only branch."""
    n = 4
    frames = _stack([_frames(96 + s, 4) for s in range(n)])
    for kw, want in (
        (dict(mode="MAD", sample_mode="PROBABILITY"), [("shared",)] * 4),
        (dict(mode="MAD", sample_mode="SEQUENTIAL", dilation=2), [("shared",), ("none",)] * 2),
        (dict(mode="FULL"), [("full",)] * 4),
        (dict(mode="NONE", compute_metrics=False), [("none",)] * 4),
    ):
        sess = su.fused(seed=list(range(n)), num_streams=n, stream_impl="vmap", **kw, **KW)
        keys = []
        dispatch = sess._dispatch
        sess._dispatch = lambda key, run: keys.append(key) or dispatch(key, run)
        for f in frames:
            sess.step(f if kw.get("compute_metrics", True) else {k: f[k] for k in ("left", "right")})
        assert keys == want, (kw, keys)
        assert tuple(sess.last_disp.shape) == (n, 1, H, W, 1)


# ------------------------------------------------------------ batching rules
def _plain_launchers(monkeypatch):
    """The launchers of the five kernel Functions replaced by the plain
    versions, each call counted by the kernel's name."""
    calls = []

    def fwd(lib, fn, src, off, *b):
        calls.append(fn)
        tiled = "tile" in fn
        if "image" in fn:
            return (warp.warp_image_onehot(src, off, b[0], align=128) if tiled
                    else warp.warp_image_clamped(src, off, b[0]))
        return (warp.warp_features_onehot(src, off, *b, align=128) if tiled
                else warp.warp_features_clamped(src, off, *b))

    def bwd(lib, fn, src, off, g, need_src, need_off, *b):
        calls.append(fn)
        tiled = "tile" in fn
        if "image" in fn:
            ds, do = (warp.warp_image_onehot_bwd(src, off, g, b[0], align=128) if tiled
                      else warp.warp_image_clamped_bwd(src, off, g, b[0]))
        else:
            ds, do = (warp.warp_features_onehot_bwd(src, off, g, *b, align=128) if tiled
                      else warp.warp_features_clamped_bwd(src, off, g, *b))
        return (ds if need_src else None), (do if need_off else None)

    def corr_fwd(x, y, r, wide):
        calls.append("corr_fwd")
        return corr.correlation_torch(x, y, r)

    def corr_bwd(x, y, g, r, wide):
        calls.append("corr_bwd")
        return corr.correlation_torch_bwd(x, y, g, r)

    monkeypatch.setattr(wk, "_launch", fwd)
    monkeypatch.setattr(wk, "_launch_bwd", bwd)
    monkeypatch.setattr(corr, "_corr_fwd_launch", corr_fwd)
    monkeypatch.setattr(corr, "_corr_bwd_launch", corr_bwd)
    return calls


FUNCTIONS = {
    "correlation": (corr._CorrelationCUDA, (2, False), ["corr_fwd", "corr_bwd"], 8),
    "warp_image": (wk._WarpImageCUDA, (12,), ["warp_image_fwd", "warp_image_bwd"], 3),
    "warp_features": (wk._WarpFeaturesCUDA, (8, 4), ["warp_features_fwd", "warp_features_bwd"], 8),
    "warp_tile_image": (wk._WarpImageTile, (12,), ["warp_tile_image_fwd", "warp_tile_image_bwd"], 3),
    "warp_tile_features": (wk._WarpFeaturesTile, (8, 4), ["warp_tile_features_fwd", "warp_tile_features_bwd"], 8),
}


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_kernel_functions_batch_the_streams_into_one_launch(monkeypatch, name):
    fn, extra, kernels, c = FUNCTIONS[name]
    calls = _plain_launchers(monkeypatch)
    n, b, h, w = 3, 2, 5, 40
    r = np.random.default_rng(7)
    a = torch.from_numpy(r.standard_normal((n, b, c, h, w)).astype(np.float32))
    if name == "correlation":
        second = torch.from_numpy(r.standard_normal((n, b, c, h, w)).astype(np.float32))
    else:  # an offset; the image warp's disparity is positive
        second = torch.from_numpy(r.uniform(-6 if "features" in name else 0, 9, (n, b, 1, h, w)).astype(np.float32))
    weight = torch.from_numpy(r.standard_normal((n, b, 5 if name == "correlation" else c, h, w)).astype(np.float32))

    def loss(x, y, g):
        return (fn.apply(x, y, *extra) * g).sum()

    grads = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)))(a, second, weight)
    assert calls == kernels  # one forward and one backward launch for the n streams
    for s in range(n):
        x, y = a[s].clone().requires_grad_(), second[s].clone().requires_grad_()
        out = fn.apply(x, y, *extra)
        (out * weight[s]).sum().backward()
        torch.testing.assert_close(grads[0][s], x.grad, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(grads[1][s], y.grad, rtol=1e-6, atol=1e-5)
    # an input without a stream axis is broadcast to every stream, and the
    # stream axis may sit elsewhere
    calls.clear()
    got = torch.func.vmap(lambda x, y: fn.apply(x, y, *extra), in_dims=(1, None))(a.movedim(0, 1), second[0])
    assert calls == kernels[:1]
    for s in range(n):
        torch.testing.assert_close(got[s], fn.apply(a[s], second[0], *extra))


def test_vmap_sessions_refuse_what_the_jax_session_refuses(su):
    eng = su.engine()
    with pytest.raises(ValueError, match="requires num_blocks=1 \\+ momentum"):
        TorchFused(eng, mode="MAD", num_blocks=2, **VMAP)
    with pytest.raises(ValueError, match="requires num_blocks=1 \\+ momentum"):
        TorchFused(su.engine(optimizer="adam"), mode="MAD", **VMAP)
    sess = TorchFused(eng, mode="MAD", sample_mode="PROBABILITY", **VMAP)
    assert sess.shared_forward and sess.stream_impl == "vmap"
