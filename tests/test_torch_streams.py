"""The port's multi-stream fused session (``num_streams``, ``stream_impl``
"map" and "unroll") on the CPU, against the JAX package's multi-stream
session and against the port's own single-stream session.

Two streams at 64x128 on smooth stereo pairs made with numpy from seeds.
Against the JAX ``num_streams=2`` session (SEQUENTIAL, each stream its own
frames): each stream's loss and EPE within 2e-5 relative, as
``tests/test_adapt.py`` holds the JAX multi-stream session to its
single-stream one, and the fetch counters equal. Against the port's
single-stream session, which runs the same ops: PROBABILITY with seeds
``[0, 0]`` on the same frames (the two packages' generators differ, so
PROBABILITY is held to the port's own session), each stream equal to the
session with seed 0 within 2e-5, its weights within the 1e-5 of two runs
of one session on the CPU (``tests/test_torch_fused.py``, ``RERUN``).
On the CPU every step runs eagerly; ``chip_smoke.py`` phase 12 holds the
graphs of both stream modes on the card to the same sessions.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch.adapt import FusedOnlineSession as TorchFused
from tests.test_torch_fused import _Setup

H, W = 64, 128
N = 2
STREAM_RTOL = 2e-5  # tests/test_adapt.py::test_multistream_session_matches_single
RERUN = dict(rtol=1e-5, atol=1e-5)
KW = dict(mode="MAD", ssim_th=1e9)  # max_steps 8 and, for JAX, seed 0: _Setup
IMPLS = ["map", "unroll"]


def _frames(seed, n):
    """Smooth stereo pairs, right = left shifted by 3 + i px, ground truth
    that disparity with the first columns invalid."""
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
        out.append({"left": base[None, :, :W].copy(), "right": base[None, :, d : W + d].copy(), "target": target})
    return out


def _stack(per_stream):
    """Frame i of every stream, on a leading stream axis."""
    return [{k: np.stack([s[i][k] for s in per_stream]) for k in per_stream[0][i]} for i in range(len(per_stream[0]))]


def _run(sess, frames):
    for f in frames:
        sess.step(f)
    return sess.finalize()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: reruns of one session then sum in one order
    (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def su():
    return _Setup()


@pytest.fixture(scope="module")
def jax_streams(su):
    """The JAX two-stream session (SEQUENTIAL), each stream on its own frames."""
    per_stream = [_frames(70, 4), _frames(71, 4)]
    frames = _stack(per_stream)
    sess = su.jax_fused(sample_mode="SEQUENTIAL", num_streams=N, stream_impl="map", **KW)
    want = _run(sess, [{k: jnp.asarray(v) for k, v in f.items()} for f in frames])
    return frames, want


@pytest.mark.parametrize("impl", IMPLS)
def test_streams_match_the_jax_multistream_session(su, jax_streams, impl):
    frames, want = jax_streams
    sess = su.fused(sample_mode="SEQUENTIAL", seed=0, num_streams=N, stream_impl=impl, **KW)
    got = _run(sess, frames)
    assert got["loss"].shape == (N, 4) and got["steps"] == 4
    for s in range(N):
        np.testing.assert_allclose(got["loss"][s], want["loss"][s], rtol=STREAM_RTOL, err_msg=f"stream {s}")
        np.testing.assert_allclose(got["epe"][s], want["epe"][s], rtol=STREAM_RTOL, err_msg=f"stream {s}")
        np.testing.assert_array_equal(got["fetch_counter"][s], np.asarray(want["fetch_counter"][s]))
    assert got["fetch_counter"].tolist() == [[1, 1, 1, 1, 0]] * N
    # the streams saw different frames, so their weights went apart
    assert not torch.equal(sess.arena.flat[0], sess.arena.flat[1])


@pytest.mark.parametrize("impl", IMPLS)
def test_streams_match_single_stream_sessions_with_probability(su, impl):
    """Seeds [0, 0] on the same frames: both streams follow the session
    with seed 0; an int seed 5 gives stream 1 the seed 6."""
    frames = _frames(72, 5)
    single = {seed: su.fused(sample_mode="PROBABILITY", seed=seed, **KW) for seed in (0, 6)}
    ref = {seed: _run(sess, frames) for seed, sess in single.items()}
    assert ref[0]["fetch_counter"].tolist() != ref[6]["fetch_counter"].tolist()
    both = [{k: np.stack([v, v]) for k, v in f.items()} for f in frames]
    for seed, want_seeds in (([0, 0], (0, 0)), (5, (None, 6))):
        sess = su.fused(sample_mode="PROBABILITY", seed=seed, num_streams=N, stream_impl=impl, **KW)
        got = _run(sess, both)
        params = sess.current_params()
        for s, ws in enumerate(want_seeds):
            if ws is None:
                continue
            want = ref[ws]
            np.testing.assert_allclose(got["loss"][s], want["loss"], rtol=STREAM_RTOL)
            np.testing.assert_allclose(got["epe"][s], want["epe"], rtol=STREAM_RTOL)
            np.testing.assert_array_equal(got["fetch_counter"][s], want["fetch_counter"])
            np.testing.assert_allclose(got["scores"][s], want["scores"], rtol=1e-4, atol=1e-9)
            for name, w in single[ws].current_params().items():
                torch.testing.assert_close(params[name][s], w, **RERUN, msg=name)


@pytest.mark.parametrize("impl", IMPLS)
def test_step_chunk_with_a_stream_prefix_equals_steps(su, impl):
    """A [K, N] prefix: K steps of every stream from one call
    (tests/test_adapt.py::test_step_chunk_matches_sequential_steps_multistream)."""
    frames = _stack([_frames(73, 3), _frames(74, 3)])
    kw = dict(sample_mode="SEQUENTIAL", seed=0, num_streams=N, stream_impl=impl, **KW)
    seq = _run(su.fused(**kw), frames)
    chunked = su.fused(**kw)
    chunked.step_chunk({k: np.stack([f[k] for f in frames]) for k in frames[0]})
    assert tuple(chunked.last_disp.shape) == (3, N, 1, H, W, 1)
    got = chunked.finalize()
    for k in ("loss", "epe", "d1", "scores"):
        np.testing.assert_allclose(got[k], seq[k], rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(got["fetch_counter"], seq["fetch_counter"])


@pytest.mark.parametrize("impl", IMPLS)
def test_graph_keys_stay_bounded_with_sampled_branches(su, impl):
    """The graphs a session would capture on the card, by the keys its
    frames dispatch: "map" one per (stream, branch); "unroll" one per
    branch all N streams take together (every SEQUENTIAL frame) and map's
    where the streams' branches differ (PROBABILITY), so a branch has at
    most N + 1 graphs, never one per tuple of the N streams' branches."""
    n = 4
    frames = _stack([_frames(78 + s, 6) for s in range(n)])
    n_blocks = len(su.engine().blocks)
    for sample_mode in ("SEQUENTIAL", "PROBABILITY"):
        sess = su.fused(sample_mode=sample_mode, seed=list(range(n)), num_streams=n, stream_impl=impl, **KW)
        by_frame = []
        dispatch = sess._dispatch

        def recording(key, run):
            by_frame[-1].append(key)
            return dispatch(key, run)

        sess._dispatch = recording
        picked = []
        for f in frames:
            by_frame.append([])
            sess.step(f)
            picked.append([st.host_blocks for st in sess._streams])
        for keys, blocks in zip(by_frame, picked):
            branches = [("mad", b) for b in blocks]
            if impl == "unroll" and len(set(blocks)) == 1:
                assert keys == [tuple(branches)]
            else:
                assert keys == [(s, b) for s, b in enumerate(branches)]
        distinct = {k for keys in by_frame for k in keys}
        assert len(distinct) <= (n + 1) * n_blocks
        if sample_mode == "SEQUENTIAL":
            assert all(len(set(b)) == 1 for b in picked)
        else:  # the streams' sampled blocks differ on some frames
            assert any(len(set(b)) > 1 for b in picked)


def test_streams_carry_the_stream_axis_everywhere(su):
    """finalize, current_params, snapshot_params, last_disp, fetch_disp,
    serve and step_pipelined, with a leading [N]; the module shows stream 0
    between steps; each stream's disparity is its own."""
    per_stream = [_frames(75, 3), _frames(76, 3)]
    frames = _stack(per_stream)
    sess = su.fused(sample_mode="SEQUENTIAL", seed=0, num_streams=N, **KW)
    assert sess.stream_impl == "map"  # "auto"
    sess.step(frames[0])
    snap = sess.snapshot_params()
    at_snap = {k: v.clone() for k, v in sess.current_params().items()}
    first = sess.fetch_disp()
    for f in frames[1:]:
        sess.step(f)
    sess.block_until_ready()
    stats = sess.finalize()
    n_blocks = len(sess.engine.blocks)
    assert stats["steps"] == 3
    for k in ("epe", "bad3", "d1", "loss"):
        assert stats[k].shape == (N, 3) and np.isfinite(stats[k]).all()
    assert stats["scores"].shape == stats["fetch_counter"].shape == (N, n_blocks)
    assert stats["reset_count"].shape == (N,)
    assert sess.arena.flat.shape == (N, sess.arena.size)
    params = sess.current_params()
    named = dict(sess.engine.model.named_parameters())
    assert list(params) == list(named)
    for name, p in params.items():
        assert tuple(p.shape) == (N, *named[name].shape)
        assert named[name].data_ptr() == p[0].data_ptr()  # the module shows stream 0
    host = snap()
    assert set(host) == set(params)
    for name, v in host.items():
        np.testing.assert_array_equal(v, at_snap[name].numpy())
    assert first().shape == (N, 1, H, W, 1)
    served = su.fused(mode="NONE", num_streams=N, compute_metrics=False)
    outs = list(served.serve({k: f[k] for k in ("left", "right")} for f in frames))
    assert len(outs) == 3 and all(o.shape == (N, 1, H, W, 1) for o in outs)
    # a stream's disparity is its own frame's
    single = su.fused(mode="NONE", compute_metrics=False)
    for s in range(N):
        single.step({k: per_stream[s][2][k] for k in ("left", "right")})
        np.testing.assert_allclose(outs[2][s], single.last_disp.numpy(), rtol=1e-5, atol=1e-5)
    assert served.step_pipelined({k: frames[0][k] for k in ("left", "right")}) is None
    np.testing.assert_allclose(served.flush_disp(), outs[0], rtol=1e-6)


def test_streams_refuse_what_they_cannot_run(su):
    eng = su.engine()
    with pytest.raises(ValueError, match="need 2 seeds, got 3"):
        TorchFused(eng, num_streams=2, seed=[0, 1, 2])
    with pytest.raises(ValueError, match="num_streams requires arena=True"):
        TorchFused(eng, num_streams=2, arena=False)
    with pytest.raises(ValueError, match="unknown stream_impl"):
        TorchFused(eng, num_streams=2, stream_impl="scan")
    for impl in ("map", "unroll"):  # a mesh shards the stream axis under vmap only
        with pytest.raises(ValueError, match="use 'vmap' for stream-parallel"):
            TorchFused(eng, num_streams=2, stream_impl=impl, mesh=object())
    with pytest.raises(ValueError, match="MAD under vmap requires num_blocks=1"):
        TorchFused(eng, mode="MAD", num_blocks=2, num_streams=2, stream_impl="vmap")
    one_rank = SimpleNamespace(get_group=lambda axis: SimpleNamespace(size=lambda: 1, rank=lambda: 0))
    meshed = TorchFused(eng, mode="NONE", num_streams=2, mesh=one_rank, max_steps=2)
    assert meshed.stream_impl == "vmap"  # "auto" under a mesh
    with pytest.raises(ValueError, match="single-chip dispatch optimization"):
        meshed.step_chunk({k: v[None] for k, v in _stack([_frames(77, 1)] * 2)[0].items()})
    sess = TorchFused(eng, mode="NONE", num_streams=2, max_steps=2)
    with pytest.raises(ValueError, match=r"leading \[2\] axis"):
        sess.step(_frames(77, 1)[0])  # one stream's frame
