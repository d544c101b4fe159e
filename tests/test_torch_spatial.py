"""The port's width sharding (``parallel/spatial.py``,
``parallel.make_spatial_adapt_step``, ``FusedOnlineSession(mesh=...)``) and
its stream axis over a mesh, on the CPU: two ranks of a ``gloo`` group,
each a process of its own (``tests/torch_parallel_ranks.py``, mode
``spatial``, which imports the port only), against the JAX package on one
device and against the port in one process. MADNet at 64x128 on smooth
frames made with numpy from seeds; each rank holds 64 columns.

* ``make_spatial_adapt_step``, one step, against the JAX package's
  ``make_spatial_adapt_step(model, make_mesh(1))`` on the whole frame: the
  loss within 1e-4 relative and ``pyramid.conv1``'s weights within rtol
  1e-3 / atol 1e-6 (``tests/test_parallel.py``); the two ranks' weights
  equal bit for bit.
* The width-sharded MAD session (bulkhead, SEQUENTIAL, 3 frames) against
  the JAX session on one device at ``tests/test_parallel.py``'s bounds
  (loss 5e-4 / 1e-6, EPE 5e-4 / 1e-5, fetch counters equal,
  ``estimator_6.disp1`` 1e-3 / 1e-6), and against the port's session in
  one process, whose ops differ only in the order of the sums over the
  ranks: loss and EPE within 2e-5 relative, weights within the 1e-5 of two
  runs of one session (``tests/test_torch_fused.py``, ``RERUN``), the
  disparity pieces within 1e-4 of the largest disparity.
* The same session adapting to proxy labels (each rank's masked L1 sum
  over the frame's valid count, which the ranks sum; a different count on
  each rank): the ranks bit for bit, against the JAX session on one device
  and the port's session in one process at the same bounds.
* The halo audit, the port's form of ``tests/test_parallel.py``'s: every
  convolution fetched exactly the halo of its kernel, stride, rate and
  SAME split, the correlation its radius, the SSIM one column, the resize
  at most one column on the right; all-gathers (every rank asking for the
  whole width) come from the warps alone, one a warp.
* Four streams over the two ranks (``stream_impl="vmap"`` under a mesh):
  each rank equal bit for bit to one process's vmap session of its two
  streams with their seeds, both ranks' gathered statistics and weights
  the four streams', and the frames before any update within 2e-5 of one
  process's four-stream session.
"""

import json

import jax
import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch.adapt import FusedOnlineSession as TorchFused
from real_time_self_adaptive_deep_stereo_torch.ops.conv import _same_1d
from real_time_self_adaptive_deep_stereo_torch.parallel import make_spatial_adapt_step
from real_time_self_adaptive_deep_stereo_torch.utils import checkpoint as tck
from real_time_self_adaptive_deep_stereo_tpu.adapt import AdaptationEngine as JaxEngine
from real_time_self_adaptive_deep_stereo_tpu.adapt import blocks as jblocks
from real_time_self_adaptive_deep_stereo_tpu.adapt.fused import FusedOnlineSession as JaxFused
from real_time_self_adaptive_deep_stereo_tpu.models import get_stereo_net as j_net
from real_time_self_adaptive_deep_stereo_tpu.parallel import make_mesh as j_make_mesh
from real_time_self_adaptive_deep_stereo_tpu.parallel import make_spatial_adapt_step as j_make_spatial_adapt_step
from real_time_self_adaptive_deep_stereo_tpu.parallel import shard_batch as j_shard_batch
from real_time_self_adaptive_deep_stereo_tpu.parallel import width_sharded as j_width_sharded
from real_time_self_adaptive_deep_stereo_tpu.utils import optim as j_optim
from tests.test_torch_fused import NoShardingStub
from tests.test_torch_parallel import WORLD, run_ranks
from tests.test_torch_streams import H, W, _frames, _stack
from tests.torch_parallel_ranks import BLOCK_CONFIG, N_STREAMS, _mad_engine

LR = 1e-4
STEP_LOSS_RTOL = 1e-4  # tests/test_parallel.py::test_spatial_adapt_step_matches_unsharded
WEIGHT_TOL = dict(rtol=1e-3, atol=1e-6)  # the same test's weights
MESH_LOSS = dict(rtol=5e-4, atol=1e-6)  # tests/test_parallel.py::test_mad_fused_step_under_mesh_...
MESH_EPE = dict(rtol=5e-4, atol=1e-5)
SAME_OPS_RTOL = 2e-5
RERUN = dict(rtol=1e-5, atol=1e-5)
DISP_RTOL = 1e-4  # of the largest disparity
WARPS = ("warp_features", "warp_image")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spatial(tmp_path_factory):
    """The ranks' results, with the weights and frames they ran on."""
    work = tmp_path_factory.mktemp("spatial")
    model = j_net("MADNet", corr_mode="jnp")
    params = model.init(jax.random.PRNGKey(0))
    state = tck.params_from_jax(params)
    np.savez(work / "weights.npz", **{k: v.numpy() for k, v in state.items()})
    frames = _frames(80, 3)
    proxies = _proxies(frames)
    streams = _stack([_frames(81 + s, 3) for s in range(N_STREAMS)])
    for name, fs in (("frames", [{**f, "proxy": p} for f, p in zip(frames, proxies)]), ("streams", streams)):
        np.savez(work / f"{name}.npz", **{f"frame{i}/{k}": v for i, f in enumerate(fs) for k, v in f.items()})
    run_ranks("spatial", work)
    ranks = []
    for r in range(WORLD):
        with np.load(work / f"rank{r}.npz") as f:
            got = {k: f[k] for k in f.files}
        got["audit"] = json.loads((work / f"rank{r}.json").read_text())
        ranks.append(got)
    return {"ranks": ranks, "model": model, "params": params, "state": state, "frames": frames,
            "proxies": proxies, "streams": streams}


def _proxies(frames):
    """Proxy labels: each frame's disparity with noise, 0 (invalid) where it
    has none and at random elsewhere, more often on the left: the ranks
    hold different counts of valid pixels."""
    r = np.random.default_rng(90)
    out = []
    for f in frames:
        t = f["target"]
        drop = r.random(t.shape) < np.linspace(0.6, 0.1, t.shape[2])[None, None, :, None]
        noisy = t + r.normal(0.0, 0.5, t.shape)
        out.append(np.where(drop | (t == 0), 0.0, noisy).astype(np.float32))
    return out


def _copy(params):
    return jax.tree_util.tree_map(lambda x: x.copy(), params)


def test_spatial_adapt_step_matches_the_jax_step_on_one_device(spatial):
    r0, r1 = spatial["ranks"]
    mesh = j_make_mesh(1)
    params = spatial["params"]
    p1, _, loss1 = j_make_spatial_adapt_step(spatial["model"], mesh, lr=LR)(
        _copy(params), j_optim.momentum_init(params), j_shard_batch(spatial["frames"][0], j_width_sharded(mesh)))
    assert float(r0["step/loss"]) == float(r1["step/loss"])
    np.testing.assert_allclose(float(r0["step/loss"]), float(loss1), rtol=STEP_LOSS_RTOL)
    want = tck.params_from_jax(jax.tree_util.tree_map(np.asarray, p1))
    name = "pyramid.conv1.weight"
    np.testing.assert_allclose(r0[f"step/w/{name}"], want[name].numpy(), **WEIGHT_TOL)
    assert not np.array_equal(r0[f"step/w/{name}"], spatial["state"][name].numpy())  # it stepped
    for key in r0:
        if key.startswith("step/w/"):
            np.testing.assert_array_equal(r0[key], r1[key], err_msg=f"the ranks differ in {key}")


def test_spatial_step_refuses_what_it_cannot_run():
    with pytest.raises(NotImplementedError, match="Stub has no width-sharded form"):
        make_spatial_adapt_step(NoShardingStub(), mesh=None)


def _jax_mesh_session(spatial, adaptation="reprojection", **kw):
    net = j_net("MADNet", bulkhead=True, corr_mode="jnp")
    blocks = jblocks.make_blocks(jblocks.load_block_config(BLOCK_CONFIG), net.layer_to_path)
    mesh = j_make_mesh(1)
    sess = JaxFused(JaxEngine(net, blocks, lr=LR, adaptation=adaptation), _copy(spatial["params"]), mode="MAD",
                    sample_mode="SEQUENTIAL", max_steps=8, seed=0, mesh=mesh, **kw)
    for f, p in zip(spatial["frames"], spatial["proxies"]):
        sess.step(j_shard_batch({**f, "proxy": p} if adaptation == "proxy" else f, j_width_sharded(mesh)))
    return sess.finalize(), tck.params_from_jax(jax.tree_util.tree_map(np.asarray, sess.current_params()))


def test_mesh_session_matches_jax_on_one_device_and_one_process(spatial):
    r0, r1 = spatial["ranks"]
    want, want_params = _jax_mesh_session(spatial)
    for key in ("mesh/loss", "mesh/epe", "mesh/fetch_counter", "mesh/flat", "mesh/scores", "mesh/d1"):
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=f"the ranks differ in {key}")
    assert int(r0["mesh/steps"]) == 3
    np.testing.assert_allclose(r0["mesh/loss"], want["loss"], **MESH_LOSS)
    np.testing.assert_allclose(r0["mesh/epe"], want["epe"], **MESH_EPE)
    np.testing.assert_array_equal(r0["mesh/fetch_counter"], np.asarray(want["fetch_counter"]))
    assert r0["mesh/fetch_counter"].tolist() == [1, 1, 1, 0, 0]

    one = TorchFused(_mad_engine(spatial["state"], True), mode="MAD", sample_mode="SEQUENTIAL",
                     max_steps=8, seed=0)
    disps = []
    for f in spatial["frames"]:
        one.step(f)
        disps.append(one.last_disp.numpy().copy())
    ref = one.finalize()
    for k in ("loss", "epe"):
        np.testing.assert_allclose(r0[f"mesh/{k}"], ref[k], rtol=SAME_OPS_RTOL, err_msg=k)
    np.testing.assert_allclose(r0["mesh/d1"], ref["d1"], atol=101.0 / (H * W))
    flat = torch.from_numpy(r0["mesh/flat"])
    torch.testing.assert_close(flat, one.arena.flat, **RERUN)
    names = {name: (off, size, shape) for name, shape, off, size in one.spec.entries}
    off, size, shape = names["estimator_6.disp1.weight"]
    np.testing.assert_allclose(r0["mesh/flat"][off : off + size].reshape(shape),
                               want_params["estimator_6.disp1.weight"].numpy(), **WEIGHT_TOL)
    for i, d in enumerate(disps):
        # each rank's piece of the even cut of the width, as shard_batch cuts it
        assert r0[f"mesh/disp{i}"].shape == r1[f"mesh/disp{i}"].shape == (1, H, W // 2, 1)
        whole = np.concatenate([r0[f"mesh/disp{i}"], r1[f"mesh/disp{i}"]], axis=2)
        np.testing.assert_allclose(whole, d, rtol=0, atol=DISP_RTOL * float(np.abs(d).max()))
    assert "single-chip dispatch optimization" in r0["audit"]["step_chunk"]


def test_mesh_session_adapts_to_proxy_labels(spatial):
    r0, r1 = spatial["ranks"]
    for key in ("proxy/loss", "proxy/epe", "proxy/fetch_counter", "proxy/flat", "proxy/scores"):
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=f"the ranks differ in {key}")
    # no reset: the random network's proxy loss is above the threshold
    want, want_params = _jax_mesh_session(spatial, "proxy", ssim_th=1e9)
    np.testing.assert_allclose(r0["proxy/loss"], want["loss"], **MESH_LOSS)
    np.testing.assert_allclose(r0["proxy/epe"], want["epe"], **MESH_EPE)
    np.testing.assert_array_equal(r0["proxy/fetch_counter"], np.asarray(want["fetch_counter"]))

    one = TorchFused(_mad_engine(spatial["state"], True, "proxy"), mode="MAD", sample_mode="SEQUENTIAL",
                     max_steps=8, seed=0, ssim_th=1e9)
    for f, p in zip(spatial["frames"], spatial["proxies"]):
        one.step({**f, "proxy": p})
    ref = one.finalize()
    for k in ("loss", "epe"):
        np.testing.assert_allclose(r0[f"proxy/{k}"], ref[k], rtol=SAME_OPS_RTOL, err_msg=k)
    np.testing.assert_array_equal(r0["proxy/fetch_counter"], ref["fetch_counter"])
    assert int(r0["proxy/reset_count"]) == 0
    torch.testing.assert_close(torch.from_numpy(r0["proxy/flat"]), one.arena.flat, **RERUN)
    assert not torch.equal(one.arena.flat, one.arena.flat0)  # it adapted
    names = {name: (off, size, shape) for name, shape, off, size in one.spec.entries}
    off, size, shape = names["estimator_6.disp1.weight"]
    np.testing.assert_allclose(r0["proxy/flat"][off : off + size].reshape(shape),
                               want_params["estimator_6.disp1.weight"].numpy(), **WEIGHT_TOL)


def _geometry(tag):
    """(k_eff, stride) of a convolution's audit tag ``conv k<K> s<S>``."""
    k, s = tag.split()[1:]
    return int(k[1:]), int(s[1:])


@pytest.mark.parametrize("which", ["step", "mesh_frame"])
def test_no_conv_fetches_more_than_its_halo(spatial, which):
    """Every fetch by its caller (forward; the backward sends the same
    columns back): the convolutions, the correlation, the SSIM and the
    resizes fetch their halos, and the only all-gathers are the warps'."""
    for rank in spatial["ranks"]:
        records = rank["audit"][which]
        tags = {}
        for tag, w, left, right, whole, n in records:
            tags[tag.split()[0]] = tags.get(tag.split()[0], 0) + n
            if tag.startswith("conv"):
                k_eff, stride = _geometry(tag)
                pad_left, _ = _same_1d(w, k_eff, stride, 1)
                assert (left, right) == (pad_left, k_eff - stride - pad_left), (tag, w, left, right)
            elif tag == "correlation":
                assert (left, right) == (2, 2), (tag, w, left, right)  # MADNet's radius
            elif tag == "ssim":
                assert (left, right) == (1, 1) and w == W
            elif tag == "resize":
                assert left == 0 and 0 <= right <= 1, (tag, w, left, right)
            elif tag in WARPS:
                assert whole, (tag, w)
            else:
                assert tag in ("enter", "leave"), tag
            assert not whole or tag in WARPS, f"{tag} at width {w} gathered the whole width"
        # every SAME convolution of the forward (49 of MADNet) fetched its halo
        assert tags["conv"] >= 49 and tags["conv"] % 49 == 0, tags
        assert tags["warp_features"] % 4 == 0 and tags["warp_image"] >= 1, tags


def test_streams_over_the_mesh_match_one_process(spatial):
    r0, r1 = spatial["ranks"]
    streams = spatial["streams"]
    per_rank = N_STREAMS // WORLD
    refs = []
    for r in range(WORLD):
        rows = slice(r * per_rank, (r + 1) * per_rank)
        sess = TorchFused(_mad_engine(spatial["state"], True), mode="MAD", sample_mode="PROBABILITY", max_steps=8,
                          seed=list(range(N_STREAMS))[rows], ssim_th=1e9, num_streams=per_rank, stream_impl="vmap")
        for f in streams:
            sess.step({k: v[rows] for k, v in f.items()})
        refs.append((sess.finalize(), sess.arena.flat.numpy().copy(), sess.current_params()))
        # the rank ran its streams as one process runs them, bit for bit
        np.testing.assert_array_equal(spatial["ranks"][r]["streams/rows"], refs[-1][1])
    for key in ("loss", "epe", "fetch_counter", "scores", "reset_count"):
        want = np.concatenate([ref[0][key] for ref in refs])
        for got in (r0, r1):
            np.testing.assert_array_equal(got[f"streams/{key}"], want, err_msg=key)
    conv1 = np.concatenate([ref[2]["pyramid.conv1.weight"].numpy() for ref in refs])
    for got in (r0, r1):
        assert got["streams/conv1"].shape == (N_STREAMS, 16, 3, 3, 3)
        np.testing.assert_array_equal(got["streams/conv1"], conv1)
    # one process, four streams: the frames before any update agree to the
    # rounding of a four-group convolution against a two-group one
    four = TorchFused(_mad_engine(spatial["state"], True), mode="MAD", sample_mode="PROBABILITY", max_steps=8,
                      seed=list(range(N_STREAMS)), ssim_th=1e9, num_streams=N_STREAMS, stream_impl="vmap")
    four.step(streams[0])
    first = four.finalize()
    for k in ("loss", "epe"):
        np.testing.assert_allclose(r0[f"streams/{k}"][:, :1], first[k], rtol=SAME_OPS_RTOL, err_msg=k)
    assert r0["streams/loss"].shape == (N_STREAMS, 3)
    assert r0["streams/rows"].shape[0] == per_rank
