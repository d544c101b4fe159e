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
* Under ``bf16_act`` (``torch_parallel_ranks.py spatial bf16_act``, each
  rank setting the mode itself; the tamed weights of
  ``tests/test_torch_precision.py``): the step on frame 0 and the mesh MAD
  session with either loss against the JAX package in the mode on a
  1-device and a 2-device mesh and against the port in one process
  (:func:`mode_failures`, bounds with their measured values in each
  test); the same ranks at ``highest`` fail that check (the control); every
  exchange arrives as the neighbour sent it, bf16 where the convolutions
  and the correlation fetch, bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch import ops as tops
from real_time_self_adaptive_deep_stereo_torch.adapt import FusedOnlineSession as TorchFused
from real_time_self_adaptive_deep_stereo_torch.losses import get_reprojection_loss
from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net as torch_net
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
from tests.test_torch_precision import _closer_share, _jax_precision, _madnet_params
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
    return {"ranks": _load_ranks(work), "model": model, "params": params, "state": state, "frames": frames,
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


# ------------------------------------------------------- the precision modes
MODE = "bf16_act"
MODE_LOSS_RTOL = 1e-3  # tests/test_torch_precision.py: one bf16_act MAD step of MADNet
MODE_GRAD_RTOL = 1e-2  # of the largest entry: the same test's gradient and parameter change
RANK_SHARE = 0.3


@pytest.fixture(scope="module")
def modes(tmp_path_factory):
    """The ranks' precision runs (``torch_parallel_ranks.py spatial
    PRECISION``) under bf16_act and at highest (the control), from the
    tamed weights of ``tests/test_torch_precision.py`` on this module's
    frames; the JAX step and mesh sessions under bf16_act on a 1-device
    and a 2-device mesh; the port's in one process under bf16_act and at
    highest (within 1e-6 of the JAX package's there)."""
    params = _madnet_params(1)
    state = tck.params_from_jax(params)
    frames = _frames(80, 3)
    proxies = _proxies(frames)
    ranks = {}
    for precision in (MODE, "highest"):
        work = tmp_path_factory.mktemp(f"spatial_{precision}")
        np.savez(work / "weights.npz", **{k: v.numpy() for k, v in state.items()})
        np.savez(work / "frames.npz", **{f"frame{i}/{k}": v for i, f in enumerate(frames)
                                         for k, v in {**f, "proxy": proxies[i]}.items()})
        run_ranks("spatial", work, precision=precision)
        ranks[precision] = _load_ranks(work)
    jax_runs = {n: _jax_spatial(params, frames, proxies, n, tags) for n, tags in ((1, ("mesh", "proxy")), (2, ("mesh",)))}
    one = {p: _port_spatial(state, frames, proxies, p) for p in (MODE, "highest")}
    return {"ranks": ranks, "jax": jax_runs, "one": one, "state": state}


def _load_ranks(work):
    ranks = []
    for r in range(WORLD):
        with np.load(work / f"rank{r}.npz") as f:
            got = {k: f[k] for k in f.files}
        got["audit"] = json.loads((work / f"rank{r}.json").read_text())
        ranks.append(got)
    return ranks


def _jax_spatial(params, frames, proxies, n, tags):
    """The JAX package under bf16_act on ``make_mesh(n)``: the spatial
    step on frame 0 (loss, gradient) and the mesh MAD sessions of ``tags``
    ("mesh", "proxy": every frame's loss, EPE and disparity; the
    weights)."""
    out = {}
    with _jax_precision(MODE):
        mesh = j_make_mesh(n)
        _, acc, loss = j_make_spatial_adapt_step(j_net("MADNet", corr_mode="jnp"), mesh, lr=LR)(
            _copy(params), j_optim.momentum_init(params), j_shard_batch(frames[0], j_width_sharded(mesh)))
        out["step"] = {"loss": np.float32(loss), "g": _state(acc)}
        for tag in tags:
            adaptation = "proxy" if tag == "proxy" else "reprojection"
            net = j_net("MADNet", bulkhead=True, corr_mode="jnp")
            blocks = jblocks.make_blocks(jblocks.load_block_config(BLOCK_CONFIG), net.layer_to_path)
            sess = JaxFused(JaxEngine(net, blocks, lr=LR, adaptation=adaptation), _copy(params), mode="MAD",
                            sample_mode="SEQUENTIAL", max_steps=8, seed=0, ssim_th=1e9, mesh=mesh)
            disps = []
            for f, p in zip(frames, proxies):
                sess.step(j_shard_batch({**f, "proxy": p} if adaptation == "proxy" else f, j_width_sharded(mesh)))
                disps.append(np.asarray(sess.last_disp.astype(jnp.float32)))
            stats = sess.finalize()
            out[tag] = {"loss": np.asarray(stats["loss"]), "epe": np.asarray(stats["epe"]), "disps": disps,
                        "dtype": str(sess.last_disp.dtype), "w": _state(sess.current_params())}
    return out


def _port_spatial(state, frames, proxies, precision):
    """The port in one process under ``precision``, in ``_jax_spatial``'s
    form: the step's loss and gradient on frame 0, the MAD sessions with
    either loss (and their fetch counters and arenas)."""
    with tops.conv_precision(precision):
        model = torch_net("MADNet", device="cpu")
        model.load_state_dict(state)
        f0 = {k: torch.from_numpy(v) for k, v in frames[0].items()}
        loss = get_reprojection_loss("mean_SSIM_l1", reduced=True)(model(f0["left"], f0["right"])["disparities"], f0)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out = {"step": {"loss": np.float32(loss.detach()),
                        "g": {n: g.numpy() for (n, _), g in zip(model.named_parameters(), grads)}}}
        for tag in ("mesh", "proxy"):
            adaptation = "proxy" if tag == "proxy" else "reprojection"
            sess = TorchFused(_mad_engine(state, True, adaptation), mode="MAD", sample_mode="SEQUENTIAL", max_steps=8,
                              seed=0, ssim_th=1e9)
            disps = []
            for f, p in zip(frames, proxies):
                sess.step({**f, "proxy": p} if adaptation == "proxy" else f)
                disps.append(sess.last_disp.float().numpy().copy())
            stats = sess.finalize()
            out[tag] = {"loss": stats["loss"], "epe": stats["epe"], "fetch_counter": stats["fetch_counter"],
                        "disps": disps, "dtype": str(sess.last_disp.dtype), "flat": sess.arena.flat.clone(),
                        "w": {n: p.detach().numpy().copy() for n, p in sess.current_params().items()}}
    return out


def _state(tree):
    return {k: v.numpy() for k, v in tck.params_from_jax(jax.tree_util.tree_map(np.asarray, tree)).items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _of_largest(got, want, names):
    """The largest difference over ``names`` as a share of ``want``'s largest entry."""
    scale = max(float(np.abs(want[n]).max()) for n in names)
    return max(float(np.abs(got[n] - want[n]).max()) for n in names) / scale


def mode_failures(run, ref, two, highest, names, w0, loss_rtol, change_rtol, epe_rtol=MESH_EPE["rtol"]):
    """What a rank run in a mode fails against the JAX run in that mode on
    one device (``ref``), each bound the larger of its own figure and the
    JAX package's drift from one device to two (``two``; None: the figure
    alone), and against the run at highest (``highest``, the port's in one
    process): the loss, the EPE and the gradient or the parameter change
    (over ``names``, from ``w0``) within bounds; at least RANK_SHARE of the
    gradient's or the change's entries, and of the disparities', closer to
    the mode's than to highest's. A run that ignored the mode fails the
    shares."""
    failures = []
    for k, rtol in (("loss", loss_rtol), ("epe", epe_rtol)):
        if k in run:
            bound = max(rtol, _rel(two[k], ref[k]) if two else 0.0)
            if not _rel(run[k], ref[k]) <= bound:
                failures.append(f"{k} {_rel(run[k], ref[k]):.3g} > {bound:.3g}")
    if "g" in run:
        got, want, two_w, hi = (x and x["g"] for x in (run, ref, two, highest))
    else:
        got, want, two_w, hi = (x and {n: x["w"][n] - w0[n] for n in names} for x in (run, ref, two, highest))
    bound = max(change_rtol, _of_largest(two_w, want, names) if two else 0.0)
    if not _of_largest(got, want, names) <= bound:
        failures.append(f"change {_of_largest(got, want, names):.3g} > {bound:.3g}")
    shares = {"change": _closer_share([got[n] for n in names], [want[n] for n in names], [hi[n] for n in names])}
    if "disps" in run:
        shares["disparity"] = _closer_share(run["disps"], ref["disps"], highest["disps"])
    failures += [f"{k} share {v:.3f} < {RANK_SHARE}" for k, v in shares.items() if not v >= RANK_SHARE]
    return failures


def _rank_runs(ranks, names):
    """Each precision run of rank 0 in ``mode_failures``'s form, the
    disparities the two ranks' pieces joined."""
    r0, r1 = ranks
    runs = {"step": {"loss": r0["step/loss"], "g": {n: r0[f"step/g/{n}"] for n in names}}}
    for tag in ("mesh", "proxy"):
        runs[tag] = {"loss": r0[f"{tag}/loss"], "epe": r0[f"{tag}/epe"],
                     "disps": [np.concatenate([r0[f"{tag}/disp{i}"], r1[f"{tag}/disp{i}"]], axis=2) for i in range(3)],
                     "w": {n: r0[f"{tag}/flat"][off : off + size].reshape(shape)
                           for n, (off, size, shape) in names.items()}}
    return runs


def _arena_names(state):
    """name: (offset, size, shape) of the arena of the mesh session."""
    one = TorchFused(_mad_engine(state, True), mode="MAD", sample_mode="SEQUENTIAL", max_steps=8, seed=0)
    return {name: (off, size, shape) for name, shape, off, size in one.spec.entries}


def _failures_by_run(modes, precision):
    names = _arena_names(modes["state"])
    runs = _rank_runs(modes["ranks"][precision], names)
    w0 = {n: v.numpy() for n, v in modes["state"].items()}
    out = {}
    for tag, run in runs.items():
        out[tag] = mode_failures(run, modes["jax"][1][tag], modes["jax"][2].get(tag), modes["one"]["highest"][tag],
                                 sorted(run["g"] if "g" in run else names), w0, MODE_LOSS_RTOL, MODE_GRAD_RTOL)
    return out


def test_ranks_under_bf16_act_match_jax_on_one_and_two_devices(modes):
    """The step, the mesh MAD session and the proxy session of the two
    ranks under bf16_act against the JAX package in the mode. Measured
    (the bounds are the larger of the figure and the JAX package's own
    drift from a 1-device to a 2-device mesh, where it was run): the
    step's loss 5.3e-4 of the JAX step's (bound 1e-3; JAX 1.0e-4), its
    gradient 2.2e-3 of the largest entry (bound 1e-2; JAX 6.0e-3), closer
    to the mode's at 0.68 of the entries; the MAD session's loss 2.0e-5 to
    5.3e-4 (JAX 8.5e-6 to 1.0e-4), EPE up to 3.0e-4 (bound 5e-4; JAX
    5.1e-5), weights' change 3.0e-3 of the largest (JAX 6.0e-3), shares
    0.82 (change) and 0.53-0.59 by frame (disparities); the proxy
    session's loss up to 3.0e-4, EPE 2.5e-4, change 7.8e-3 (bound 1e-2),
    shares 0.68 and 0.53-0.59. The port at highest scores 0 to 0.005 on
    every share (the control below)."""
    for tag, failures in _failures_by_run(modes, MODE).items():
        assert not failures, (tag, failures)


def test_mode_check_fails_the_ranks_at_highest(modes):
    """The control: the same ranks run at highest fail the check of every
    run, on the shares at least (the losses of the mode's own size pass)."""
    for tag, failures in _failures_by_run(modes, "highest").items():
        assert any("share" in f for f in failures), (tag, failures)


def test_ranks_under_bf16_act_match_one_process(modes):
    """The ranks bit for bit; against the port in one process under
    bf16_act, which runs the same ops but for the sums over the ranks: the
    step's loss within SAME_OPS_RTOL (measured 1.3e-7), the sessions' loss
    and EPE within SAME_OPS_RTOL (measured 0 to 1.3e-7), their weights
    within RERUN and the disparity pieces within DISP_RTOL of the largest
    (measured 0). Under bf16_act the port's drift from one process to two
    ranks is below the JAX package's own from one device to two
    (``ROADMAP.md`` section 3)."""
    r0, r1 = modes["ranks"][MODE]
    for key in r0:
        if key.startswith(("step/", "mesh/", "proxy/")) and "/disp" not in key:
            np.testing.assert_array_equal(r0[key], r1[key], err_msg=f"the ranks differ in {key}")
    one = modes["one"][MODE]
    np.testing.assert_allclose(float(r0["step/loss"]), float(one["step"]["loss"]), rtol=SAME_OPS_RTOL)
    for tag in ("mesh", "proxy"):
        ref = one[tag]
        assert str(r0[f"{tag}/disp_dtype"]) == ref["dtype"] == "torch.float32"  # MADNet's heads: fp32 in every mode
        for i, d in enumerate(ref["disps"]):
            whole = np.concatenate([r0[f"{tag}/disp{i}"], r1[f"{tag}/disp{i}"]], axis=2)
            np.testing.assert_allclose(whole, d, rtol=0, atol=DISP_RTOL * float(np.abs(d).max()))
        for k in ("loss", "epe"):
            np.testing.assert_allclose(r0[f"{tag}/{k}"], ref[k], rtol=SAME_OPS_RTOL, err_msg=f"{tag} {k}")
        np.testing.assert_array_equal(r0[f"{tag}/fetch_counter"], ref["fetch_counter"])
        torch.testing.assert_close(torch.from_numpy(r0[f"{tag}/flat"]), ref["flat"], **RERUN)


def assert_bf16_halos(ranks, kinds):
    """Every exchange of the bf16_act run: each piece a rank sent arrives
    at its neighbour as the same dtype, shape and bits, at the same place
    in the neighbour's order; the fetches of ``kinds`` (the convolutions'
    halos, the correlation's) carry bf16; and a halo of a bf16 tensor
    known to both ranks (through the layout, zeros beyond the frame)
    arrives as bf16, equal bit for bit to that tensor's columns."""
    logs = [r["audit"]["exchanges"] for r in ranks]
    exchanges = [[e for e in log if e[0] == "exchange"] for log in logs]
    assert len(exchanges[0]) == len(exchanges[1]) > 0
    bf16 = 0
    for i, (a, b) in enumerate(zip(*exchanges)):
        for me, (mine, theirs) in enumerate(((a, b), (b, a))):
            sent = _pieces(mine[1], 1 - me)
            assert sent == _pieces(theirs[2], me), (i, me)
            bf16 += sum(dtype == "torch.bfloat16" for dtype, *_ in sent)
    assert bf16 > 0
    for log in logs:
        dtypes = {}
        for e in log:
            if e[0] == "fetch":
                dtypes.setdefault(e[1].split()[0], set()).add(e[2])
        for kind in kinds:
            assert dtypes[kind] == {"torch.bfloat16"}, (kind, dtypes)
    for r in ranks:
        whole = torch.from_numpy(r["probe/whole"]).view(torch.bfloat16)
        lo, hi = (int(v) for v in r["probe/span"])
        want = torch.nn.functional.pad(whole, (3, 5))[..., lo + 3 : hi + 3]
        assert str(r["probe/dtype"]) == "torch.bfloat16"
        assert torch.equal(torch.from_numpy(r["probe/halo"]).view(torch.bfloat16), want)


def _pieces(pieces, peer):
    """(dtype, shape, digest) of each recorded piece to or from ``peer``."""
    return [(dtype, tuple(shape), digest) for s, dtype, shape, digest in pieces if s == peer]


def test_bf16_halos_arrive_as_the_neighbours_columns(modes):
    assert_bf16_halos(modes["ranks"][MODE], ("conv", "correlation"))
