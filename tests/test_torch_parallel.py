"""The port's ``parallel/`` and ``cli/train.py --dataParallel`` on the CPU:
two ranks of a ``gloo`` group, each a process of its own
(``tests/torch_parallel_ranks.py``, which imports the port only), joined
through a file under the test's temporary directory, one intra-op thread
each, killed after ``JOIN_S`` seconds.

* The sharding helpers: placements, and each rank's piece of a batch cut
  on its batch and on its width axis (``torch.chunk``'s pieces).
* ``make_dp_train_step`` at 64x128, MADNet, a global batch of 4 smooth
  frames whose targets hold zeros spread unevenly over its halves, against the JAX
  package's ``make_dp_train_step(model, make_mesh(1))`` on the whole batch
  (computed here, in the parent) from the same weights: the loss within
  1e-5 relative, the gradient the step took (the JAX one: ten times Adam's
  first moment after the first step) within 1e-5 of its largest entry,
  the weights after the
  step within rtol 1e-3 / atol 1e-6 (``tests/test_parallel.py``) where the
  gradient exceeds 1e-3 of its largest entry (Adam's first step is about
  lr*sign(g): where g is float32 noise the two packages step apart by up
  to 2*lr), and the two ranks' weights equal bit for bit. The same loss
  and gradient checks for every other loss with a data-parallel form
  (``mean_l2``, ``mean_huber``, ``sum_l1``, ``sum_l2``, ``sum_huber``).
* The halves' valid counts differ, and the mean of the per-rank losses
  misses the global loss by far more than 1e-5: a plain port of
  ``DistributedDataParallel`` would fail the check above.
* ``StereoDataset(shard=(r, 2))``, each rank's slice of every batch: the
  two slices make up the whole batches, crops and augmentation alike,
  each rank decoding half the frames (Python and native backends).
* ``cli/train.py``'s ``main`` on the two ranks against ``main`` in one
  process on the same list: each step's loss within 1e-5 relative, one
  checkpoint (rank 0's), its weights as above, the log lines rank 0's
  alone; ``cli()`` refuses more ranks than GPUs.
* Under ``bf16_act`` (``torch_parallel_ranks.py step bf16_act``, the tamed
  weights of ``tests/test_torch_precision.py``): the ``mean_l1`` step
  against the JAX step on a 2-device mesh in the mode, bounded by the
  larger of the one-step bounds and the JAX package's own drift to one
  device, and against the port in one process; the same ranks at
  ``highest`` fail the check; the ranks' weights bit for bit.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch.cli import train as t_train
from real_time_self_adaptive_deep_stereo_torch.data.png import write_png
from real_time_self_adaptive_deep_stereo_torch.losses import get_supervised_loss
from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net as t_net
from real_time_self_adaptive_deep_stereo_torch.parallel import local_slice, make_mesh
from real_time_self_adaptive_deep_stereo_torch.utils import checkpoint as tck
from real_time_self_adaptive_deep_stereo_tpu.models import get_stereo_net as j_net
from real_time_self_adaptive_deep_stereo_tpu.parallel import batch_sharded as j_batch_sharded
from real_time_self_adaptive_deep_stereo_tpu.parallel import make_dp_train_step as j_make_dp_train_step
from real_time_self_adaptive_deep_stereo_tpu.parallel import make_mesh as j_make_mesh
from real_time_self_adaptive_deep_stereo_tpu.parallel import shard_batch as j_shard_batch
from real_time_self_adaptive_deep_stereo_tpu.utils import optim as j_optim

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2
JOIN_S = 120
H, W = 64, 128
LR = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5  # of the largest entry
WEIGHT_TOL = dict(rtol=1e-3, atol=1e-6)  # tests/test_parallel.py
MOVED = 1e-3  # weights compared where |g| exceeds this share of the largest
ZERO_SHARE = (0.05, 0.1, 0.5, 0.7)  # of each sample's target: the halves' counts differ


def run_ranks(mode, workdir, join_s=JOIN_S, precision=None):
    """The ranks of ``mode``, each ``python -m tests.torch_parallel_ranks``
    (with a convolution ``precision``: the precision checks' paths alone);
    killed after ``join_s`` seconds. Returns each rank's standard output."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen([sys.executable, "-m", "tests.torch_parallel_ranks", mode, str(r), str(WORLD), str(workdir),
                          *([precision] if precision else [])],
                         cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)
    ]
    deadline = time.monotonic() + join_s
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited with {p.returncode}:\n{out[-4000:]}"
    return outs


def _batch():
    """Four smooth stereo pairs (six sinusoids a channel; right = left
    shifted by 3 + i px) with that disparity as ground truth, a share
    ZERO_SHARE[i] of it missing. On white-noise images the two packages'
    single-process gradients already differ by 5e-5 of the largest entry;
    on smooth ones by 1e-6."""
    r = np.random.default_rng(0)
    ys, xs = np.mgrid[0:H, 0 : W + 8].astype(np.float32)
    out = {"left": [], "right": [], "target": []}
    for i, share in enumerate(ZERO_SHARE):
        d = 3 + i
        base = np.zeros((H, W + 8, 3), np.float32)
        for c in range(3):
            for _ in range(6):
                fx, fy = r.uniform(0.02, 0.25, 2)
                px, py = r.uniform(0, 2 * np.pi, 2)
                base[..., c] += r.uniform(10, 40) * np.sin(2 * np.pi * fx * xs + px) * np.cos(
                    2 * np.pi * fy * ys + py)
        base = np.clip(base + 128, 0, 255)
        target = np.full((H, W, 1), float(d), np.float32)
        target[r.random((H, W, 1)) < share] = 0.0
        out["left"].append(base[:, :W])
        out["right"].append(base[:, d : W + d])
        out["target"].append(target)
    return {k: np.stack(v).astype(np.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The two ranks' step, and the JAX step on the whole batch."""
    work = tmp_path_factory.mktemp("dp_step")
    model = j_net("MADNet", corr_mode="jnp")
    params = model.init(jax.random.PRNGKey(0))
    state = tck.params_from_jax(params)
    np.savez(work / "weights.npz", **{k: v.numpy() for k, v in state.items()})
    batch = _batch()
    np.savez(work / "batch.npz", **batch)
    run_ranks("step", work)
    ranks = []
    for r in range(WORLD):
        with np.load(work / f"rank{r}.npz") as f:
            ranks.append({k: f[k] for k in f.files})
    mesh = j_make_mesh(1)
    p1, opt1, loss1 = j_make_dp_train_step(model, mesh, lr=LR)(
        jax.tree_util.tree_map(lambda x: x.copy(), params), j_optim.adam_init(params),
        j_shard_batch(batch, j_batch_sharded(mesh)))
    want = {"loss": float(loss1),
            "g": {k: 10.0 * v.numpy() for k, v in tck.params_from_jax(jax.tree_util.tree_map(np.asarray, opt1.m)).items()},
            "w": {k: v.numpy() for k, v in tck.params_from_jax(jax.tree_util.tree_map(np.asarray, p1)).items()}}
    return {"ranks": ranks, "want": want, "state": state, "batch": batch, "model": model, "params": params}


def _jax_step(dp, loss_name):
    """The JAX step of ``loss_name`` on the whole batch: (loss, gradient)."""
    mesh = j_make_mesh(1)
    params = dp["params"]
    _, opt1, loss1 = j_make_dp_train_step(dp["model"], mesh, lr=LR, loss_name=loss_name)(
        jax.tree_util.tree_map(lambda x: x.copy(), params), j_optim.adam_init(params),
        j_shard_batch(dp["batch"], j_batch_sharded(mesh)))
    m = tck.params_from_jax(jax.tree_util.tree_map(np.asarray, opt1.m))
    return float(loss1), {k: 10.0 * v.numpy() for k, v in m.items()}


def _assert_grads_close(got, want, what):
    scale = max(float(np.abs(g).max()) for g in want.values())
    err = max(float(np.abs(got[n] - w).max()) for n, w in want.items())
    assert scale > 0 and err <= GRAD_RTOL * scale, (what, err, scale)


def _assert_weights_close(got, want, moments, what):
    """``got`` against ``want`` where, at every Adam step, its first moment
    (one dict a step; after one step 0.1 of the gradient) exceeds MOVED of
    its largest entry: where it is noise, or nearly cancels at a later step,
    two correct runs step apart by up to 2*lr."""
    scales = [max(float(np.abs(m).max()) for m in ms.values()) for ms in moments]
    compared = 0
    for name, w in want.items():
        moved = np.logical_and.reduce([np.abs(ms[name]) > MOVED * sc for ms, sc in zip(moments, scales)])
        compared += int(moved.sum())
        np.testing.assert_allclose(got[name][moved], w[moved], **WEIGHT_TOL, err_msg=f"{what}: {name}")
    assert compared > 1000, compared


def test_sharding_helpers_place_and_cut(dp):
    even = np.arange(4 * 8 * 10 * 3, dtype=np.float32).reshape(4, 8, 10, 3)
    odd = np.arange(3 * 2 * 5 * 1, dtype=np.float32).reshape(3, 2, 5, 1)
    for r, got in enumerate(dp["ranks"]):
        np.testing.assert_array_equal(got["batch_even"], even[2 * r : 2 * r + 2])
        np.testing.assert_array_equal(got["width_even"], even[:, :, 5 * r : 5 * r + 5])
        np.testing.assert_array_equal(got["batch_odd"], torch.chunk(torch.from_numpy(odd), 2, 0)[r].numpy())
        np.testing.assert_array_equal(got["width_odd"], torch.chunk(torch.from_numpy(odd), 2, 2)[r].numpy())
        np.testing.assert_array_equal(got["replicated_even"], even)
    assert [local_slice(3, 2, i) for i in range(2)] == [slice(0, 2), slice(2, 3)]
    assert [local_slice(1, 4, i) for i in range(4)] == [slice(0, 1)] + [slice(1, 1)] * 3


def test_make_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialized process group"):
        make_mesh(device_type="cpu")


def test_dp_train_step_matches_the_jax_step_on_the_whole_batch(dp):
    want = dp["want"]
    r0, r1 = dp["ranks"]
    assert float(r0["loss"]) == float(r1["loss"])
    np.testing.assert_allclose(float(r0["loss"]), want["loss"], rtol=LOSS_RTOL)
    names = list(want["g"])
    _assert_grads_close({n: r0[f"g/{n}"] for n in names}, want["g"], "mean_l1")
    _assert_weights_close({n: r0[f"w/{n}"] for n in names}, want["w"], [want["g"]], "weights after one step")
    for key in r0:
        if key.startswith(("w/", "g/")):
            np.testing.assert_array_equal(r0[key], r1[key], err_msg=f"the ranks differ in {key}")


@pytest.mark.parametrize("loss_name", ["mean_l2", "mean_huber", "sum_l1", "sum_l2", "sum_huber"])
def test_dp_forms_of_the_other_losses_match_the_jax_step(dp, loss_name):
    r0, r1 = dp["ranks"]
    loss, g = _jax_step(dp, loss_name)
    assert float(r0[f"{loss_name}/loss"]) == float(r1[f"{loss_name}/loss"])
    np.testing.assert_allclose(float(r0[f"{loss_name}/loss"]), loss, rtol=LOSS_RTOL)
    _assert_grads_close({n: r0[f"{loss_name}/g/{n}"] for n in g}, g, loss_name)
    for n in g:
        np.testing.assert_array_equal(r0[f"{loss_name}/g/{n}"], r1[f"{loss_name}/g/{n}"])


def test_uneven_valid_counts_defeat_a_mean_of_rank_means(dp):
    """The check above would catch a port that averaged the ranks' own
    means (``DistributedDataParallel``'s average of per-rank losses)."""
    batch = {k: torch.from_numpy(v) for k, v in dp["batch"].items()}
    counts = [int((batch["target"][2 * r : 2 * r + 2] != 0).sum()) for r in range(WORLD)]
    assert counts[0] > 1.5 * counts[1], counts
    model = t_net("MADNet", device="cpu")
    model.load_state_dict(dp["state"])
    loss_fn = get_supervised_loss("mean_l1", multiScale=True, max_disp=t_train.MAX_DISP)
    with torch.no_grad():
        def loss(part):
            return float(loss_fn(model(part["left"], part["right"])["disparities"], part))

        whole = loss(batch)
        halves = [loss({k: v[2 * r : 2 * r + 2] for k, v in batch.items()}) for r in range(WORLD)]
    np.testing.assert_allclose(whole, dp["want"]["loss"], rtol=LOSS_RTOL)
    miss = abs(np.mean(halves) - whole) / whole
    assert miss > 100 * LOSS_RTOL, (halves, whole)


def _write_uneven_dataset(path):
    """Four frames whose ground truth is 3 px with 0 to 70% of it missing."""
    r = np.random.default_rng(11)
    base = (r.random((64, 96, 3)) * 255).astype(np.uint8)
    lines = []
    for i, share in enumerate((0.0, 0.7, 0.2, 0.5)):
        left = np.roll(base, i, axis=0)
        right = np.roll(left, -3, axis=1)
        gt = np.full((64, 96), 3.0, np.float32)
        gt[r.random((64, 96)) < share] = 0.0
        files = [str(path / f"{k}{i}.png") for k in ("l", "r", "g")]
        write_png(files[0], left)
        write_png(files[1], right)
        write_png(files[2], (gt * 256).astype(np.uint16))
        lines.append(",".join(files + files[2:]))
    (path / "list.csv").write_text("\n".join(lines) + "\n")
    return str(path / "list.csv")


@pytest.mark.parametrize("backend,augment", [("python", False), ("python", True), ("native", False)])
def test_dataset_shards_decode_only_their_slice(tmp_path, monkeypatch, backend, augment):
    """``StereoDataset(shard=(r, 2))``, what ``train --dataParallel`` reads
    on rank r: the two ranks' pieces of each batch make up the batch of
    one process, crops and augmentation drawn alike, over two epochs of
    six frames; each rank decodes half the frames."""
    from real_time_self_adaptive_deep_stereo_torch.data import readers
    from real_time_self_adaptive_deep_stereo_torch.runtime import native

    lines = Path(_write_uneven_dataset(tmp_path)).read_text().splitlines()
    data = tmp_path / "six.csv"
    data.write_text("\n".join(lines + lines[:2]) + "\n")
    decoded = []
    read_pngs = readers.read_pngs
    monkeypatch.setattr(readers, "read_pngs", lambda paths: decoded.append(paths[0]) or read_pngs(paths))
    submit = native.NativeStereoLoader.submit
    monkeypatch.setattr(native.NativeStereoLoader, "submit",
                        lambda self, *a, **k: decoded.append(a[0]) or submit(self, *a, **k))

    def read(shard=None):
        decoded.clear()
        got = list(readers.StereoDataset(str(data), batch_size=4, crop_shape=(32, 48), num_epochs=2,
                                         augment=augment, seed=3, backend=backend, shard=shard))
        return got, len(decoded)

    whole, n_whole = read()
    pieces = [read((r, WORLD)) for r in range(WORLD)]
    assert len(whole) == 3 and n_whole == 12
    for batches, n in pieces:
        assert len(batches) == 3 and n == 6
    for j, batch in enumerate(whole):
        for k, v in batch.items():
            np.testing.assert_array_equal(np.concatenate([p[0][j][k] for p in pieces]), v, err_msg=f"{j} {k}")
    with pytest.raises(ValueError, match="eval set is read whole"):
        readers.StereoDataset(str(data), batch_size=4, is_training=False, shard=(0, 2))
    with pytest.raises(ValueError, match="does not split evenly over 2 ranks"):
        readers.StereoDataset(str(data), batch_size=3, shard=(0, 2))


def test_train_cli_data_parallel_matches_one_process(tmp_path):
    from tests.test_torch_cli import jax_weights

    weights = jax_weights(tmp_path, "MADNet")
    data = _write_uneven_dataset(tmp_path)
    argv = ["--trainingSet", data, "--weights", weights, "--modelName", "MADNet", "--imageShape", "32", "48",
            "--batchSize", "4", "--numEpochs", "2", "--seed", "3"]
    (tmp_path / "argv.json").write_text(json.dumps(argv + ["-o", str(tmp_path / "dp")]))
    logs = run_ranks("cli", tmp_path)
    results = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(WORLD)]

    args = t_train.build_argparser().parse_args(argv + ["-o", str(tmp_path / "one")])
    want = t_train.main(args, device="cpu")
    assert want["steps"] == 2 and len(want["losses"]) == 2
    for res in results:
        assert res["steps"] == 2
        np.testing.assert_allclose(res["losses"], want["losses"], rtol=LOSS_RTOL)
    assert sorted(os.listdir(tmp_path / "dp")) == ["weights-2.npz"]
    assert "Data-parallel over 2 ranks (gloo)" in logs[0] and "All Done" in logs[0]
    assert "Step:" not in logs[1] and "All Done" not in logs[1]

    # Adam's first moment after each of the two steps of one process
    from real_time_self_adaptive_deep_stereo_torch.data import StereoDataset

    model = t_net("MADNet", device="cpu")
    model.load_state_dict(tck.params_from_jax(tck.load_params(weights)))
    step = t_train.make_train_step(
        model, get_supervised_loss("mean_l1", multiScale=True, max_disp=t_train.MAX_DISP), LR)
    names = [n for n, _ in model.named_parameters()]
    moments = []
    for batch in StereoDataset(data, batch_size=4, crop_shape=(32, 48), num_epochs=2, augment=False,
                               is_training=True, shuffle=True, seed=3):
        step({k: torch.from_numpy(v) for k, v in batch.items()})
        m = tck.flatten_params(tck.params_to_jax(dict(zip(names, step.opt["m"]))))  # the checkpoints' layout
        moments.append({k: np.array(v) for k, v in m.items()})
    assert len(moments) == 2
    got = tck.flatten_params(tck.load_params(str(tmp_path / "dp" / "weights-2.npz")))
    one = tck.flatten_params(tck.load_params(str(tmp_path / "one" / "weights-2.npz")))
    assert set(got) == set(one) == set(moments[0])
    _assert_weights_close(got, one, moments, "train --dataParallel")


def test_train_cli_refuses_more_ranks_than_gpus(tmp_path, monkeypatch):
    for k, v in {"WORLD_SIZE": "2", "RANK": "0", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "2"}.items():
        monkeypatch.setenv(k, v)
    argv = ["train", "--trainingSet", "x.csv", "-o", str(tmp_path), "--dataParallel"]
    monkeypatch.setattr(sys, "argv", argv)
    with pytest.raises(RuntimeError, match="one rank a GPU"):
        t_train.cli()
    monkeypatch.setattr(sys, "argv", argv[:-1])
    with pytest.raises(ValueError, match="--dataParallel"):
        t_train.cli()


# ------------------------------------------------------- the precision modes
MODE = "bf16_act"


@pytest.fixture(scope="module")
def dp_modes(tmp_path_factory):
    """The ranks' ``mean_l1`` step (``torch_parallel_ranks.py step
    PRECISION``) under bf16_act and at highest (the control) from the
    tamed weights of ``tests/test_torch_precision.py`` on ``_batch()``; the
    JAX step under bf16_act on a 1-device and a 2-device mesh (loss,
    gradient); the port's step in one process under bf16_act and at
    highest on the whole batch."""
    from real_time_self_adaptive_deep_stereo_torch.cli.train import loss_and_grads
    from real_time_self_adaptive_deep_stereo_torch.ops import conv_precision
    from tests.test_torch_precision import _jax_precision, _madnet_params

    params = _madnet_params(1)
    state = tck.params_from_jax(params)
    batch = _batch()
    ranks = {}
    for precision in (MODE, "highest"):
        work = tmp_path_factory.mktemp(f"dp_{precision}")
        np.savez(work / "weights.npz", **{k: v.numpy() for k, v in state.items()})
        np.savez(work / "batch.npz", **batch)
        run_ranks("step", work, precision=precision)
        ranks[precision] = [dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)]
    model = j_net("MADNet", corr_mode="jnp")
    jax_runs = {}
    for n in (1, 2):
        with _jax_precision(MODE):
            mesh = j_make_mesh(n)
            _, opt1, loss1 = j_make_dp_train_step(model, mesh, lr=LR)(
                jax.tree_util.tree_map(lambda x: x.copy(), params), j_optim.adam_init(params),
                j_shard_batch(batch, j_batch_sharded(mesh)))
        m = tck.params_from_jax(jax.tree_util.tree_map(np.asarray, opt1.m))
        jax_runs[n] = {"loss": np.float32(loss1), "g": {k: 10.0 * v.numpy() for k, v in m.items()}}
    one = {}
    for p in (MODE, "highest"):
        with conv_precision(p):
            net = t_net("MADNet", device="cpu")
            net.load_state_dict(state)
            loss, grads = loss_and_grads(net, get_supervised_loss("mean_l1", multiScale=True,
                                                                  max_disp=t_train.MAX_DISP),
                                         {k: torch.from_numpy(v) for k, v in batch.items()})
        one[p] = {"loss": float(loss), "g": {n: g.numpy() for (n, _), g in zip(net.named_parameters(), grads)}}
    return {"ranks": ranks, "jax": jax_runs, "one": one}


def _dp_failures(dp_modes, precision):
    from tests.test_torch_spatial import MODE_GRAD_RTOL, MODE_LOSS_RTOL, mode_failures

    r0 = dp_modes["ranks"][precision][0]
    # the weights: a bias's gradient differs by the JAX package's bf16 sum
    # (ROADMAP.md section 3), as the port's at highest does
    names = sorted(n for n in dp_modes["jax"][1]["g"] if not n.endswith(".bias"))
    run = {"loss": r0["loss"], "g": {n: r0[f"g/{n}"] for n in names}}
    jx = dp_modes["jax"]
    return mode_failures(run, jx[2], jx[1], dp_modes["one"]["highest"], names, None, MODE_LOSS_RTOL, MODE_GRAD_RTOL)


def test_dp_step_under_bf16_act_matches_the_jax_step_on_two_devices(dp_modes):
    """The two ranks' step under bf16_act against the JAX
    ``make_dp_train_step`` on a 2-device mesh in the mode (bounds: the
    larger of the figure and the JAX package's drift from two devices to
    one; tests/test_torch_spatial.py::mode_failures): the loss within 1e-3
    relative (measured 4.3e-5), every weight's gradient within 1e-2 of the
    largest entry (measured 4.4e-3; the JAX package's drift 2.7e-3) and
    closer to the mode's gradient than to highest's at RANK_SHARE of the
    entries (measured 0.74; the ranks at highest 1.1e-5; highest's gradient
    the port's in one process, within 1e-5 of the JAX one). The biases are
    left out: the largest, of the last layers, differ by 5.9e-2 of the
    largest entry, as the port's at highest do, since the JAX package sums
    a bias's gradient in bf16 (its own drift there 2.1e-2;
    ``tests/test_torch_precision.py::test_bf16_bias_gradient_sums_in_fp32``).
    The ranks' weights and gradients bit for bit."""
    assert not _dp_failures(dp_modes, MODE)
    r0, r1 = dp_modes["ranks"][MODE]
    for key in r0:
        if key.startswith(("w/", "g/")) or key == "loss":
            np.testing.assert_array_equal(r0[key], r1[key], err_msg=f"the ranks differ in {key}")


def test_dp_mode_check_fails_the_ranks_at_highest(dp_modes):
    """The control: the ranks' step at highest fails the check's share."""
    failures = _dp_failures(dp_modes, "highest")
    assert any("share" in f for f in failures), failures


def test_dp_step_under_bf16_act_matches_one_process(dp_modes):
    """Against the port's step in one process under bf16_act on the whole
    batch: the loss within LOSS_RTOL (measured 0), the gradient within 1e-2
    of its largest entry (measured 4.4e-3: each rank's bf16 weight
    gradient is rounded before the ranks' sum; the JAX package's own drift
    from two devices to one is 2.7e-3 there, ``ROADMAP.md`` section 3)."""
    from tests.test_torch_spatial import MODE_GRAD_RTOL

    r0 = dp_modes["ranks"][MODE][0]
    one = dp_modes["one"][MODE]
    np.testing.assert_allclose(float(r0["loss"]), one["loss"], rtol=LOSS_RTOL)
    scale = max(float(np.abs(g).max()) for g in one["g"].values())
    err = max(float(np.abs(r0[f"g/{n}"] - g).max()) for n, g in one["g"].items())
    assert err <= MODE_GRAD_RTOL * scale, (err, scale)
