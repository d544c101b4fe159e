"""The port's offline training against the JAX package, on the CPU:
``augment`` and ``StereoDataset(augment=True)`` from the same seeds (every
gate of ``augment``; the shuffle, crop and augment draws in the JAX order),
the depthwise, separable and grouped convs and the channel shuffle
(forward and gradient within 1e-5 relative), and ``cli/train.py`` against
the JAX CLI at 32x48 from the same npz weights: step 0's loss within rtol
1e-4 with and without ``--augment``, the first step's gradient within 5e-4
of its largest entry, checkpoints every ``--ckptEvery`` (two kept), resume,
``--validationSet``, ``--decayStep``'s warning and ``--dataParallel`` on one
device."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch.cli import train as t_train
from real_time_self_adaptive_deep_stereo_torch.data import readers as tr
from real_time_self_adaptive_deep_stereo_torch.ops import conv as tc
from real_time_self_adaptive_deep_stereo_torch.utils import checkpoint as tck
from real_time_self_adaptive_deep_stereo_tpu.cli import train as j_train
from real_time_self_adaptive_deep_stereo_tpu.data import readers as jr
from real_time_self_adaptive_deep_stereo_tpu.ops import conv as jc
from tests.test_torch_cli import jax_weights, parser_surface, run_cli, write_tiny_dataset

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's runs: at these sizes more threads
    only contend with the other test workers' (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CROP = (32, 48)
AUG_ATOL = 1e-4  # on the 0..255 scale (the same numpy arithmetic: bit for bit in practice)
CONV_RTOL = 1e-5  # of the largest entry, fp32
GRAD_RTOL = 5e-4  # a step's gradient, of its largest entry (chip_smoke.STEP_RTOL)

# seeds whose four 'active' draws gate: every op, none, each alone, and the pairs
AUGMENT_SEEDS = {"all": 0, "none": 45, "brightness": 3, "contrast": 1, "hue": 4,
                 "brightness+hue": 2, "contrast+hue": 12, "brightness+contrast": 20}


@pytest.mark.parametrize("gates", list(AUGMENT_SEEDS))
def test_augment_matches_jax(gates):
    seed = AUGMENT_SEEDS[gates]
    active = np.random.default_rng(seed).random(4)[1:] <= 0.5
    ops = ("brightness", "contrast", "hue")
    assert list(active) == [gates == "all" or op in gates.split("+") for op in ops]
    r = np.random.default_rng(100 + seed)
    left = (r.random((CROP[0], CROP[1], 3)) * 255).astype(np.float32)
    right = np.roll(left, -3, axis=1)
    left[0, :4] = [0.0, 0.0, 0.0]  # grey and black pixels: s == 0 and v == 0 in the HSV round trip
    left[1, :4] = [128.0, 128.0, 128.0]
    g_rng, w_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    got, want = tr.augment(left, right, g_rng), jr.augment(left, right, w_rng)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=AUG_ATOL)
    assert g_rng.random() == w_rng.random()  # the same number of draws


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    return {"list": write_tiny_dataset(tmp), "weights": jax_weights(tmp, "MADNet"), "tmp": tmp}


def test_dataset_with_augment_matches_jax(data):
    """Two epochs, batch 2, random crops: shuffle, crop and augment all
    draw from one rng, in the JAX order, so every batch agrees."""
    kw = dict(batch_size=2, crop_shape=CROP, num_epochs=2, augment=True, is_training=True, shuffle=True,
              seed=5)
    got, want = list(tr.StereoDataset(data["list"], **kw)), list(jr.StereoDataset(data["list"], **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"left", "right", "target"}
        for k in g:
            assert g[k].shape == w[k].shape == ((2, *CROP, 3) if k != "target" else (2, *CROP, 1))
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=AUG_ATOL)


def _conv_case(op, r):
    """(JAX params, JAX call, the port's call on torch tensors) of one op."""
    def arr(*shape):
        return r.standard_normal(shape).astype(np.float32)

    if op == "depthwise":
        p = {"w": arr(3, 3, 6, 2), "b": arr(12)}
        return p, lambda p, x: jc.depthwise_conv(p, x, strides=2), lambda t, x: tc.depthwise_conv(
            x, t["weight"], t["bias"], 2)
    if op == "separable":
        p = {"depthwise": {"w": arr(3, 3, 6, 2), "b": arr(12)}, "pointwise": {"w": arr(1, 1, 12, 5), "b": arr(5)}}
        return p, lambda p, x: jc.separable_conv2d(p, x, strides=2), lambda t, x: tc.separable_conv2d(
            x, t["depthwise.weight"], t["depthwise.bias"], t["pointwise.weight"], t["pointwise.bias"], 2)
    if op == "grouped":
        p = {"w": arr(3, 3, 2, 9), "b": arr(9)}
        return p, lambda p, x: jc.grouped_conv2d(p, x, num_groups=3, strides=1), lambda t, x: tc.grouped_conv2d(
            x, t["weight"], t["bias"], 3, 1)
    p = {"w": arr(1, 1, 6, 6), "b": arr(6)}  # a 1x1 conv, so that the shuffle has a gradient to carry
    return p, lambda p, x: jc.channel_shuffle_inside_group(jc.conv2d(p, x), 3), \
        lambda t, x: tc.channel_shuffle_inside_group(tc.conv2d(x, t["weight"], t["bias"]), 3)


@pytest.mark.parametrize("op", ["depthwise", "separable", "grouped", "shuffle"])
def test_conv_ops_match_jax(op):
    """Forward, and the gradient of a seeded projection of the output with
    respect to the input and every weight, against JAX in fp32."""
    r = np.random.default_rng(21)
    params, j_fn, t_fn = _conv_case(op, r)
    x = r.standard_normal((2, 11, 13, 6)).astype(np.float32)
    want, vjp = jax.vjp(j_fn, params, jnp.asarray(x))
    cot = r.standard_normal(want.shape).astype(np.float32)
    want_dp, want_dx = vjp(jnp.asarray(cot))

    state = {k: v.requires_grad_() for k, v in tck.params_from_jax(params).items()}
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    got = t_fn(state, xt)
    got.backward(torch.from_numpy(cot).permute(0, 3, 1, 2))
    got_nhwc = got.detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got_nhwc, np.asarray(want), rtol=0, atol=CONV_RTOL * float(np.abs(want).max()))
    dx = xt.grad.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(dx, np.asarray(want_dx), rtol=0, atol=CONV_RTOL * float(np.abs(want_dx).max()))
    got_dp = tck.flatten_params(tck.params_to_jax({k: v.grad for k, v in state.items()}))
    want_flat = tck.flatten_params(jax.tree_util.tree_map(np.asarray, want_dp))
    assert set(got_dp) == set(want_flat)
    for k, w in want_flat.items():
        np.testing.assert_allclose(got_dp[k], w, rtol=0, atol=CONV_RTOL * float(np.abs(w).max()), err_msg=k)


def train_argv(data, out, extra=()):
    return ["--trainingSet", data["list"], "-o", str(out), "--weights", data["weights"], "--modelName", "MADNet",
            "--imageShape", str(CROP[0]), str(CROP[1]), "--batchSize", "2", "--numEpochs", "2", *extra]


def run_train(module, argv, **kw):
    args = module.build_argparser().parse_args(argv)
    os.makedirs(args.output, exist_ok=True)
    return module.main(args, **kw)


@pytest.mark.parametrize("augment", [False, True])
def test_train_step0_loss_matches_jax(data, augment, monkeypatch):
    """Without --augment both CLIs decode through their C++ loaders, whose
    crops draw from per-sample seeds; with it through their Python
    backends, which draw from one rng. Where either loader does not build,
    both are held to their Python backends."""
    from real_time_self_adaptive_deep_stereo_torch.runtime import native as t_native
    from real_time_self_adaptive_deep_stereo_tpu.runtime import native as j_native

    if not (t_native.available() and j_native.available()):
        monkeypatch.setattr(t_native, "available", lambda: False)
        monkeypatch.setattr(j_native, "available", lambda: False)
    extra = ["--maxSteps", "1", "--seed", "3"] + (["--augment"] if augment else [])
    want = run_train(j_train, train_argv(data, data["tmp"] / f"jax_{augment}", extra + ["--corrMode", "jnp"]))
    got = run_train(t_train, train_argv(data, data["tmp"] / f"port_{augment}", extra), device="cpu")
    assert got["steps"] == want["steps"] == 1
    assert np.isfinite(got["final_loss"])
    np.testing.assert_allclose(got["final_loss"], want["final_loss"], rtol=1e-4)
    # the checkpoint after the step: the JAX layout, close to the JAX CLI's
    g = tck.flatten_params(tck.load_params(str(data["tmp"] / f"port_{augment}" / "weights-1.npz")))
    w = tck.flatten_params(tck.load_params(str(data["tmp"] / f"jax_{augment}" / "weights-1.npz")))
    assert set(g) == set(w)
    # Adam's first step moves each weight by about lr where its gradient is not ~0
    assert max(float(np.abs(g[k] - w[k]).max()) for k in w) < 1e-4


def test_train_first_step_gradient_matches_jax(data):
    """The gradient of the first batch (--augment, seed 3) at the npz
    weights: the port's loss_and_grads against jax.value_and_grad of the
    JAX CLI's loss."""
    from real_time_self_adaptive_deep_stereo_torch.losses import get_supervised_loss as t_loss
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net as t_net
    from real_time_self_adaptive_deep_stereo_tpu.losses import get_supervised_loss as j_loss
    from real_time_self_adaptive_deep_stereo_tpu.models import get_stereo_net as j_net
    from real_time_self_adaptive_deep_stereo_tpu.utils.checkpoint import load_params

    kw = dict(batch_size=2, crop_shape=CROP, num_epochs=1, augment=True, is_training=True, shuffle=True, seed=3)
    t_batch = next(iter(tr.StereoDataset(data["list"], **kw)))
    j_batch = next(iter(jr.StereoDataset(data["list"], **kw)))
    for k in j_batch:
        np.testing.assert_array_equal(t_batch[k], j_batch[k])

    jm = j_net("MADNet", corr_mode="jnp")
    params = load_params(data["weights"])
    j_fn = j_loss("mean_l1", multiScale=True, max_disp=j_train.MAX_DISP)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: j_fn(jm.forward(p, j_batch["left"], j_batch["right"])["disparities"], j_batch)))(params)

    tm = t_net("MADNet", device="cpu")
    tm.load_state_dict(tck.params_from_jax(params))
    batch = {k: torch.from_numpy(v) for k, v in t_batch.items()}
    loss, grads = t_train.loss_and_grads(tm, t_loss("mean_l1", multiScale=True, max_disp=t_train.MAX_DISP), batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    names = [n for n, _ in tm.named_parameters()]
    got = tck.flatten_params(tck.params_to_jax(dict(zip(names, grads))))
    want = tck.flatten_params(jax.tree_util.tree_map(np.asarray, want))
    assert set(got) == set(want)
    scale = max(float(np.abs(w).max()) for w in want.values())
    err = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    assert scale > 0 and err <= GRAD_RTOL * scale, (err, scale)


def test_train_checkpoints_resume_and_validation(data, capsys):
    """--ckptEvery 2 over 3 steps keeps weights-2 and weights-3; a second
    run resumes from step 3 and stops 3 steps later, keeping the newest
    two; --validationSet adds the EPE/bad3 of a batch to the log line."""
    out = data["tmp"] / "resume"
    argv = train_argv(data, out, ["--maxSteps", "3", "--ckptEvery", "2", "--validationSet", data["list"]])
    res = run_train(t_train, argv, device="cpu")
    assert res["steps"] == 3 and np.isfinite(res["final_loss"])
    assert sorted(os.listdir(out)) == ["weights-2.npz", "weights-3.npz"]
    log = capsys.readouterr().out
    assert "Restored?: True from step 0" in log and "\tval EPE:" in log and "All Done" in log
    res2 = run_train(t_train, argv, device="cpu")
    assert res2["steps"] == 6
    assert sorted(os.listdir(out)) == ["weights-4.npz", "weights-6.npz"]
    assert "Restored?: True from step 3" in capsys.readouterr().out


def test_train_decay_step_warns_and_data_parallel_runs_on_one_device(data, capsys):
    out = data["tmp"] / "decay"
    res = run_train(t_train, train_argv(data, out, ["--maxSteps", "1", "--decayStep", "10", "--dataParallel"]),
                    device="cpu")
    assert res["steps"] == 1
    assert "WARNING: --decayStep has no effect" in capsys.readouterr().out


def test_train_argparser_matches_jax():
    """Same flags, types and defaults; only --corrMode's choices differ."""
    port, ref = t_train.build_argparser(), j_train.build_argparser()
    assert parser_surface(port) == parser_surface(ref)
    corr = {a.dest: a for a in port._actions}["corrMode"]
    assert corr.choices == ["auto", "cuda", "torch"] and corr.default == "auto"


def test_train_main_needs_the_gpu_unless_asked(data, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cli(t_train, ["--trainingSet", data["list"]], tmp_path / "gpu")


def test_reference_json_covers_phase10(tmp_path):
    """tests/fixtures/torch_cli_reference.json has a row for every run that
    chip_smoke.py phase 10 holds against it, at the flags it states, over
    the frames it writes (the continual lists with a proxy column)."""
    import json

    import chip_smoke
    from tools import torch_cli_reference

    rows = json.loads(chip_smoke.CLI_REFERENCE.read_text())["phase10_runs"]
    assert set(rows) == set(chip_smoke.PHASE10_REFERENCE_RUNS)
    for name, (cli, scenes, _) in chip_smoke.PHASE10_REFERENCE_RUNS.items():
        row = rows[name]
        assert row["cli"] == cli and row["scenes"] == list(chip_smoke.CLI_SCENES[scenes])
        assert row["frames"] == chip_smoke.CLI_FRAMES == len(row["d1"]) == len(row["epe"])
        assert row["argv"] == torch_cli_reference.portable(torch_cli_reference.phase10_argv(name, "LIST", "OUT"))
        assert not any(os.path.isabs(a) for a in row["argv"])
        assert np.isfinite(row["avg_d1"]) and np.isfinite(row["avg_epe"])
        np.testing.assert_allclose(row["avg_d1"], np.mean(row["d1"]), atol=1e-3)  # series at 3 decimals
    assert rows["train_evaluate_scene"]["steps"] == chip_smoke.TRAIN_STEPS
    path = chip_smoke.write_cli_list(tmp_path, ("scene2", "scene3"), 4, proxy=True)
    left, right, gt, proxy = tr.read_list_file(path)
    assert proxy == gt and len(left) == 4 and all(os.path.exists(p) for p in gt)
