"""The port's tools (``tools/torch_validate_adaptation.py``,
``tools/torch_probe_latency.py``, ``tools/torch_bench_offline.py``) on the
CPU at 64x128 (MADNet needs multiples of 64), against the JAX package's
tools (``tools/validate_adaptation.py``), loaded by path.

Tolerances:
- ``make_sequence`` to 1e-4 absolute on 0-255 images (cv2's box filter and
  numpy's sum the 25 terms in other orders);
- ``pretrain`` from the same JAX weights over 3 steps: each step's loss to
  1e-4 relative, every weight within 3·lr absolute (each Adam step moves a
  weight by up to lr, and Adam magnifies the float32 noise of near-zero
  gradients into whole steps, so that is all that two float32 runs share);
- ``run_mode`` NONE and FULL over 6 frames, MAD under SEQUENTIAL against a
  JAX fused session built as ``run_mode`` builds it: per-frame ``epe``,
  ``d1`` and ``loss`` to 1e-4 relative;
- the probe's variants hand back the session's own disparity bit for bit,
  and an f16 session's disparities lie within one f16 ulp of an f32
  session's on the same frames;
- ``bench_offline``: batch 2 within 1e-4 of the largest of batch 1 at
  ``highest``, its operation counts, and the bound by mode.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import params_from_jax

ROOT = Path(__file__).resolve().parent.parent
H, W = 64, 128
FRAMES = 6
LR = 1e-4  # run_mode's, the JAX tool's --lr
PRETRAIN_LR = 3e-4  # pretrain's default in both tools
PRETRAIN_STEPS = 3
TRAJ_RTOL = 1e-4
PORT_TOOLS = ("torch_validate_adaptation", "torch_probe_latency", "torch_bench_offline", "torch_kitti_eval")


def _load(name):
    spec = importlib.util.spec_from_file_location(f"tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jtool = _load("validate_adaptation")
tval = _load("torch_validate_adaptation")
tprobe = _load("torch_probe_latency")
tbench = _load("torch_bench_offline")


@pytest.fixture(scope="module")
def one_thread():
    """One intra-op thread: the CPU's threaded conv backward sums in an
    order that varies from run to run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_pretrain(steps):
    """The JAX tool's ``pretrain`` with each step's loss recorded: its
    jitted step wrapped where ``jax.jit`` makes it."""
    losses, jit = [], jax.jit

    def recording(fn, **kw):
        jitted = jit(fn, **kw)

        def step(*a):
            out = jitted(*a)
            losses.append(float(out[2]))
            return out

        return step

    jax.jit = recording
    try:
        params = jtool.pretrain(H, W, steps=steps)
    finally:
        jax.jit = jit
    return params, np.asarray(losses)


@pytest.fixture(scope="module")
def pretrained(one_thread):
    """Both pretrains from the JAX tool's own initial weights."""
    from real_time_self_adaptive_deep_stereo_tpu.models import get_stereo_net

    init = get_stereo_net("MADNet").init(jax.random.PRNGKey(0))
    port, port_losses = tval.pretrain(H, W, steps=PRETRAIN_STEPS, params=params_from_jax(init), device="cpu")
    ref, ref_losses = jax_pretrain(PRETRAIN_STEPS)
    return port, port_losses, ref, ref_losses


@pytest.fixture(scope="module")
def scene():
    return tval.make_sequence(H, W, FRAMES, seed=7, d_bg=8.0, d_fg=20.0)


def test_make_sequence_matches_the_jax_tool_with_cv2():
    pytest.importorskip("cv2")
    for args in ((H, W, 3, 7, 8.0, 20.0), (H, W, 8, 100, 4.0, 10.0)):
        for got, want in zip(tval.make_sequence(*args), jtool.make_sequence(*args)):
            for g, w in zip(got, want):
                assert g.dtype == np.float32 and g.shape == w.shape
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


def test_box5_is_cv2_filter2d_with_reflect_101():
    cv2 = pytest.importorskip("cv2")
    a = np.random.default_rng(3).random((9, 13)).astype(np.float32)
    np.testing.assert_allclose(tval.box5(a), cv2.filter2D(a, -1, np.ones((5, 5), np.float32) / 25),
                               rtol=0, atol=1e-6)


def test_pretrain_matches_the_jax_tool(pretrained):
    port, port_losses, ref, ref_losses = pretrained
    assert port_losses.shape == ref_losses.shape == (PRETRAIN_STEPS,)
    np.testing.assert_allclose(port_losses, ref_losses, rtol=1e-4)
    want = params_from_jax(ref)
    assert set(port) == set(want)
    worst = max(float((port[k] - want[k]).abs().max()) for k in want)
    assert worst <= PRETRAIN_STEPS * PRETRAIN_LR, worst


@pytest.mark.parametrize("mode", ["NONE", "FULL"])
def test_run_mode_matches_the_jax_tool(pretrained, scene, mode):
    ref_params = pretrained[2]
    got = tval.run_mode(mode, scene, params_from_jax(ref_params), H, W, LR, device="cpu")
    want = jtool.run_mode(mode, scene, ref_params, H, W, LR)
    assert got["steps"] == want["steps"] == FRAMES
    for k in ("epe", "d1", "loss"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=TRAJ_RTOL, err_msg=k)


def test_run_mode_mad_sequential_matches_the_jax_session(pretrained, scene):
    """MAD under SEQUENTIAL (PROBABILITY draws from other generators in the
    two packages) against a JAX fused session built as the JAX tool's
    ``run_mode`` builds it."""
    import jax.numpy as jnp

    from real_time_self_adaptive_deep_stereo_tpu.adapt import AdaptationEngine, load_block_config, make_blocks
    from real_time_self_adaptive_deep_stereo_tpu.adapt.fused import FusedOnlineSession
    from real_time_self_adaptive_deep_stereo_tpu.models import get_stereo_net

    ref_params = pretrained[2]
    got = tval.run_mode("MAD", scene, params_from_jax(ref_params), H, W, LR, sample_mode="SEQUENTIAL",
                        device="cpu")
    model = get_stereo_net("MADNet", bulkhead=True)
    blocks = make_blocks(load_block_config(str(tval.BLOCK_CONFIG)), model.layer_to_path)
    sess = FusedOnlineSession(
        AdaptationEngine(model, blocks, lr=LR), jax.tree_util.tree_map(lambda x: x.copy(), ref_params),
        mode="MAD", sample_mode="SEQUENTIAL", ssim_th=10.0, max_steps=len(scene) + 4, seed=0,
    )
    for left, right, gt in scene:
        sess.step({"left": jnp.asarray(left[None]), "right": jnp.asarray(right[None]),
                   "target": jnp.asarray(gt[None, ..., None])})
    want = sess.finalize()
    np.testing.assert_array_equal(got["fetch_counter"], np.asarray(want["fetch_counter"]))
    for k in ("epe", "d1", "loss"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=TRAJ_RTOL, err_msg=k)


def test_validate_rows_and_failures():
    st = {"epe": np.arange(10.0), "d1": np.arange(10.0) * 2, "loss": np.ones(10)}
    row = tval.summarize("MAD", st)
    assert (row["epe_first"], row["epe_last"], row["d1_last"]) == (0.5, 8.5, 17.0)
    rows = [dict(row, mode="NONE", epe_last=5.0), dict(row, mode="MAD", epe_last=4.0),
            dict(row, mode="FULL", epe_last=5.0)]
    assert [line.split()[0] for line in tval.failures(rows)] == ["FULL"]


def test_probe_variants_hand_back_the_sessions_own_disparity(one_thread):
    n = 3
    outs = {}
    for name, dtype in (("blocking_f32", None), ("async_f32", None), ("async_f16", torch.float16),
                        ("pipelined_f16", torch.float16)):
        sess, frames = tprobe.build_session(dtype, H, W, n, 0, device="cpu")
        lats, enq, outs[name] = tprobe.run_variant(name, sess, frames, n)
        assert len(lats) == len(enq) == len(outs[name]) == n
        assert all(o.dtype == (np.float16 if dtype else np.float32) and o.shape == (1, H, W, 1)
                   for o in outs[name])
    for a, b in zip(outs["blocking_f32"], outs["async_f32"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for name in ("async_f16", "pipelined_f16"):
        for i, (half, full) in enumerate(zip(outs[name], outs["async_f32"])):
            ulp = np.spacing(np.abs(full).astype(np.float16)).astype(np.float32)
            err = np.abs(half.astype(np.float32) - full)
            assert (err <= ulp).all(), (name, i, float(err.max()))
    sess, frames = tprobe.build_session(None, H, W, n, 0, device="cpu")
    with pytest.raises(ValueError, match="needs the card"):
        tprobe.run_variant("poll_f32", sess, frames, n)


def test_probe_on_the_cpu_skips_what_needs_the_card(one_thread):
    lines = []
    recs = tprobe.probe(H, W, 2, 1, device="cpu", log=lines.append)
    assert [r["variant"] for r in recs] == list(tprobe.VARIANTS)
    assert recs[2] == {"variant": "poll_f32", "skipped": "CUDA only"}
    assert recs[-1]["staleness_frames"] == 1 and len(lines) == len(recs)


@pytest.mark.parametrize("model", ["MADNet", "Dispnet"])
def test_bench_offline_batch_two_is_two_batch_ones(model, one_thread):
    recs = tbench.run(model, (1, 2), iters=1, passes=1, h=H, w=W, precision="highest", device="cpu",
                      log=lambda _: None)
    assert [r["batch"] for r in recs] == [1, 2]
    assert recs[1]["batch_err"] == recs[1]["batch_max_rel_err"] <= 1e-4 == recs[1]["batch_err_bound"]
    assert recs[1]["mfu_vs_h100_bf16_peak"] is None
    # the correlations' operations: MADNet's five radius-2 calls, DispNet's one at radius 40
    levels = [(192, 64), (128, 32), (96, 16), (64, 8), (32, 4)] if model == "MADNet" else [(128, 4)]
    k = 5 if model == "MADNet" else 81
    want = sum(2 * c * k * (H // f) * (W // f) for c, f in levels)
    assert recs[0]["corr_tflop_per_frame"] * 1e12 == pytest.approx(want)
    assert recs[0]["conv_tflop_per_frame"] == recs[1]["conv_tflop_per_frame"] > 0


def test_bench_offline_batch_error_by_mode():
    ref = np.array([[10.0, 0.5], [100.0, -3.0]], np.float32)
    out = np.stack([ref, ref + np.float32(0.01)])
    err, bound, kind = tbench.batch_error(out, ref, "highest")
    assert (bound, kind) == (1e-4, "max of the largest") and err == pytest.approx(0.01 / 100, rel=1e-3)
    med, bound, kind = tbench.batch_error(out, ref, "bf16_act")
    # the first frame's four pixels 0 from batch 1's; the second's 1e-3, 1e-2, 1e-4, 3.3e-3 (by max(|d1|, 1))
    assert (bound, kind) == (0.05, "median relative") and med == pytest.approx(1e-4 / 2, rel=1e-3)


def test_the_port_tools_import_without_jax(tmp_path):
    """Each tool, and the port modules it imports when run, with ``jax``
    made unimportable; nothing of the JAX package is loaded. The KITTI
    runner builds its lists over ``chip_smoke.write_kitti_tree`` (--listOnly)
    and imports the TF1 fixture into its cache."""
    code = "\n".join([
        "import sys, importlib.util",
        "sys.modules['jax'] = None",
        f"sys.path.insert(0, {str(ROOT)!r})",
        "mods = {}",
        f"for name in {PORT_TOOLS!r}:",
        f"    spec = importlib.util.spec_from_file_location(name, {str(ROOT / 'tools')!r} + '/' + name + '.py')",
        "    mods[name] = importlib.util.module_from_spec(spec)",
        "    spec.loader.exec_module(mods[name])",
        "mods['torch_validate_adaptation'].pretrain(64, 64, steps=1, device='cpu')",
        "mods['torch_probe_latency'].build_session(None, 64, 64, 1, 0, device='cpu')",
        "mods['torch_bench_offline'].run('MADNet', (1,), 1, 1, 64, 64, device='cpu', log=lambda _: None)",
        "import chip_smoke",
        "kitti = mods['torch_kitti_eval']",
        f"tree = chip_smoke.write_kitti_tree({str(tmp_path / 'kitti')!r})",
        f"argv = chip_smoke.kitti_argv(tree, {str(tmp_path / 'out')!r}, True, ['--listOnly'])",
        "assert kitti.main(kitti.build_argparser().parse_args(argv), device='cpu') == []",
        f"kitti._resolve_weights({str(ROOT / 'tests' / 'fixtures' / 'tf1_madnet_tiny' / 'model.ckpt')!r}, "
        f"'MADNet', {str(tmp_path)!r})",
        "bad = [m for m in sys.modules if m.startswith(('jax', 'real_time_self_adaptive_deep_stereo_tpu'))",
        "       and sys.modules[m] is not None]",
        "assert not bad, bad",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]
