"""The port's live demo (``cli/demo.py``) against the JAX package's, on the
CPU, headless (``--camera folder --display none``), on the tiny dataset of
``tests/test_torch_cli.py`` at 64x96: MADNet, MAD with Adam, SEQUENTIAL,
3 frames, fused and host. Every frame yields a PNG, numbered as the JAX
demo numbers them, and each PNG agrees with the JAX demo's within one fp16
ulp of the disparity (the fused session hands out an fp16 disparity) plus
the PNG's 1/256 step. Also the argparser, the rescale-and-crop stage
against the JAX demo's numpy one, an error in the frame loop, the GPU
default, ``colorize_disparity`` without matplotlib, and the demo's modules
importing without JAX."""

import os
import queue
import subprocess
import sys

import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch.cli import demo as t_demo
from real_time_self_adaptive_deep_stereo_torch.data.png import read_png
from real_time_self_adaptive_deep_stereo_tpu.cli import demo as j_demo
from tests.test_torch_cli import jax_weights, parser_surface, write_tiny_dataset

H, W = 64, 96
SESSIONS = ("fused", "host")


def demo_argv(data, out, session):
    return ["--weights", data["weights"], "--blockConfig", "block_config/MadNet_full.json", "--mode", "MAD",
            "--sampleMode", "SEQUENTIAL", "--camera", "folder", "--list", data["list"], "--display", "none",
            "--outDir", str(out), "--imageShape", str(H), str(W), "--cropShape", str(H), str(W),
            "--maxFrames", "3", "--seed", "0", "--sessionMode", session]


def read_disparities(out):
    return {f: read_png(os.path.join(str(out), f)).astype(np.float64) / 256.0 for f in sorted(os.listdir(out))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One run of each demo in each session mode: {(package, session): the
    PNGs' disparities by file name, and the returned FPS}."""
    tmp = tmp_path_factory.mktemp("demo")
    data = {"list": write_tiny_dataset(tmp), "weights": jax_weights(tmp, "MADNet")}
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # at this size more threads only contend with the other workers'
    try:
        out = {}
        for session in SESSIONS:
            for name, module, kw in (("port", t_demo, {"device": "cpu"}), ("jax", j_demo, {})):
                d = tmp / f"{name}_{session}"
                fps = module.main(module.build_argparser().parse_args(demo_argv(data, d, session)), **kw)
                out[name, session] = (read_disparities(d), fps)
    finally:
        torch.set_num_threads(n)
    return out


def assert_within_fp16_ulp(got, want, what):
    """|got - want| within one fp16 ulp of the larger, plus the PNG's step."""
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.spacing(big.astype(np.float16)).astype(np.float64)
    err = np.abs(got - want) - (ulp + 1 / 256.0)
    assert err.max() <= 0, f"{what}: {np.abs(got - want).max()} beyond one fp16 ulp"


@pytest.mark.parametrize("session", SESSIONS)
def test_demo_matches_jax(runs, session):
    (got, fps), (want, jax_fps) = runs["port", session], runs["jax", session]
    assert fps > 0 and jax_fps > 0
    assert list(got) == list(want) == [f"disparity_{i:05d}.png" for i in (1, 2, 3)]
    for name in want:
        assert got[name].shape == (H, W) and np.isfinite(got[name]).all()
        assert_within_fp16_ulp(got[name], want[name], f"{session} {name}")


def test_demo_fused_matches_host(runs):
    """The same Adam trajectory: the fused session's fp16 disparity within
    one fp16 ulp of the host session's float32 one."""
    fused, host = runs["port", "fused"][0], runs["port", "host"][0]
    for name in host:
        assert_within_fp16_ulp(fused[name], host[name], name)


def test_demo_argparser_matches_jax():
    assert parser_surface(t_demo.build_argparser()) == parser_surface(j_demo.build_argparser())


def test_demo_needs_the_gpu_unless_asked(tmp_path):
    args = t_demo.build_argparser().parse_args(["--weights", "w.npz", "--blockConfig", "x.json"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_demo.main(args)


def test_demo_rescale_and_crop_match_the_jax_numpy_stage():
    """The rescale to --imageShape and the crop to --cropShape, which the
    port runs on the session's device, against the JAX demo's numpy stage."""
    from real_time_self_adaptive_deep_stereo_tpu.data import readers as jr

    r = np.random.default_rng(3)
    pair = (r.random((2, 45, 70, 3)) * 255).astype(np.float32)
    session = type("S", (), {"engine": type("E", (), {"device": torch.device("cpu")})()})()
    for image_shape, crop_shape in (((30, 52), (24, 40)), ((60, 80), (50, 96)), (None, (32, 64)), ((45, 70), None)):
        worker = t_demo.RealTimeStereo(queue.Queue(), session, image_shape=image_shape, crop_shape=crop_shape)
        got = torch.cat(worker._prepare(pair)).numpy()
        for k in range(2):
            want = pair[k]
            if image_shape:
                want = jr.resize_image_np(want, *image_shape)
            if crop_shape:
                want = jr.center_crop_or_pad(want, *crop_shape)
            np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-4)


def test_demo_loop_hands_an_error_to_main():
    class Broken:
        engine = type("E", (), {"device": torch.device("cpu")})()

        def step(self, frame):
            raise ValueError("broken session")

    q = queue.Queue()
    q.put(np.zeros((2, 8, 8, 3), np.float32))
    worker = t_demo.RealTimeStereo(q, Broken(), image_shape=None, crop_shape=None, display="none")
    worker.start()
    worker.join(timeout=30)
    assert not worker.is_alive()
    assert isinstance(worker.error, ValueError) and not worker.frame_times


def test_colorize_disparity_refuses_other_maps_without_matplotlib(monkeypatch):
    from real_time_self_adaptive_deep_stereo_torch.utils.visual import colorize_disparity

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    d = np.random.default_rng(0).random((6, 9)) * 40
    assert colorize_disparity(d).shape == (6, 9, 3)  # jet is built in
    with pytest.raises(ValueError, match="'viridis' needs matplotlib"):
        colorize_disparity(d, cmap="viridis")


def test_demo_modules_import_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import real_time_self_adaptive_deep_stereo_torch.cli.demo, "
        "real_time_self_adaptive_deep_stereo_torch.data.grabber, "
        "real_time_self_adaptive_deep_stereo_torch.runtime.native, "
        "real_time_self_adaptive_deep_stereo_torch.utils.profiling\n"
        "assert not any(m.startswith('real_time_self_adaptive_deep_stereo_tpu') for m in sys.modules)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120)


def test_reference_json_covers_phase11():
    """tests/fixtures/torch_cli_reference.json has the JAX demo's row that
    chip_smoke.py phase 11 holds the port's demo against, over its frames,
    at the flags it states."""
    import json

    import chip_smoke
    from tools import torch_cli_reference

    doc = json.loads(chip_smoke.CLI_REFERENCE.read_text())
    assert set(doc["demo_runs"]) == set(chip_smoke.DEMO_REFERENCE_RUNS)
    for name, row in doc["demo_runs"].items():
        assert row["cli"] == "demo" and row["session"] == "host"
        assert row["scenes"] == list(chip_smoke.CLI_SCENES["scene"])
        assert row["frames"] == chip_smoke.DEMO_FRAMES == len(row["epe"]) == len(row["d1"])
        assert row["argv"] == torch_cli_reference.portable(torch_cli_reference.demo_argv(name, "LIST", "OUT"))
        assert not any(os.path.isabs(a) for a in row["argv"])
        np.testing.assert_allclose(row["avg_d1"], np.mean(row["d1"]), rtol=1e-9)
        # the starting points of phase 11's median: seed 0 is the row itself
        assert [r["seed"] for r in row["seeds"]] == list(range(chip_smoke.DEMO_SEEDS))
        assert {k: row["seeds"][0][k] for k in ("epe", "d1")} == {k: row[k] for k in ("epe", "d1")}
        for r in row["seeds"]:
            assert r["frames"] == chip_smoke.DEMO_FRAMES == len(r["epe"]) == len(r["d1"])
            np.testing.assert_allclose([r["avg_epe"], r["avg_d1"]], [np.mean(r["epe"]), np.mean(r["d1"])], rtol=1e-9)


def test_perturbed_weights_move_each_weight_at_most_one_ulp(tmp_path):
    """chip_smoke.perturbed_weights, the starting points of phase 11 and of
    the JAX rows: seed 0 is the fixture's file; another seed moves each
    float32 weight by one ulp or none, the same for the same seed."""
    import chip_smoke

    assert chip_smoke.perturbed_weights(0, tmp_path) == str(chip_smoke.CLI_WEIGHTS)
    with np.load(chip_smoke.CLI_WEIGHTS) as z:
        base = {k: z[k] for k in z.files}
    moved = []
    for seed in (1, 2):
        (tmp_path / str(seed)).mkdir()
        with np.load(chip_smoke.perturbed_weights(seed, tmp_path / str(seed))) as z:
            got = {k: z[k] for k in z.files}
        assert got.keys() == base.keys()
        for k, w in base.items():
            assert got[k].dtype == w.dtype == np.float32 and got[k].shape == w.shape
            up, down = np.nextafter(w, np.float32(np.inf)), np.nextafter(w, np.float32(-np.inf))
            assert np.all((got[k] == w) | (got[k] == up) | (got[k] == down)), k
        moved.append(np.concatenate([(got[k] != base[k]).ravel() for k in sorted(base)]))
        assert 0.5 < moved[-1].mean() < 0.8
    assert (moved[0] != moved[1]).any()
    with np.load(chip_smoke.perturbed_weights(1, tmp_path)) as z:
        again = np.concatenate([(z[k] != base[k]).ravel() for k in sorted(base)])
    np.testing.assert_array_equal(again, moved[0])


def test_demo_png_metrics_are_the_engines(tmp_path):
    """chip_smoke.demo_png_metrics, which phase 11 and the JAX row use, is
    the engine's d1_metric on the PNGs' disparities."""
    import chip_smoke
    from real_time_self_adaptive_deep_stereo_torch.adapt.engine import d1_metric
    from real_time_self_adaptive_deep_stereo_torch.utils.visual import save_disparity_png

    lst = chip_smoke.write_cli_list(tmp_path, ("scene2", "scene3"), 2)
    out = tmp_path / "out"
    r = np.random.default_rng(1)
    disps = [(r.random((chip_smoke.H, chip_smoke.W)) * 120).astype(np.float32) for _ in range(2)]
    for i, d in enumerate(disps):
        save_disparity_png(str(out / f"disparity_{i + 1:05d}.png"), d)
    names, epe, d1 = chip_smoke.demo_png_metrics(out, lst)
    assert names == ["disparity_00001.png", "disparity_00002.png"]
    for i, scene in enumerate(("scene2", "scene3")):
        gt = read_png(os.path.join(chip_smoke.FIXTURE_DIR, f"{scene}_gt.png")).astype(np.float32) / 256.0
        disp = read_png(str(out / names[i])).astype(np.float32) / 256.0
        want_epe, want_d1 = d1_metric(torch.from_numpy(disp)[None, ..., None], torch.from_numpy(gt)[None, ..., None])
        np.testing.assert_allclose([epe[i], d1[i]], [float(want_epe), float(want_d1)], rtol=1e-5)
