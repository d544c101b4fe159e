"""The port's ``adapt`` and ``evaluate`` CLIs against the JAX package's, on
the CPU, on the tiny synthetic dataset of ``tests/test_cli.py`` (written
here by the port's own ``write_png``): per-frame EPE and bad3 of
``series.csv`` within rtol 1e-4, the fetch counter and the resets equal,
the disparity PNGs within their 16-bit step. Also the port's fused session
against its host session, FIXED with two ids, ``--chunk``, the argparsers,
and the reference rows that ``chip_smoke.py`` phase 9 reads; and
``--modelName Dispnet`` over ``block_config/dispnet_full_6.json``, host
against JAX and fused against host."""

import json
import os
import sys

import numpy as np
import pytest

from real_time_self_adaptive_deep_stereo_torch.cli import adapt as t_adapt
from real_time_self_adaptive_deep_stereo_torch.cli import evaluate as t_evaluate
from real_time_self_adaptive_deep_stereo_torch.data.png import read_png, write_png
from real_time_self_adaptive_deep_stereo_tpu.cli import adapt as j_adapt
from real_time_self_adaptive_deep_stereo_tpu.cli import evaluate as j_evaluate

H, W = 64, 96
RTOL = 1e-4  # per-frame EPE and bad3, port against JAX (float32 sums in another order)
MAD_FLAGS = ["--blockConfig", "block_config/MadNet_full.json", "--mode", "MAD",
             "--sampleMode", "SEQUENTIAL", "--seed", "0", "--imageShape", str(H), str(W)]


def write_tiny_dataset(path) -> str:
    """tests/test_cli.py's three frames: a random texture rolled down a
    row a frame, right = left shifted by 3 px, ground truth 3 px."""
    rng = np.random.default_rng(7)
    lines = []
    base = (rng.random((H, W, 3)) * 255).astype(np.uint8)
    for i in range(3):
        left = np.roll(base, i, axis=0)
        right = np.roll(left, -3, axis=1)
        gt = np.full((H, W), 3.0, np.float32)
        lp, rp, gp = (str(path / f"{k}{i}.png") for k in ("l", "r", "g"))
        write_png(lp, left)
        write_png(rp, right)
        write_png(gp, (gt * 256).astype(np.uint16))
        lines.append(f"{lp},{rp},{gp},{gp}")
    lf = path / "list.csv"
    lf.write_text("\n".join(lines) + "\n")
    return str(lf)


def jax_weights(path, model_name: str) -> str:
    import jax

    from real_time_self_adaptive_deep_stereo_tpu.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_tpu.utils.checkpoint import save_params

    out = str(path / f"{model_name}.npz")
    save_params(out, get_stereo_net(model_name).init(jax.random.PRNGKey(1)))
    return out


def run_cli(module, argv, out, **main_kw):
    args = module.build_argparser().parse_args(["-o", str(out)] + argv)
    os.makedirs(args.output, exist_ok=True)
    return module.main(args, **main_kw)


def read_series(out):
    lines = open(os.path.join(str(out), "series.csv")).read().strip().splitlines()
    assert lines[0] == "Iteration,Time,EPE,bad3"
    rows = np.array([[float(v) for v in line.split(",")] for line in lines[1:]])
    return rows[:, 2], rows[:, 3]


def read_stats(out):
    """{first field: the rest} of stats.csv; the scores line has no name."""
    lines = open(os.path.join(str(out), "stats.csv")).read().strip().splitlines()
    assert lines[0] == "Metrics,cumulative,average"
    return {line.split(",")[0]: line.split(",")[1:] for line in lines[1:]}


def assert_series_close(got_out, want_out, rtol=RTOL):
    (ge, gb), (we, wb) = read_series(got_out), read_series(want_out)
    assert ge.shape == we.shape == (3,) and np.isfinite(ge).all()
    np.testing.assert_allclose(ge, we, rtol=rtol)
    np.testing.assert_allclose(gb, wb, rtol=rtol)
    gs, ws = read_stats(got_out), read_stats(want_out)
    assert gs["fetch_counter"] == ws["fetch_counter"]
    assert gs["#resets"] == ws["#resets"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    return {"list": write_tiny_dataset(tmp), "MADNet": jax_weights(tmp, "MADNet"), "tmp": tmp}


def madnet_argv(data, extra=()):
    return ["-l", data["list"], "--weights", data["MADNet"], "--modelName", "MADNet",
            *MAD_FLAGS, *extra]


@pytest.fixture(scope="module")
def jax_host_mad(data):
    out = data["tmp"] / "jax_host_mad"
    run_cli(j_adapt, madnet_argv(data, ["--corrMode", "jnp", "--sessionMode", "host",
                                        "--logDispStep", "2"]), out)
    return out


@pytest.fixture(scope="module")
def port_host_mad(data):
    out = data["tmp"] / "port_host_mad"
    run_cli(t_adapt, madnet_argv(data, ["--sessionMode", "host", "--logDispStep", "2"]), out,
            device="cpu")
    return out


def test_adapt_host_mad_matches_jax(port_host_mad, jax_host_mad):
    assert_series_close(port_host_mad, jax_host_mad)
    assert read_stats(port_host_mad)["fetch_counter"] == ["1", "1", "1", "0", "0"]


def test_adapt_disparity_pngs_match_jax(port_host_mad, jax_host_mad):
    """The --logDispStep PNGs of frames 0 and 2, decoded, as disparities:
    within RTOL of the largest, plus the 1/256 px of the 16-bit encoding."""
    import cv2

    for step in (0, 2):
        name = os.path.join("disparities", f"disparity_{step}.png")
        got = read_png(os.path.join(str(port_host_mad), name)).astype(np.float64) / 256
        want = cv2.imread(os.path.join(str(jax_host_mad), name), cv2.IMREAD_UNCHANGED) / 256.0
        assert got.shape == want.shape == (H, W) and want.max() > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * want.max() + 1 / 256)
    assert not os.path.exists(os.path.join(str(port_host_mad), "disparities", "disparity_1.png"))


def test_adapt_fused_matches_host(data, port_host_mad):
    out = data["tmp"] / "port_fused_mad"
    result = run_cli(t_adapt, madnet_argv(data, ["--sessionMode", "fused"]), out, device="cpu")
    assert_series_close(out, port_host_mad, rtol=1e-5)
    assert set(result) == {"fps", "avg_epe", "avg_bad3", "avg_d1", "resets"}
    np.testing.assert_allclose(result["avg_epe"], np.mean(read_series(port_host_mad)[0]), rtol=1e-5)


def test_adapt_fixed_two_ids_trains_the_listed_blocks(data, capsys):
    """FIXED with ids 1 and 3: the fused session trains exactly those, as
    the host session does, and says that --numBlocks is ignored."""
    ids = ["--sampleMode", "FIXED", "--fixedID", "1", "3"]
    host = data["tmp"] / "fixed_host"
    fused = data["tmp"] / "fixed_fused"
    run_cli(t_adapt, madnet_argv(data, ids + ["--sessionMode", "host"]), host, device="cpu")
    capsys.readouterr()
    run_cli(t_adapt, madnet_argv(data, ids + ["--sessionMode", "fused"]), fused, device="cpu")
    ids_shown = list(np.atleast_1d([1, 3]))  # as the JAX CLI prints them
    line = f"# FIXED: training the 2 listed block(s) {ids_shown}; --numBlocks 1 ignored"
    assert line in capsys.readouterr().out
    assert read_stats(fused)["fetch_counter"] == ["0", "3", "0", "3", "0"]
    assert_series_close(fused, host, rtol=1e-5)


def test_adapt_chunk_matches_per_frame(data):
    plain, chunked = data["tmp"] / "chunk1", data["tmp"] / "chunk2"
    run_cli(t_adapt, madnet_argv(data, ["--sessionMode", "fused"]), plain, device="cpu")
    run_cli(t_adapt, madnet_argv(data, ["--sessionMode", "fused", "--chunk", "2"]), chunked,
            device="cpu")
    assert_series_close(chunked, plain, rtol=1e-6)


def test_adapt_summary_goes_on_without_tensorboard(data, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)  # no TensorFlow: `import tensorflow` raises
    out = data["tmp"] / "summary"
    run_cli(t_adapt, madnet_argv(data, ["--mode", "NONE", "--summary", "--sessionMode", "fused"]),
            out, device="cpu")
    assert "tensorboard summaries unavailable (no tensorflow)" in capsys.readouterr().out
    assert len(read_series(out)[0]) == 3


def test_adapt_resumes_a_step_checkpoint_first(data, tmp_path):
    """A weights-N.npz in --output wins over --weights, as in JAX."""
    from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import (
        load_params,
        save_params,
    )

    zeros = {k: {kk: {kk2: np.zeros_like(v2) for kk2, v2 in vv.items()} for kk, vv in v.items()}
             for k, v in load_params(data["MADNet"]).items()}
    out = tmp_path / "resume"
    save_params(str(out / "weights-7.npz"), zeros)
    result = run_cli(t_adapt, madnet_argv(data, ["--mode", "NONE", "--sessionMode", "host"]),
                     out, device="cpu")
    np.testing.assert_allclose(result["avg_epe"], 3.0, rtol=1e-6)  # zero weights: disparity 0


def test_adapt_without_weights_exits(data, tmp_path):
    argv = ["-l", data["list"], "--weights", "", *MAD_FLAGS]
    with pytest.raises(SystemExit, match="could not restore weights from"):
        run_cli(t_adapt, argv, tmp_path / "none", device="cpu")


DN_FLAGS = ["--modelName", "Dispnet", "--blockConfig", "block_config/dispnet_full_6.json",
            "--mode", "MAD", "--sampleMode", "SEQUENTIAL", "--seed", "0",
            "--imageShape", str(H), str(W)]


@pytest.fixture(scope="module")
def dispnet_host(data):
    data["Dispnet"] = jax_weights(data["tmp"], "Dispnet")
    out = data["tmp"] / "dn_port_host"
    run_cli(t_adapt, dispnet_argv(data, ["--sessionMode", "host"]), out, device="cpu")
    return out


def dispnet_argv(data, extra=()):
    return ["-l", data["list"], "--weights", data["Dispnet"], *DN_FLAGS, *extra]


def test_dispnet_host_mad_matches_jax(data, dispnet_host):
    want = data["tmp"] / "dn_jax_host"
    run_cli(j_adapt, dispnet_argv(data, ["--sessionMode", "host", "--corrMode", "jnp"]), want)
    assert_series_close(dispnet_host, want)
    assert read_stats(dispnet_host)["fetch_counter"] == ["1", "1", "1", "0", "0", "0"]


def test_dispnet_fused_mad_matches_host(data, dispnet_host):
    out = data["tmp"] / "dn_port_fused"
    run_cli(t_adapt, dispnet_argv(data, ["--sessionMode", "fused"]), out, device="cpu")
    assert_series_close(out, dispnet_host, rtol=1e-5)


def test_cli_main_needs_the_gpu_unless_asked(data, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cli(t_adapt, madnet_argv(data), tmp_path / "gpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cli(t_evaluate, ["-l", data["list"], "--weights", data["MADNet"]], tmp_path / "gpu2")


def test_evaluate_matches_jax(data):
    """Batch 2 over 3 frames, so the last batch is padded, at `highest`."""
    from real_time_self_adaptive_deep_stereo_torch.ops.conv import set_conv_precision

    argv = ["-l", data["list"], "--weights", data["MADNet"], "--modelName", "MADNet",
            "--imageShape", str(H), str(W), "--batch", "2", "--precision", "highest"]
    want = run_cli(j_evaluate, argv + ["--corrMode", "jnp"], data["tmp"] / "jax_eval")
    try:
        got = run_cli(t_evaluate, argv, data["tmp"] / "port_eval", device="cpu")
    finally:
        set_conv_precision("highest")
    assert set(got) == set(want)
    (ge, gb), (we, wb) = read_series(data["tmp"] / "port_eval"), read_series(data["tmp"] / "jax_eval")
    assert ge.shape == we.shape == (3,)
    np.testing.assert_allclose(ge, we, rtol=RTOL)
    np.testing.assert_allclose(gb, wb, rtol=RTOL)
    for key in ("avg_epe", "avg_bad3", "avg_d1"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL)


def parser_surface(parser):
    return {
        a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs, a.required,
                 None if a.dest == "corrMode" else tuple(a.choices or ()))
        for a in parser._actions if a.dest != "help"
    }


@pytest.mark.parametrize("name", ["adapt", "evaluate"])
def test_argparsers_match_jax(name):
    """Same flags, types and defaults; only --corrMode's choices differ."""
    port = {"adapt": t_adapt, "evaluate": t_evaluate}[name].build_argparser()
    ref = {"adapt": j_adapt, "evaluate": j_evaluate}[name].build_argparser()
    assert parser_surface(port) == parser_surface(ref)
    corr = {a.dest: a for a in port._actions}["corrMode"]
    assert corr.choices == ["auto", "cuda", "torch"] and corr.default == "auto"


def test_reference_json_covers_phase9():
    """tests/fixtures/torch_cli_reference.json has a row for every run that
    chip_smoke.py phase 9 holds against it, over the scenes and frame
    counts that phase 9 writes, at the flags it states."""
    import chip_smoke
    from tools import torch_cli_reference

    doc = json.loads(chip_smoke.CLI_REFERENCE.read_text())
    assert "torch_cli_reference.py" in doc["command"]
    assert set(doc["runs"]) == set(chip_smoke.CLI_REFERENCE_RUNS)
    for name, (cli, scenes, _, precision) in chip_smoke.CLI_REFERENCE_RUNS.items():
        row = doc["runs"][name]
        assert row["cli"] == cli and row["precision"] == precision
        assert row["scenes"] == list(chip_smoke.CLI_SCENES[scenes])
        assert row["frames"] == chip_smoke.CLI_FRAMES == len(row["epe"]) == len(row["d1"])
        assert row["argv"] == torch_cli_reference.portable(torch_cli_reference.jax_argv(name, "LIST", "OUT"))
        assert not any(os.path.isabs(a) for a in row["argv"])
        for key in ("avg_epe", "avg_bad3", "avg_d1"):
            assert np.isfinite(row[key])
        np.testing.assert_allclose(row["avg_d1"], np.mean(row["d1"]), rtol=1e-9)
    # the witness rows of the evaluate runs: the JAX CLI with every bf16
    # rounding kept, and the port's own evaluate on the CPU
    assert "torch_cli_reference.py --strict" in doc["strict_command"]
    for key, argv in (("strict_runs", torch_cli_reference.jax_argv),
                      ("port_cpu_runs", torch_cli_reference.port_argv)):
        assert set(doc[key]) == set(chip_smoke.CLI_WITNESS_RUNS) <= set(chip_smoke.CLI_REFERENCE_RUNS)
        for name, row in doc[key].items():
            cli, scenes, _, precision = chip_smoke.CLI_REFERENCE_RUNS[name]
            assert cli == row["cli"] == "evaluate" and row["precision"] == precision
            assert row["scenes"] == list(chip_smoke.CLI_SCENES[scenes])
            assert row["frames"] == chip_smoke.CLI_FRAMES == len(row["d1"])
            assert row["argv"] == torch_cli_reference.portable(argv(name, "LIST", "OUT"))
            np.testing.assert_allclose(row["avg_d1"], np.mean(row["d1"]), rtol=1e-9)


def test_phase9_list_files(tmp_path):
    import chip_smoke

    path = chip_smoke.write_cli_list(tmp_path, ("scene2", "scene3"), 32)
    from real_time_self_adaptive_deep_stereo_torch.data import read_list_file

    left, right, gt, _ = read_list_file(path)
    assert len(left) == 32 and all(os.path.isabs(p) and os.path.exists(p) for p in left + right + gt)
    assert [os.path.basename(p) for p in left[:3]] == ["scene2_left.png", "scene3_left.png",
                                                       "scene2_left.png"]
