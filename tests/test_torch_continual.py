"""The port's continual-adaptation CLI (``cli/adapt_continual.py``) against
the JAX package's, on the CPU, on the tiny dataset of
``tests/test_torch_cli.py`` (its 4th column, the proxy, is the ground
truth): average EPE and D1 within rtol 1e-4, ``series.csv`` within the 0.001
it prints, ``histogram.csv`` equal, the ``--saveWeights`` checkpoint read by
the JAX ``load_params``; the fused session against the host session for
FIXED with two ids and FULL with ``--dilation 2``. Also ``colorize_disparity``
against the JAX function and the ``adapt`` CLI's ``--summary`` events, read
back from the event file."""

import ast
import os

import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch.cli import adapt as t_adapt
from real_time_self_adaptive_deep_stereo_torch.cli import adapt_continual as t_cont
from real_time_self_adaptive_deep_stereo_tpu.cli import adapt_continual as j_cont
from tests.test_torch_cli import H, W, jax_weights, parser_surface, run_cli, write_tiny_dataset

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's runs: at these sizes more threads
    only contend with the other test workers' (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-4  # average EPE and D1, port against JAX (float32 sums in another order)
FLAGS = ["--blockConfig", "block_config/MadNet_full.json", "--modelName", "MADNet", "--seed", "0",
         "--imageShape", str(H), str(W)]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("continual")
    return {"list": write_tiny_dataset(tmp), "weights": jax_weights(tmp, "MADNet"), "tmp": tmp}


def argv(data, extra=()):
    return ["-l", data["list"], "--weights", data["weights"], *FLAGS, *extra]


def read_series(out):
    lines = open(os.path.join(str(out), "series.csv")).read().strip().splitlines()
    assert lines[0] == "step\tEPE\tD1"
    rows = np.array([[float(v) for v in line.split(" & ")] for line in lines[1:]])
    assert rows[:, 0].tolist() == list(range(len(rows)))
    return rows[:, 1:]


def read_histogram(out):
    lines = open(os.path.join(str(out), "histogram.csv")).read().strip().splitlines()
    assert lines[0] == "Histogram"
    return [ast.literal_eval(line) for line in lines[1:]]


def assert_runs_close(got, want, got_out, want_out, rtol=RTOL):
    for key in ("avg_epe", "avg_d1"):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol)
    assert got["resets"] == want["resets"]
    gs, ws = read_series(got_out), read_series(want_out)
    assert gs.shape == ws.shape == (3, 2)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=0.001 + 1e-9)  # the 3 decimals it prints


@pytest.fixture(scope="module")
def mad_runs(data):
    """MAD SEQUENTIAL in the host session, JAX and port, with --saveWeights."""
    extra = ["--mode", "MAD", "--sampleMode", "SEQUENTIAL", "--sessionMode", "host", "--saveWeights"]
    want_out, got_out = data["tmp"] / "jax_mad", data["tmp"] / "port_mad"
    want = run_cli(j_cont, argv(data, extra + ["--corrMode", "jnp"]), want_out)
    got = run_cli(t_cont, argv(data, extra), got_out, device="cpu")
    return got, want, got_out, want_out


def test_continual_host_mad_matches_jax(mad_runs):
    got, want, got_out, want_out = mad_runs
    assert set(got) == set(want) == {"avg_epe", "avg_d1", "fps", "resets"}
    assert_runs_close(got, want, got_out, want_out)
    assert read_histogram(got_out) == read_histogram(want_out) == [[1, 0, 0, 0, 0]]
    overall = open(os.path.join(str(got_out), "overall.csv")).read().splitlines()
    assert overall[0] == "EPE\tD1" and overall == open(os.path.join(str(want_out), "overall.csv")).read().splitlines()


def test_continual_saved_weights_load_in_jax(mad_runs):
    """weights/weights-3.npz of the port, read by the JAX load_params: the
    JAX tree of the JAX run's own checkpoint, within 1e-5 of its values."""
    from real_time_self_adaptive_deep_stereo_tpu.utils.checkpoint import flatten_params, load_params

    _, _, got_out, want_out = mad_runs
    got = flatten_params(load_params(os.path.join(str(got_out), "weights", "weights-3.npz")))
    want = flatten_params(load_params(os.path.join(str(want_out), "weights", "weights-3.npz")))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", ["fixed_2_3", "full_dilation_2"])
def test_continual_fused_matches_host(data, case, capsys):
    """The JAX CLI's own regression cases (tests/test_cli.py:177-225): the
    fused session passes every FIXED id and honours --dilation; the fused
    FIXED run fetches exactly blocks 2 and 3."""
    extra = {"fixed_2_3": ["--mode", "MAD", "--sampleMode", "FIXED", "--fixedID", "2", "3"],
             "full_dilation_2": ["--mode", "FULL", "--dilation", "2"]}[case]
    host_out, fused_out = data["tmp"] / f"{case}_host", data["tmp"] / f"{case}_fused"
    host = run_cli(t_cont, argv(data, extra + ["--sessionMode", "host"]), host_out, device="cpu")
    capsys.readouterr()
    fused = run_cli(t_cont, argv(data, extra + ["--sessionMode", "fused"]), fused_out, device="cpu")
    assert_runs_close(fused, host, fused_out, host_out, rtol=1e-5)
    hist = read_histogram(fused_out)
    if case == "fixed_2_3":
        assert [i for i, c in enumerate(hist[-1]) if c > 0] == [2, 3] and hist[-1] == [0, 0, 3, 3, 0]
        ids_shown = list(np.atleast_1d([2, 3]))  # as the JAX CLI prints them
        line = f"# FIXED: training the 2 listed block(s) {ids_shown}; --numBlocks 1 ignored"
        assert line in capsys.readouterr().out
    else:
        assert hist == [[0]]


def test_continual_full_dilation_matches_jax(data):
    extra = ["--mode", "FULL", "--dilation", "2", "--sessionMode", "host"]
    want_out, got_out = data["tmp"] / "jax_full", data["tmp"] / "port_full"
    want = run_cli(j_cont, argv(data, extra + ["--corrMode", "jnp"]), want_out)
    got = run_cli(t_cont, argv(data, extra), got_out, device="cpu")
    assert_runs_close(got, want, got_out, want_out)
    assert read_histogram(got_out) == read_histogram(want_out)


def test_continual_disparity_pngs_and_auto_session(data):
    """--logDispStep makes `auto` pick the host session, which writes the
    PNGs at the stride."""
    out = data["tmp"] / "pngs"
    run_cli(t_cont, argv(data, ["--mode", "NONE", "--logDispStep", "2"]), out, device="cpu")
    assert sorted(os.listdir(out / "disparities")) == ["disparity_0.png", "disparity_2.png"]
    assert read_histogram(out) == [[0]]


def test_continual_argparser_matches_jax():
    """Same flags, types and defaults; only --corrMode's choices differ."""
    port, ref = t_cont.build_argparser(), j_cont.build_argparser()
    assert parser_surface(port) == parser_surface(ref)
    corr = {a.dest: a for a in port._actions}["corrMode"]
    assert corr.choices == ["auto", "cuda", "torch"] and corr.default == "auto"


def test_continual_main_needs_the_gpu_unless_asked(data, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cli(t_cont, argv(data), tmp_path / "gpu")


def test_colorize_disparity_matches_jax():
    """Seeded maps with NaN and inf, default and given ranges, [H,W,1]."""
    from real_time_self_adaptive_deep_stereo_torch.utils.visual import colorize_disparity as t_col
    from real_time_self_adaptive_deep_stereo_tpu.utils.visual import colorize_disparity as j_col

    rng = np.random.default_rng(11)
    d = (rng.random((24, 40)) * 90).astype(np.float32)
    d[3, 4], d[5, 6] = np.nan, np.inf
    both = d.copy()
    both[7, 8] = -np.inf  # with both infinities only a given range is finite (vmax - vmin overflows)
    for x, kwargs in ((d, {}), (d, {"vmin": 0.0, "vmax": 64.0}), (both, {"vmin": 0.0, "vmax": 64.0}),
                      (both, {"vmin": 10.0, "vmax": 10.0}), (d[..., None], {}), (both[..., None], {"vmax": 50.0,
                                                                                                 "vmin": 5.0})):
        got, want = t_col(x, **kwargs), j_col(x, **kwargs)
        assert got.shape == want.shape == (24, 40, 3) and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # any other name is matplotlib's (the refusal without matplotlib: tests/test_torch_demo.py)
    np.testing.assert_allclose(t_col(d, cmap="viridis"), j_col(d, cmap="viridis"), rtol=0, atol=1e-12)


def test_adapt_summary_writes_the_jax_events(tmp_path):
    """`cli/adapt.py --summary` in both sessions: the event file holds the
    scalars EPE and bad3 and the images full_res_disp and gt_disp. The host
    session writes them every 100th frame, as the JAX CLI's host session
    does (held here); the fused session writes every frame's scalars at the
    end and the images every 100th frame, as the JAX CLI's fused session
    does (cli/adapt.py:231-250)."""
    tf = pytest.importorskip("tensorflow")
    from real_time_self_adaptive_deep_stereo_tpu.cli import adapt as j_adapt

    tiny = write_tiny_dataset(tmp_path)
    weights = jax_weights(tmp_path, "MADNet")
    common = ["-l", tiny, "--weights", weights, "--modelName", "MADNet", "--blockConfig",
              "block_config/MadNet_full.json", "--mode", "NONE", "--imageShape", str(H), str(W), "--summary"]

    def tags(out):
        found = {}
        for name in os.listdir(out):
            if name.startswith("events.out.tfevents"):
                for event in tf.compat.v1.train.summary_iterator(os.path.join(str(out), name)):
                    for v in event.summary.value:
                        found.setdefault(v.tag, []).append(event.step)
        return {k: sorted(v) for k, v in found.items()}

    want = tags(_run(j_adapt, common + ["--sessionMode", "host", "--corrMode", "jnp"], tmp_path / "jax"))
    assert want == {"EPE": [0], "bad3": [0], "full_res_disp": [0], "gt_disp": [0]}
    assert tags(_run(t_adapt, common + ["--sessionMode", "host"], tmp_path / "host", device="cpu")) == want
    got = tags(_run(t_adapt, common + ["--sessionMode", "fused"], tmp_path / "fused", device="cpu"))
    assert got == {"EPE": [0, 1, 2], "bad3": [0, 1, 2], "full_res_disp": [0], "gt_disp": [0]}


def _run(module, argv, out, **kw):
    run_cli(module, argv, out, **kw)
    return out
