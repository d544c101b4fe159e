"""``tools/torch_kitti_eval.py`` against the JAX tool ``tools/kitti_eval.py``
on the CPU, at 64x96 (the size of ``tests/test_cli.py``), on synthetic
KITTI raw layouts written with the port's ``write_png``: the argparsers,
``parse_sequences``, the lists byte for byte and the errors; end to end,
MAD SEQUENTIAL, photometric and with proxy labels, the port tool's rows
against the JAX tool's runner in its host session with ``--corrMode jnp``
(rtol 1e-4, ``tests/test_torch_cli.py``'s bound for the adapt CLI); the
TF1 route into the tool's cache. Also the layout ``chip_smoke.py`` phase 15
writes and the JAX rows it holds the card to."""

import csv
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest

from real_time_self_adaptive_deep_stereo_torch.cli import adapt as t_adapt
from real_time_self_adaptive_deep_stereo_torch.cli import adapt_continual as t_continual
from real_time_self_adaptive_deep_stereo_torch.data.png import read_png, write_png
from real_time_self_adaptive_deep_stereo_tpu.cli import adapt as j_adapt
from real_time_self_adaptive_deep_stereo_tpu.cli import adapt_continual as j_continual

ROOT = Path(__file__).resolve().parent.parent
H, W = 64, 96
RTOL = 1e-4  # avg D1 and EPE, port against JAX: tests/test_torch_cli.py's RTOL for the adapt CLI
ROUNDED = 1e-3  # the table's D1 and EPE carry 3 decimals: two values within RTOL may round a step apart
DRIVE = "2011_09_26_drive_0005_sync"
TF1 = ROOT / "tests" / "fixtures" / "tf1_madnet_tiny"


def load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jtool = load("kitti_eval")  # imports no JAX at module level
ttool = load("torch_kitti_eval")


def frame(i):
    """tests/test_cli.py's frame i: a random texture rolled down i rows,
    the right image shifted 3 px, ground truth 3 px (16-bit, x256)."""
    base = (np.random.default_rng(7).random((H, W, 3)) * 255).astype(np.uint8)
    left = np.roll(base, i, axis=0)
    return left, np.roll(left, -3, axis=1), np.full((H, W), 3 * 256, np.uint16)


def write_drive(root, drive, n, date="2011_09_26", no_gt=(), no_proxy=(), no_right=(), flat=False):
    """``n`` frames of a drive: ``raw/<date>/<drive>/image_0{2,3}/data`` (or,
    with ``flat``, ``raw/<drive>/{left,right}_NNN.png`` and ``gt_``/``proxy_``
    names), ``gt/<drive>`` and ``proxy/<drive>`` (the ground truth)."""
    root = Path(root)
    for i in range(n):
        left, right, gt = frame(i)
        if flat:
            d = root / "raw" / drive
            names = {"left": f"left_{i:03d}.png", "right": f"right_{i:03d}.png", "gt": f"gt_{i:03d}.png",
                     "proxy": f"proxy_{i:03d}.png"}
            paths = {"left": d / names["left"], "right": d / names["right"]}
        else:
            d = root / "raw" / date / drive
            names = dict.fromkeys(("gt", "proxy"), f"{i:010d}.png")
            paths = {"left": d / "image_02" / "data" / names["gt"], "right": d / "image_03" / "data" / names["gt"]}
        paths["gt"] = root / "gt" / drive / names["gt"]
        paths["proxy"] = root / "proxy" / drive / names["proxy"]
        arrays = {"left": left, "right": right, "gt": gt, "proxy": gt}
        skip = {"right": no_right, "gt": no_gt, "proxy": no_proxy}
        for k, p in paths.items():
            if i in skip.get(k, ()):
                continue
            p.parent.mkdir(parents=True, exist_ok=True)
            write_png(str(p), arrays[k])


def roots(root, proxy=False):
    root = Path(root)
    return str(root / "raw"), str(root / "gt"), str(root / "proxy") if proxy else None


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """The layouts of the list cases: a drive under a date directory with
    frame 3 lacking GT and frame 1 its proxy, a drive directly under the
    root, the flat ``left_*`` layout; and the faulty ones."""
    tmp = tmp_path_factory.mktemp("layouts")
    write_drive(tmp / "kitti", DRIVE, 5, no_gt=(3,), no_proxy=(1,))
    write_drive(tmp / "kitti", "2011_09_28_drive_0002_sync", 2, date=".")
    write_drive(tmp / "flat", "drive_flat", 3, no_gt=(2,), flat=True)
    write_drive(tmp / "bad", "no_right", 2, no_right=(1,))
    write_drive(tmp / "bad", "twice", 1, date="2011_09_26")
    write_drive(tmp / "bad", "twice", 1, date="2011_09_29")
    write_drive(tmp / "bad", "no_gt", 2, no_gt=(0, 1))
    return tmp


LIST_CASES = {
    "date_dir_gt_dropped": ("kitti", False, [DRIVE], None),
    "proxy_column_dropped": ("kitti", True, [DRIVE], None),
    "two_drives": ("kitti", True, [DRIVE, "2011_09_28_drive_0002_sync"], None),
    "flat_layout": ("flat", True, ["drive_flat"], None),
    "max_frames": ("kitti", False, [DRIVE, "2011_09_28_drive_0002_sync"], 3),
}


@pytest.mark.parametrize("case", list(LIST_CASES))
def test_sequence_list_bytes_match_jax(layouts, tmp_path, case):
    where, proxy, drives, max_frames = LIST_CASES[case]
    got, want = tmp_path / "port.csv", tmp_path / "jax.csv"
    n = ttool.build_sequence_list(*roots(layouts / where, proxy), drives, str(got), max_frames)
    assert n == jtool.build_sequence_list(*roots(layouts / where, proxy), drives, str(want), max_frames)
    assert got.read_bytes() == want.read_bytes()
    lines = got.read_text().splitlines()
    assert len(lines) == n and all(len(line.split(",")) == (4 if proxy else 3) for line in lines)
    expected = {"date_dir_gt_dropped": 4, "proxy_column_dropped": 3, "two_drives": 5, "flat_layout": 2,
                "max_frames": 3}[case]
    assert n == expected


@pytest.mark.parametrize("drive", ["no_right", "twice", "no_gt", "missing"])
def test_sequence_list_errors_match_jax(layouts, tmp_path, drive):
    errors = []
    for tool in (ttool, jtool):
        with pytest.raises(Exception) as info:
            tool.build_sequence_list(*roots(layouts / "bad"), [drive], str(tmp_path / "l.csv"))
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1] and errors[0][0] is FileNotFoundError


def test_parse_sequences_matches_jax(tmp_path):
    spec = "city=a_sync, b_sync ; road=c_sync;;"
    assert ttool.parse_sequences(spec) == jtool.parse_sequences(spec) == {"city": ["a_sync", "b_sync"],
                                                                           "road": ["c_sync"]}
    path = tmp_path / "seqs.json"
    path.write_text(json.dumps({"campus": ["d"], 7: ["e", "f"]}))
    assert ttool.parse_sequences(str(path)) == jtool.parse_sequences(str(path)) == {"campus": ["d"],
                                                                                     "7": ["e", "f"]}
    for bad in ("city", " ; "):
        errors = []
        for tool in (ttool, jtool):
            with pytest.raises(ValueError) as info:
                tool.parse_sequences(bad)
            errors.append(str(info.value))
        assert errors[0] == errors[1]


def test_argparser_matches_jax():
    def surface(parser):
        return {a.dest: (type(a).__name__, tuple(a.option_strings), a.default, a.type, a.nargs, a.required,
                         a.choices, a.help) for a in parser._actions}

    assert surface(ttool.build_argparser()) == surface(jtool.build_argparser())


def host_jax_runner(monkeypatch, module, kept):
    """The JAX runner as the port's rows are held to it: the argv the JAX
    tool builds plus ``--sessionMode host --corrMode jnp``; results kept."""
    build, run = module.build_argparser, module.main

    def parser():
        p = build()
        parse = p.parse_args
        p.parse_args = lambda argv: parse([*argv, "--sessionMode", "host", "--corrMode", "jnp"])
        return p

    monkeypatch.setattr(module, "build_argparser", parser)
    monkeypatch.setattr(module, "main", lambda args: kept.append(run(args)) or kept[-1])


def kept_port_runner(monkeypatch, module, kept):
    run = module.main
    monkeypatch.setattr(module, "main", lambda args, device=None: kept.append(run(args, device=device)) or kept[-1])


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """Both tools end to end over one drive of 4 frames (frame 2 without
    GT: 3 scored), MADNet from JAX weights, MAD SEQUENTIAL at 64x96,
    photometric and proxy: {pipeline: {tool: (rows, runner results, output)}}."""
    import jax

    from real_time_self_adaptive_deep_stereo_tpu.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_tpu.utils.checkpoint import save_params

    tmp = tmp_path_factory.mktemp("e2e")
    write_drive(tmp, DRIVE, 4, no_gt=(2,))
    weights = str(tmp / "madnet.npz")
    save_params(weights, get_stereo_net("MADNet").init(jax.random.PRNGKey(1)))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for pipeline, proxy in (("photometric", False), ("proxy", True)):
            raw, gt, _ = roots(tmp)
            argv = ["--kittiRoot", raw, "--gtRoot", gt, *(["--proxyRoot", str(tmp / "proxy")] if proxy else []),
                    "--weights", weights, "--sequences", f"city={DRIVE}", "--mode", "MAD",
                    "--sampleMode", "SEQUENTIAL", "--imageShape", str(H), str(W)]
            out[pipeline] = {}
            for name, tool, modules, keep in (("jax", jtool, (j_adapt, j_continual), host_jax_runner),
                                              ("port", ttool, (t_adapt, t_continual), kept_port_runner)):
                kept = []
                keep(mp, modules[proxy], kept)
                dest = tmp / f"{pipeline}_{name}"
                args = tool.build_argparser().parse_args([*argv, "--output", str(dest)])
                rows = tool.main(args) if name == "jax" else tool.main(args, device="cpu")
                out[pipeline][name] = (rows, kept, dest)
    return out


@pytest.mark.parametrize("pipeline", ["photometric", "proxy"])
def test_rows_match_the_jax_runner(e2e, pipeline):
    (jrows, jkept, jdir), (trows, tkept, tdir) = e2e[pipeline]["jax"], e2e[pipeline]["port"]
    assert len(jrows) == len(trows) == len(jkept) == len(tkept) == 1
    (jr, jk), (tr, tk) = (jrows[0], jkept[0]), (trows[0], tkept[0])
    assert tr["frames"] == jr["frames"] == 3 and (tr["sequence"], tr["mode"]) == ("city", "MAD")
    assert tr["resets"] == jr["resets"]
    for key in ("avg_d1", "avg_epe"):
        assert np.isfinite(tk[key]) and tr[key] == round(tk[key], 3)
        np.testing.assert_allclose(tk[key], jk[key], rtol=RTOL)
    assert (tdir / "city.csv").read_bytes() == (jdir / "city.csv").read_bytes()
    for part in ("series.csv", "overall.csv" if pipeline == "proxy" else "stats.csv"):
        assert (tdir / "city__mad" / part).exists()


@pytest.mark.parametrize("pipeline", ["photometric", "proxy"])
def test_table_format_matches_jax(e2e, pipeline):
    (_, _, jdir), (_, _, tdir) = e2e[pipeline]["jax"], e2e[pipeline]["port"]
    with open(tdir / "kitti_table.csv") as f:
        got = list(csv.reader(f))
    with open(jdir / "kitti_table.csv") as f:
        want = list(csv.reader(f))
    assert got[0] == want[0] == ["sequence", "mode", "frames", "avg_d1", "avg_epe", "fps", "resets"]
    assert len(got) == len(want) == 2
    (g, w) = (dict(zip(got[0], got[1])), dict(zip(want[0], want[1])))
    for key in ("sequence", "mode", "frames", "resets"):
        assert g[key] == w[key]
    for key in ("avg_d1", "avg_epe"):
        assert abs(float(g[key]) - float(w[key])) <= RTOL * abs(float(w[key])) + ROUNDED
        assert len(g[key].split(".")[1]) <= 3
    assert float(g["fps"]) > 0


def test_tf1_checkpoint_cached_in_the_jax_layout(tmp_path, capsys):
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net

    cached = ttool._resolve_weights(str(TF1 / "model.ckpt"), "MADNet", str(tmp_path))
    assert cached == str(tmp_path / "imported_weights.npz")
    assert "Imported 6 variables" in capsys.readouterr().out
    name_map = get_stereo_net("MADNet", device="cpu").tf_name_map()
    with np.load(TF1 / "values.npz") as values, np.load(cached) as cache:
        assert len(values.files) == 6
        for name in values.files:
            got = cache["/".join(name_map[name])]
            assert got.dtype == values[name].dtype and np.array_equal(got, values[name])
    assert ttool._resolve_weights("w.npz", "MADNet", str(tmp_path)) == "w.npz"
    with pytest.raises(ValueError, match="no variables restored"):
        ttool._resolve_weights(str(TF1 / "model.ckpt"), "Dispnet", str(tmp_path / "dn"))


def test_main_needs_the_gpu_unless_asked(layouts, tmp_path):
    raw, gt, _ = roots(layouts / "kitti")
    args = ttool.build_argparser().parse_args(
        ["--kittiRoot", raw, "--gtRoot", gt, "--weights", "w.npz", "--sequences", f"city={DRIVE}",
         "--output", str(tmp_path / "out"), "--listOnly"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttool.main(args)
    assert ttool.main(args, device="cpu") == []
    assert len((tmp_path / "out" / "city.csv").read_text().splitlines()) == 4


# ---------------------------------------------------------------- phase 15
def test_kitti_tree_layout_and_frames(tmp_path):
    """chip_smoke.write_kitti_tree: the drives under their dates, left and
    right PNGs, 16-bit GT and proxies but for the GT-less frames; each
    sequence 16 scored frames, the lists equal to the JAX tool's."""
    import chip_smoke

    tree = chip_smoke.write_kitti_tree(tmp_path)
    assert ttool.parse_sequences(tree["sequences"]) == {k: list(v) for k, v in chip_smoke.KITTI_SEQUENCES.items()}
    want = {"2011_09_26_drive_0001_sync": ("2011_09_26", 17, 1), "2011_09_26_drive_0002_sync": ("2011_09_26", 9, 1),
            "2011_09_28_drive_0003_sync": ("2011_09_28", 9, 1)}
    for drive, (date, n, missing) in want.items():
        ddir = Path(tree["raw"]) / date / drive
        lefts = sorted(os.listdir(ddir / "image_02" / "data"))
        assert lefts == sorted(os.listdir(ddir / "image_03" / "data")) == [f"{i:010d}.png" for i in range(n)]
        gts = sorted(os.listdir(Path(tree["gt"]) / drive))
        assert gts == sorted(os.listdir(Path(tree["proxy"]) / drive)) and len(gts) == n - missing
        gt = read_png(str(Path(tree["gt"]) / drive / gts[0]))
        assert gt.dtype == np.uint16 and gt.shape == (chip_smoke.H, chip_smoke.W)
        assert read_png(str(ddir / "image_02" / "data" / lefts[0])).shape == (chip_smoke.H, chip_smoke.W, 3)
    assert sorted(os.listdir(tree["raw"])) == ["2011_09_26", "2011_09_28"]
    for proxy in (False, True):
        for seq, drives in chip_smoke.KITTI_SEQUENCES.items():
            got, ref = tmp_path / f"{seq}_{proxy}.csv", tmp_path / f"{seq}_{proxy}_jax.csv"
            pr = tree["proxy"] if proxy else None
            assert ttool.build_sequence_list(tree["raw"], tree["gt"], pr, drives, str(got)) == chip_smoke.KITTI_FRAMES
            jtool.build_sequence_list(tree["raw"], tree["gt"], pr, drives, str(ref))
            assert got.read_bytes() == ref.read_bytes()


def test_reference_json_covers_phase15():
    """tests/fixtures/torch_cli_reference.json's kitti_runs: a row for each
    sequence of every run that phase 15 (a) and (b) holds against it, at
    the flags it states, the JAX runner in its host session."""
    import chip_smoke
    from tools import torch_cli_reference as ref

    doc = json.loads(chip_smoke.CLI_REFERENCE.read_text())
    assert "torch_cli_reference.py --kitti" in doc["kitti_command"]
    assert set(doc["kitti_runs"]) == set(chip_smoke.KITTI_REFERENCE_RUNS)
    spec = ";".join(f"{k}={','.join(v)}" for k, v in chip_smoke.KITTI_SEQUENCES.items())
    placeholders = {**ref.KITTI_PLACEHOLDERS, "sequences": spec}
    for name, (proxy, flags) in chip_smoke.KITTI_REFERENCE_RUNS.items():
        run = doc["kitti_runs"][name]
        assert run["argv"] == ref.portable(ref.kitti_tool_argv(name, placeholders, "OUT"))
        assert ("--proxyRoot" in run["argv"]) == proxy and not any(os.path.isabs(a) for a in run["argv"])
        assert run["runner_flags"] == ["--sessionMode", "host", "--corrMode", "jnp"]
        assert run["table_header"] == chip_smoke.KITTI_TABLE_HEADER
        assert list(run["rows"]) == list(chip_smoke.KITTI_SEQUENCES)
        mode = flags[flags.index("--mode") + 1]
        for seq, row in run["rows"].items():
            assert row["frames"] == chip_smoke.KITTI_FRAMES and row["mode"] == mode and row["sequence"] == seq
            for key in ("avg_d1", "avg_epe"):
                assert np.isfinite(row[key]) and row[key] == round(row[f"{key}_unrounded"], 3)
            argv = row["runner_argv"]
            assert argv[-4:] == run["runner_flags"] and argv[argv.index("--sampleMode") + 1] == "SEQUENTIAL"
            assert ("--dilation" in argv) == proxy and argv[argv.index("-l") + 1] == f"OUT/{seq}.csv"

