#!/usr/bin/env python3
"""The JAX package's CLIs on the real-frame runs that ``chip_smoke.py``
phase 9 holds the port's CLIs against, on the CPU.

    JAX_PLATFORMS=cpu python tools/torch_cli_reference.py [--runs NAME,...]

Runs ``cli/adapt.py`` (``--sessionMode host --corrMode jnp``) and
``cli/evaluate.py`` (``--corrMode jnp``) of
``real_time_self_adaptive_deep_stereo_tpu`` over the list files that phase 9
writes (``chip_smoke.write_cli_list``: 32 frames cycling two fixture scenes,
320x1216, ``weights_scene01.npz``, SEQUENTIAL, lr 1e-4, SSIMTh 0.5) and
writes ``tests/fixtures/torch_cli_reference.json``: per run its flags, the
average EPE, bad3 and D1, the per-frame series and the wall time. The
runs are ``chip_smoke.CLI_REFERENCE_RUNS``, one after another (about 2
minutes on a CPU); ``--runs`` picks some of them and keeps the other rows
of the file. The card's machine has no JAX: ``chip_smoke.py`` reads the
JSON only.

The same command also makes the rows of phase 10
(``chip_smoke.PHASE10_REFERENCE_RUNS``, the file's ``phase10_runs``):
``cli/adapt_continual.py`` (``--sessionMode host --corrMode jnp``) over the
same frames with a proxy column (the scene's ground truth), and
``cli/train.py`` (``--corrMode jnp``; 8 steps of 4 frames, ``--augment``,
seed 0) followed by ``cli/evaluate.py`` at ``highest`` on its checkpoint
(about 6 minutes for the four).

And the row of phase 11 (``chip_smoke.DEMO_REFERENCE_RUNS``, the file's
``demo_runs``): the JAX demo, ``cli/demo.py --sessionMode host``, headless
over the same 32 frames at full width, from ``chip_smoke.DEMO_SEEDS``
starting points (the weights, and copies with each weight moved by at
most one ulp: ``chip_smoke.perturbed_weights``), and the per-frame EPE and
D1 of the PNGs it writes (``chip_smoke.demo_png_metrics``; about 7
minutes).

    JAX_PLATFORMS=cpu python tools/torch_cli_reference.py --kitti

makes the rows of phase 15 instead (``chip_smoke.KITTI_REFERENCE_RUNS``, the
file's ``kitti_runs``): the JAX tool ``tools/kitti_eval.py`` (its own
``main``, lists and rows) over ``chip_smoke.write_kitti_tree``, its runner
``cli/adapt.py`` or ``cli/adapt_continual.py`` given the argv the tool
builds plus ``--sessionMode host --corrMode jnp``; each sequence's row as
the tool rounds it, and the runner's unrounded averages (about 5 minutes).

    JAX_PLATFORMS=cpu python tools/torch_cli_reference.py --parity [--sets NAME,...]

makes the rows of phase 16 instead (``chip_smoke.PARITY_SETS``), into
``tests/fixtures/torch_parity_reference.json``: the JAX tool
``tools/parity_results.py``'s own ``run_our_loop`` (exact: gather warps,
``corr_mode="jnp"``, ``highest``) in NONE, MAD and FULL, per set its
per-frame (EPE, bad3, D1) rows and resets. The synthetic sets' frames are
the port's ``make_sequence`` output (``tools/torch_validate_adaptation.py``,
seed 7, planes at 8 and 20 px), so that both loops see the same bytes; the
real-imagery sets' are the JAX tool ``tools/realworld_parity.py``'s
``load_fixture_sequence``. The weights are ``weights_scene01.npz``, or for
the CPU tests' ``small`` set the JAX MADNet's ``PRNGKey(0)`` init (about 4
minutes for the four sets; ``--sets`` remakes some and keeps the others).

    JAX_PLATFORMS=cpu python tools/torch_cli_reference.py --strict

makes the witness rows of the ``evaluate`` runs (``chip_smoke.CLI_WITNESS_RUNS``)
instead: the JAX CLI again with ``XLA_FLAGS=--xla_allow_excess_precision=false``
(``strict_runs``), so that XLA keeps every bf16 rounding that the precision
mode asks for rather than carrying fp32 across it, and the port's own
``evaluate`` on the CPU (``port_cpu_runs``); about 2 minutes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (its constants and list writer; it imports no JAX)

COMMAND = "JAX_PLATFORMS=cpu python tools/torch_cli_reference.py"
STRICT_FLAG = "--xla_allow_excess_precision=false"


def jax_argv(name: str, list_path: str, out: str) -> list:
    """The JAX CLI's flags for run ``name``. The adapt CLI has no precision
    flag: :func:`run_one` sets the mode around it."""
    cli, _, mode, precision = chip_smoke.CLI_REFERENCE_RUNS[name]
    argv = ["-l", list_path, "-o", out, "--weights", str(chip_smoke.CLI_WEIGHTS),
            "--modelName", "MADNet", "--corrMode", "jnp"]
    if cli == "evaluate":
        return argv + ["--imageShape", str(chip_smoke.H), str(chip_smoke.W), "--precision", precision]
    return argv + ["--blockConfig", "block_config/MadNet_full.json", "--mode", mode,
                   "--sessionMode", "host", *chip_smoke.CLI_FLAGS]


def phase10_argv(name: str, list_path: str, out: str) -> list:
    """The JAX CLI's flags for phase-10 run ``name``; for ``train``, the
    training run's (:func:`train_eval_argv` gives the evaluation's)."""
    cli, _, flags = chip_smoke.PHASE10_REFERENCE_RUNS[name]
    if cli == "train":
        return ["--trainingSet", list_path, "-o", out, "--weights", str(chip_smoke.CLI_WEIGHTS),
                "--modelName", "MADNet", "--corrMode", "jnp", *flags]
    return ["-l", list_path, "-o", out, "--weights", str(chip_smoke.CLI_WEIGHTS), "--modelName", "MADNet",
            "--corrMode", "jnp", "--sessionMode", "host", *chip_smoke.CONTINUAL_FLAGS, *flags]


def train_eval_argv(list_path: str, weights: str, out: str) -> list:
    """``evaluate`` of a trained checkpoint over the training frames, at `highest`."""
    return ["-l", list_path, "-o", out, "--weights", weights, "--modelName", "MADNet", "--corrMode", "jnp",
            "--imageShape", str(chip_smoke.H), str(chip_smoke.W), "--batch", str(chip_smoke.EVAL_BATCH),
            "--precision", "highest"]


def run_phase10(name: str, workdir: str) -> dict:
    """One phase-10 run through the JAX CLIs' ``main``: the continual
    CLI's per-frame EPE and D1 are read back from its ``series.csv`` (three
    decimals, as it writes them), its fetch counter from ``histogram.csv``;
    a training run is followed by ``evaluate`` of its last checkpoint,
    whose per-frame series come from the stats it hands to ``write_stats``."""
    import ast

    from real_time_self_adaptive_deep_stereo_tpu.cli import adapt, adapt_continual, evaluate, train
    from real_time_self_adaptive_deep_stereo_tpu.ops.conv import set_conv_precision

    cli, scenes, _ = chip_smoke.PHASE10_REFERENCE_RUNS[name]
    proxy = cli == "adapt_continual"
    list_path = chip_smoke.write_cli_list(workdir, chip_smoke.CLI_SCENES[scenes], chip_smoke.CLI_FRAMES, proxy)
    out = os.path.join(workdir, name)
    os.makedirs(out, exist_ok=True)
    row = {"cli": cli, "scenes": list(chip_smoke.CLI_SCENES[scenes]), "frames": chip_smoke.CLI_FRAMES,
           "argv": portable(phase10_argv(name, "LIST", "OUT"))}
    set_conv_precision("highest")
    t0 = time.perf_counter()
    if proxy:
        result = adapt_continual.main(adapt_continual.build_argparser().parse_args(phase10_argv(name, list_path, out)))
        lines = open(os.path.join(out, "series.csv")).read().strip().splitlines()[1:]
        series = np.array([[float(v) for v in line.split(" & ")] for line in lines])
        hist = open(os.path.join(out, "histogram.csv")).read().strip().splitlines()
        row.update(avg_epe=result["avg_epe"], avg_d1=result["avg_d1"], resets=result["resets"],
                   fetch_counter=ast.literal_eval(hist[-1]), epe=series[:, 1].tolist(), d1=series[:, 2].tolist())
    else:
        trained = train.main(train.build_argparser().parse_args(phase10_argv(name, list_path, out)))
        weights = os.path.join(out, f"weights-{trained['steps']}.npz")
        captured = {}
        write_stats = adapt.write_stats

        def capture(output, stats):
            captured["stats"] = stats
            write_stats(output, stats)

        adapt.write_stats = capture  # evaluate imports it from cli.adapt when it runs
        try:
            result = evaluate.main(evaluate.build_argparser().parse_args(
                train_eval_argv(list_path, weights, os.path.join(out, "eval"))))
        finally:
            adapt.write_stats = write_stats
            set_conv_precision("highest")
        stats = captured["stats"]
        row.update(eval_argv=portable(train_eval_argv("LIST", "OUT/weights-N.npz", "OUT/eval")),
                   final_loss=trained["final_loss"], steps=trained["steps"], avg_epe=result["avg_epe"],
                   avg_bad3=result["avg_bad3"], avg_d1=result["avg_d1"],
                   **{k: [float(v) for v in getattr(stats, k)] for k in ("epe", "bad3", "d1")})
    row["wall_s"] = time.perf_counter() - t0
    return row


def demo_argv(name: str, list_path: str, out: str) -> list:
    """The JAX demo's flags for phase-11 run ``name``, in its host session."""
    return [*chip_smoke.DEMO_FLAGS, "--list", list_path, "--outDir", out, "--maxFrames",
            str(chip_smoke.DEMO_FRAMES), *chip_smoke.DEMO_REFERENCE_RUNS[name], "--sessionMode", "host"]


def run_demo(name: str, workdir: str) -> dict:
    """Phase-11 run ``name`` through the JAX demo's ``main``, from each of
    ``chip_smoke.DEMO_SEEDS`` starting points (``chip_smoke.perturbed_weights``;
    seed 0 is the weights as they are); the per-frame metrics of the PNGs
    it writes: seed 0's at the top of the row, every seed's under ``seeds``."""
    from real_time_self_adaptive_deep_stereo_tpu.cli import demo

    list_path = chip_smoke.write_cli_list(workdir, chip_smoke.CLI_SCENES["scene"], chip_smoke.DEMO_FRAMES)
    seeds = []
    for seed in range(chip_smoke.DEMO_SEEDS):
        out = os.path.join(workdir, f"{name}_seed{seed}")
        argv = [*demo_argv(name, list_path, out), "--weights", chip_smoke.perturbed_weights(seed, workdir)]
        t0 = time.perf_counter()
        demo.main(demo.build_argparser().parse_args(argv))
        wall = time.perf_counter() - t0
        names, epe, d1 = chip_smoke.demo_png_metrics(out, list_path)
        seeds.append({"seed": seed, "frames": len(names), "avg_epe": float(epe.mean()), "avg_d1": float(d1.mean()),
                      "epe": epe.tolist(), "d1": d1.tolist(), "wall_s": wall})
        print(f"{name} seed {seed}: D1 {seeds[-1]['avg_d1']:.4f}, {wall:.1f} s", flush=True)
    first = seeds[0]
    return {"cli": "demo", "session": "host", "scenes": list(chip_smoke.CLI_SCENES["scene"]),
            "frames": first["frames"], "argv": portable(demo_argv(name, "LIST", "OUT")),
            **{k: first[k] for k in ("avg_epe", "avg_d1", "epe", "d1", "wall_s")}, "seeds": seeds}


KITTI_RUNNER_FLAGS = ["--sessionMode", "host", "--corrMode", "jnp"]
KITTI_PLACEHOLDERS = {"raw": "RAW", "gt": "GT", "proxy": "PROXY"}


def kitti_tool_argv(name: str, tree: dict, out: str) -> list:
    """The JAX tool's flags for phase-15 run ``name`` over ``tree``."""
    proxy, flags = chip_smoke.KITTI_REFERENCE_RUNS[name]
    return chip_smoke.kitti_argv(tree, out, proxy, flags)


def run_kitti(name: str, workdir: str) -> dict:
    """Phase-15 run ``name`` through the JAX tool's ``main`` over
    ``chip_smoke.write_kitti_tree``, its runner's argv extended by
    ``KITTI_RUNNER_FLAGS``: per sequence the tool's row (rounded as the
    tool rounds it) and the runner's unrounded ``avg_d1`` and ``avg_epe``."""
    import importlib.util

    from real_time_self_adaptive_deep_stereo_tpu.cli import adapt, adapt_continual

    spec = importlib.util.spec_from_file_location("kitti_eval", ROOT / "tools" / "kitti_eval.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tree = chip_smoke.write_kitti_tree(os.path.join(workdir, f"{name}_tree"))
    out = os.path.join(workdir, name)
    runner = adapt_continual if chip_smoke.KITTI_REFERENCE_RUNS[name][0] else adapt
    results, runner_argv = [], []
    build, run = runner.build_argparser, runner.main

    def host_parser():
        parser = build()
        parse = parser.parse_args

        def parse_args(argv):
            runner_argv.append(portable([*argv, *KITTI_RUNNER_FLAGS]))
            return parse([*argv, *KITTI_RUNNER_FLAGS])

        parser.parse_args = parse_args
        return parser

    def kept(args):
        results.append(run(args))
        return results[-1]

    runner.build_argparser, runner.main = host_parser, kept
    t0 = time.perf_counter()
    try:
        rows = tool.main(tool.build_argparser().parse_args(kitti_tool_argv(name, tree, out)))
    finally:
        runner.build_argparser, runner.main = build, run
    wall = time.perf_counter() - t0
    table = open(os.path.join(out, "kitti_table.csv")).read().splitlines()
    return {
        "tool": "tools/kitti_eval.py",
        "argv": portable(kitti_tool_argv(name, {**KITTI_PLACEHOLDERS, "sequences": tree["sequences"]}, "OUT")),
        "runner_flags": KITTI_RUNNER_FLAGS,
        "table_header": table[0],
        "rows": {r["sequence"]: {**r, "avg_d1_unrounded": res["avg_d1"], "avg_epe_unrounded": res["avg_epe"],
                                 "runner_argv": [a.replace(out, "OUT").replace(tree["raw"], "RAW") for a in argv]}
                 for r, res, argv in zip(rows, results, runner_argv)},
        "wall_s": wall,
    }


def portable(argv: list) -> list:
    """``argv`` as recorded: paths in the checkout relative to its root."""
    return [a[len(str(ROOT)) + 1:] if a.startswith(str(ROOT) + os.sep) else a for a in argv]


def port_argv(name: str, list_path: str, out: str) -> list:
    """The port's ``evaluate`` flags for the witness of run ``name``."""
    _, _, _, precision = chip_smoke.CLI_REFERENCE_RUNS[name]
    return ["-l", list_path, "-o", out, "--weights", str(chip_smoke.CLI_WEIGHTS), "--modelName", "MADNet",
            "--imageShape", str(chip_smoke.H), str(chip_smoke.W), "--precision", precision]


def run_one(name: str, workdir: str, port: bool = False) -> dict:
    """One run through the JAX CLI's ``main`` (the port's, on the CPU, if
    ``port``); its per-frame series are taken from the stats that the CLI
    hands to ``write_stats``."""
    if port:
        from real_time_self_adaptive_deep_stereo_torch.cli import adapt, evaluate
        from real_time_self_adaptive_deep_stereo_torch.ops.conv import set_conv_precision

        make_argv = port_argv
    else:
        from real_time_self_adaptive_deep_stereo_tpu.cli import adapt, evaluate
        from real_time_self_adaptive_deep_stereo_tpu.ops.conv import set_conv_precision

        make_argv = jax_argv
    cli, scenes, _, precision = chip_smoke.CLI_REFERENCE_RUNS[name]
    list_path = chip_smoke.write_cli_list(workdir, chip_smoke.CLI_SCENES[scenes], chip_smoke.CLI_FRAMES)
    out = os.path.join(workdir, name)
    argv = make_argv(name, list_path, out)
    module = adapt if cli == "adapt" else evaluate
    args = module.build_argparser().parse_args(argv)
    captured = {}
    write_stats = adapt.write_stats

    def capture(output, stats):
        captured["stats"] = stats
        write_stats(output, stats)

    adapt.write_stats = capture  # evaluate imports it from cli.adapt when it runs
    set_conv_precision(precision)  # evaluate sets it again from its flag
    try:
        t0 = time.perf_counter()
        result = module.main(args, device="cpu") if port else module.main(args)
        wall = time.perf_counter() - t0
    finally:
        adapt.write_stats = write_stats
        set_conv_precision("highest")
    stats = captured["stats"]
    series = {k: [float(v) for v in getattr(stats, k)] for k in ("epe", "bad3", "d1")}
    return {
        "cli": cli,
        "precision": precision,
        "scenes": list(chip_smoke.CLI_SCENES[scenes]),
        "frames": len(series["epe"]),
        "argv": portable(make_argv(name, "LIST", "OUT")),
        "avg_epe": result["avg_epe"],
        "avg_bad3": result["avg_bad3"],
        "avg_d1": result["avg_d1"],
        "resets": result.get("resets", 0),
        **series,
        "wall_s": wall,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", default=",".join([*chip_smoke.CLI_REFERENCE_RUNS, *chip_smoke.PHASE10_REFERENCE_RUNS,
                                                *chip_smoke.DEMO_REFERENCE_RUNS]),
                    help="comma-separated names from chip_smoke.CLI_REFERENCE_RUNS, PHASE10_REFERENCE_RUNS and "
                         "DEMO_REFERENCE_RUNS")
    ap.add_argument("--json", default=str(chip_smoke.CLI_REFERENCE))
    ap.add_argument("--strict", action="store_true",
                    help="make the witness rows of the evaluate runs instead (see above)")
    ap.add_argument("--kitti", action="store_true",
                    help="make the rows of phase 15, chip_smoke.KITTI_REFERENCE_RUNS, instead (see above)")
    ap.add_argument("--parity", action="store_true",
                    help="make the rows of phase 16, chip_smoke.PARITY_SETS, into chip_smoke.PARITY_REFERENCE "
                         "instead (see above)")
    ap.add_argument("--sets", default=",".join(chip_smoke.PARITY_SETS),
                    help="with --parity, comma-separated names from chip_smoke.PARITY_SETS")
    args = ap.parse_args()
    if args.kitti:
        return main_kitti(Path(args.json))
    if args.parity:
        return main_parity([n for n in args.sets.split(",") if n])
    if args.strict:  # before JAX starts: XLA reads its flags once
        os.environ["XLA_FLAGS"] = f"{os.environ.get('XLA_FLAGS', '')} {STRICT_FLAG}".strip()
        names = list(chip_smoke.CLI_WITNESS_RUNS)
    else:
        names = [n for n in args.runs.split(",") if n]
    unknown = (set(names) - set(chip_smoke.CLI_REFERENCE_RUNS) - set(chip_smoke.PHASE10_REFERENCE_RUNS)
               - set(chip_smoke.DEMO_REFERENCE_RUNS))
    if unknown:
        raise SystemExit(f"unknown runs {sorted(unknown)}")

    rows, port_rows, phase10_rows, demo_rows = {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            if name in chip_smoke.DEMO_REFERENCE_RUNS:
                demo_rows[name] = run_demo(name, tmp)
                print(name, {k: v for k, v in demo_rows[name].items() if k.startswith(("avg", "wall"))}, flush=True)
                continue
            if name in chip_smoke.PHASE10_REFERENCE_RUNS:
                phase10_rows[name] = run_phase10(name, tmp)
                print(name, {k: v for k, v in phase10_rows[name].items() if k.startswith(("avg", "final", "wall"))},
                      flush=True)
                continue
            rows[name] = run_one(name, tmp)
            print(name, {k: rows[name][k] for k in ("avg_epe", "avg_bad3", "avg_d1", "wall_s")}, flush=True)
            if args.strict:
                port_rows[name] = run_one(name, tmp, port=True)
                print(f"{name} (port, CPU)", {k: port_rows[name][k] for k in ("avg_d1", "wall_s")}, flush=True)

    path = Path(args.json)
    doc = json.loads(path.read_text()) if path.exists() else {}
    if args.strict:
        doc["strict_command"] = f"{COMMAND} --strict"
        doc["strict_about"] = (f"strict_runs: the JAX evaluate rows again with XLA_FLAGS={STRICT_FLAG}, "
                               "so that every bf16 rounding of the precision mode is kept; "
                               "port_cpu_runs: the port's evaluate on the CPU over the same lists.")
        doc.setdefault("strict_runs", {}).update(rows)
        doc.setdefault("port_cpu_runs", {}).update(port_rows)
        path.write_text(json.dumps(doc, indent=1) + "\n")
        print(f"wrote {path}")
        return 0
    doc["command"] = COMMAND
    doc["about"] = ("The JAX package's CLIs on the CPU (gather warps, --corrMode jnp; adapt and "
                    "adapt_continual in the host session; conv precision per row), over the list files of "
                    "chip_smoke.write_cli_list. runs: phase 9's; phase10_runs: adapt_continual (its "
                    "proxy column the scene's gt; epe and d1 read back from series.csv, 3 decimals; "
                    "fetch_counter from histogram.csv), and train then evaluate at highest; demo_runs: the "
                    "JAX demo headless in its host session, epe and d1 of the PNGs it writes "
                    "(chip_smoke.demo_png_metrics), from the weights (the row) and from each of "
                    "chip_smoke.DEMO_SEEDS starting points (seeds; chip_smoke.perturbed_weights). "
                    "wall_s: each run's main(), one after another in one process.")
    doc.setdefault("runs", {}).update(rows)
    doc.setdefault("phase10_runs", {}).update(phase10_rows)
    doc.setdefault("demo_runs", {}).update(demo_rows)
    path.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {path}")
    return 0


def main_kitti(path: Path) -> int:
    """The file's ``kitti_runs``: every run of chip_smoke.KITTI_REFERENCE_RUNS."""
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in chip_smoke.KITTI_REFERENCE_RUNS:
            runs[name] = run_kitti(name, tmp)
            print(name, {s: (r["frames"], r["avg_d1"], r["avg_epe"]) for s, r in runs[name]["rows"].items()},
                  f"{runs[name]['wall_s']:.1f} s", flush=True)
    doc = json.loads(path.read_text()) if path.exists() else {}
    doc["kitti_command"] = f"{COMMAND} --kitti"
    doc["kitti_about"] = ("kitti_runs: the JAX tool tools/kitti_eval.py (main, its lists and rows) over "
                          "chip_smoke.write_kitti_tree on the CPU, its runner (cli/adapt.py, or "
                          "cli/adapt_continual.py with --proxyRoot) given the argv the tool builds plus "
                          "runner_flags; rows as the tool rounds them, with the runner's unrounded averages. "
                          "wall_s: the tool's main, one run after another in one process.")
    doc["kitti_runs"] = runs
    path.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {path}")
    return 0


def run_parity_set(name: str) -> dict:
    """Set ``name`` of ``chip_smoke.PARITY_SETS`` through the JAX tool's
    ``run_our_loop`` (exact) in NONE, MAD and FULL."""
    import jax

    from real_time_self_adaptive_deep_stereo_tpu.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_tpu.utils.checkpoint import load_params

    kind, h, w, frames, scenes, weights = chip_smoke.PARITY_SETS[name]
    jtool = chip_smoke.load_tool("parity_results")
    if weights is None:
        params = get_stereo_net("MADNet").init(jax.random.PRNGKey(0))
    else:
        params = load_params(str(weights))
    params = jax.tree_util.tree_map(np.asarray, params)
    if kind == "synthetic":
        make_sequence = chip_smoke.load_tool("torch_validate_adaptation").make_sequence
        seq = make_sequence(h, w, frames, seed=7, d_bg=8.0, d_fg=20.0)
        sequence = (f"make_sequence({h}, {w}, {frames}, seed=7, d_bg=8.0, d_fg=20.0) of "
                    "tools/torch_validate_adaptation.py")
    else:
        seq = chip_smoke.load_tool("realworld_parity").load_fixture_sequence(frames, h, w, set(scenes))
        sequence = f"load_fixture_sequence({frames}, {h}, {w}, set({list(scenes)})) of tools/realworld_parity.py"
    modes = {}
    for mode in ("NONE", "MAD", "FULL"):
        t0 = time.perf_counter()
        rows, resets = jtool.run_our_loop(mode, seq, params)
        modes[mode] = {"rows": rows.tolist(), "resets": int(resets), "wall_s": time.perf_counter() - t0}
        print(f"{name} {mode}: mean (EPE, bad3, D1) {rows.mean(axis=0).tolist()}, resets {resets}, "
              f"{modes[mode]['wall_s']:.1f} s", flush=True)
    return {"kind": kind, "height": h, "width": w, "frames": frames, "scenes": list(scenes) if scenes else None,
            "weights": portable([str(weights)])[0] if weights else "the JAX MADNet's init from PRNGKey(0)",
            "sequence": sequence, "modes": modes}


def main_parity(names) -> int:
    """``chip_smoke.PARITY_REFERENCE``'s sets ``names``, the others kept."""
    unknown = set(names) - set(chip_smoke.PARITY_SETS)
    if unknown:
        raise SystemExit(f"unknown sets {sorted(unknown)}")
    path = chip_smoke.PARITY_REFERENCE
    doc = json.loads(path.read_text()) if path.exists() else {}
    doc["command"] = f"{COMMAND} --parity"
    doc["about"] = ("The JAX tool tools/parity_results.py's run_our_loop on the CPU, exact (gather warps, "
                    "corr_mode jnp, highest), SEQUENTIAL, lr 1e-4, SSIMTh 0.5, seed 0: per set and mode the "
                    "per-frame [EPE, bad3, D1] rows (bad3 a fraction, D1 in percent) and the reset count. "
                    "wall_s: each loop, one after another in one process.")
    doc.setdefault("sets", {})
    for name in names:
        doc["sets"][name] = run_parity_set(name)
    doc["sets"] = {n: doc["sets"][n] for n in chip_smoke.PARITY_SETS if n in doc["sets"]}
    path.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
