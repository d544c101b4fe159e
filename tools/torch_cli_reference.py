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
    ap.add_argument("--runs", default=",".join(chip_smoke.CLI_REFERENCE_RUNS),
                    help="comma-separated names from chip_smoke.CLI_REFERENCE_RUNS")
    ap.add_argument("--json", default=str(chip_smoke.CLI_REFERENCE))
    ap.add_argument("--strict", action="store_true",
                    help="make the witness rows of the evaluate runs instead (see above)")
    args = ap.parse_args()
    if args.strict:  # before JAX starts: XLA reads its flags once
        os.environ["XLA_FLAGS"] = f"{os.environ.get('XLA_FLAGS', '')} {STRICT_FLAG}".strip()
        names = list(chip_smoke.CLI_WITNESS_RUNS)
    else:
        names = [n for n in args.runs.split(",") if n]
    unknown = set(names) - set(chip_smoke.CLI_REFERENCE_RUNS)
    if unknown:
        raise SystemExit(f"unknown runs {sorted(unknown)}")

    rows, port_rows = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
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
    doc["about"] = ("The JAX package's CLIs on the CPU (gather warps, --corrMode jnp; adapt in "
                    "the host session; conv precision per row), over the list files of "
                    "chip_smoke.write_cli_list. wall_s: each run's main(), one after another "
                    "in one process.")
    doc.setdefault("runs", {}).update(rows)
    path.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
