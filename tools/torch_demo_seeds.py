#!/usr/bin/env python3
"""The port's live demo at full width from several starting points, against
the JAX demo's rows.

    python tools/torch_demo_seeds.py [--device cuda|cpu] [--session host|fused]
                                     [--route kernels|plain] [--cudnn-deterministic]
                                     [--seeds N] [--first SEED] [--threads N]

Runs ``cli/demo.py``'s ``main`` headless over ``chip_smoke.py`` phase 11's
full-width run (32 frames of scenes 2-3 at 320x1216, MAD SEQUENTIAL, Adam)
from ``--seeds`` starting points of
``chip_smoke.perturbed_weights`` from ``--first`` on, and prints each run's 32-frame D1 of the
written PNGs beside the JAX demo's from the same weights
(``demo_runs`` of ``tests/fixtures/torch_cli_reference.json``), then the
medians. ``--route plain`` swaps the correlation and warp kernels for
their plain versions on the card; ``--cudnn-deterministic`` sets
``torch.backends.cudnn.deterministic``; ``--threads`` sets PyTorch's
intra-op threads (on a CPU the demo takes about a minute a run).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default where there is one) or cpu")
    ap.add_argument("--session", default="host", choices=["host", "fused"])
    ap.add_argument("--route", default="kernels", choices=["kernels", "plain"])
    ap.add_argument("--cudnn-deterministic", action="store_true")
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--first", type=int, default=0, help="the first starting point")
    ap.add_argument("--threads", type=int, default=None)
    args = ap.parse_args()

    import torch

    import chip_smoke
    from real_time_self_adaptive_deep_stereo_torch.cli import demo

    if args.threads:
        torch.set_num_threads(args.threads)
    torch.backends.cudnn.deterministic = args.cudnn_deterministic
    if args.route == "plain":
        corr = importlib.import_module("real_time_self_adaptive_deep_stereo_torch.ops.correlation")
        warps = importlib.import_module("real_time_self_adaptive_deep_stereo_torch.ops.warp_kernels")
        corr.resolve_corr_mode = lambda *a: "torch"
        warps.resolve_warp_mode = lambda mode, device: "clamped"
    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    rows = json.loads(chip_smoke.CLI_REFERENCE.read_text())["demo_runs"]["demo_scene_MAD"]["seeds"]
    port, ref = [], []
    with tempfile.TemporaryDirectory() as tmp:
        lst = chip_smoke.write_cli_list(tmp, chip_smoke.CLI_SCENES["scene"], chip_smoke.DEMO_FRAMES)
        for seed in range(args.first, args.first + args.seeds):
            out = str(Path(tmp) / f"seed{seed}")
            argv = [*chip_smoke.DEMO_FLAGS, "--list", lst, "--outDir", out, "--maxFrames",
                    str(chip_smoke.DEMO_FRAMES), *chip_smoke.DEMO_REFERENCE_RUNS["demo_scene_MAD"],
                    "--sessionMode", args.session, "--weights", chip_smoke.perturbed_weights(seed, tmp)]
            demo.main(demo.build_argparser().parse_args(argv), device=device)
            _, _, d1 = chip_smoke.demo_png_metrics(out, lst)
            port.append(float(d1.mean()))
            ref.append(rows[seed]["avg_d1"])
            print(f"seed {seed}: D1 {port[-1]:.3f}, the JAX demo's {ref[-1]:.3f} "
                  f"(delta {port[-1] - ref[-1]:+.3f}); first 3 frames less the JAX demo's "
                  f"{np.round(d1[:3] - np.asarray(rows[seed]['d1'][:3]), 4).tolist()}", flush=True)
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    print(json.dumps({"device": name, "session": args.session, "route": args.route,
                      "cudnn_deterministic": args.cudnn_deterministic, "threads": torch.get_num_threads(),
                      "d1": port, "jax_d1": ref, "median": float(np.median(port)),
                      "jax_median": float(np.median(ref))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
