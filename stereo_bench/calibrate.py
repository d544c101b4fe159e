"""The readings that the output check's limits are set from, on the card.

    python3 stereo_bench/calibrate.py --workload NAME --seeds 1,2,... [--control-seeds 1,2,3]
        [--fault-seeds 1,2,3 --faults frozen,altered] [--seconds 3]

In one process, the cell at its own size and load, with a short window:
the program as the configuration states it on every seed of ``--seeds``,
then the control on ``--control-seeds``: the program's own lower-precision
path, TF32 on cuDNN (the port's ``default`` precision), the step below the
configuration's fp32 with TF32 off. Prints each run's numbers, then per
number the largest sound reading (the lower one) and the smallest control
reading (the upper one), and, with ``--faults``, each planted fault's
readings (``faults.py``) on ``--fault-seeds``. The benchmark's own runs
never run the control or a fault.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CONTROL = "default"  # TF32 on cuDNN: the step below fp32 with TF32 off


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from stereo_bench.faults import planted
    from stereo_bench.harness import run_cell

    torch.set_num_threads(1)
    plan = [("sound", args.seeds, None, None), ("control", args.control_seeds, CONTROL, None)]
    plan += [(f, args.fault_seeds, None, f) for f in args.faults.split(",") if f]
    readings = {kind: [] for kind, *_ in plan}
    for kind, seeds, precision, fault in plan:
        for seed in [int(s) for s in seeds.split(",") if s]:
            with planted(fault) if fault else contextlib.nullcontext():
                r = run_cell(args.workload, seed, args.seconds, False, args.device, precision=precision)
            values = {k: v["value"] for k, v in r["checks"].items()}
            readings[kind].append(values)
            print(json.dumps({"kind": kind, "seed": seed, "correct": r["correct"], "checks": values,
                              "frames_per_s": r["metrics"]["frames_per_s"]["value"]}), flush=True)
            del r
            gc.collect()
            if args.device == "cuda":
                torch.cuda.empty_cache()
    for name in readings["sound"][0] if readings["sound"] else []:
        lower = max(v[name] for v in readings["sound"])
        others = {kind: min(v[name] for v in vs) for kind, vs in readings.items() if kind != "sound" and vs}
        print(f"{args.workload} {name}: lower {lower!r}, least of each: {others}; "
              f"all {[(kind, [v[name] for v in vs]) for kind, vs in readings.items()]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
