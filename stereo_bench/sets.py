"""Runs of cells in separate processes, as the benchmark's checks make
them, and the spread of each metric.

    python3 stereo_bench/sets.py --workloads A,B --seeds 11,12,13 [--sets 2] [--seconds S] [--trace 0|1]

For each cell, ``--sets`` sets of one run a seed (the same seeds in each
set), each run ``run.py`` in a new process. Prints every result line, then
per cell and metric the median of each set and the spread, the distance
between the quartiles (``statistics.quantiles(values, n=4)``) over the
median, of each set. Writes the lines under ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def spread(values):
    if len(values) < 2:
        return float("nan")
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workloads", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=None, help="default: BENCHMARK.json's run_seconds")
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seconds = args.seconds or json.loads((HERE.parent / "BENCHMARK.json").read_text())["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    rc = 0
    for w in args.workloads.split(","):
        runs = []
        for k in range(args.sets):
            for seed in seeds:
                cmd = [sys.executable, str(HERE / "run.py"), "--workload", w, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(args.trace)]
                p = subprocess.run(cmd, capture_output=True, text=True)
                line = p.stdout.strip().splitlines()[-1] if p.returncode == 0 and p.stdout.strip() else ""
                diag = [s for s in p.stderr.splitlines() if s.startswith("stereo_bench:")]
                print(f"{w} set {k} seed {seed} rc {p.returncode} {line}", flush=True)
                for s in diag:
                    print(f"  {s}", flush=True)
                if out:
                    out.write(json.dumps({"workload": w, "set": k, "seed": seed, "rc": p.returncode,
                                          "result": json.loads(line) if line else None, "stderr": p.stderr[-4000:]}) + "\n")
                    out.flush()
                if not line:
                    rc = 1
                    print(p.stderr[-3000:], flush=True)
                    continue
                r = json.loads(line)
                rc |= 0 if r["correct"] else 1
                runs.append((k, r))
        names = sorted({m for _, r in runs for m in r["metrics"]})
        for m in names:
            per = [[r["metrics"][m]["value"] for k, r in runs if k == s and m in r["metrics"]] for s in range(args.sets)]
            med = [statistics.median(v) if v else float("nan") for v in per]
            print(f"{w} {m}: medians {med} spreads {[spread(v) for v in per]} values {per}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
