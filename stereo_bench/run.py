"""The benchmark of the PyTorch and CUDA port of real-time self-adaptive
deep stereo: one run of one cell of ``BENCHMARK.json``.

    python3 stereo_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

Prints one JSON object as its last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number of the output check with
its limit (also the last lines of standard error). Exits non-zero, with no
result, where there is no CUDA device or fewer than the cell asks for, or
where JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "real_time_self_adaptive_deep_stereo_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: the port's own name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    # one host thread: the session's host work is serial, and a pool of
    # threads on a shared host only adds their waits to the frame
    torch.set_num_threads(1)

    from stereo_bench.harness import run_cell
    from stereo_bench.spec import Cell, SpecError

    try:
        chips = Cell(args.workload).workload["chips"]
    except SpecError as e:
        print(f"stereo_bench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("stereo_bench: no CUDA device; this benchmark measures the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"stereo_bench: the cell asks for {chips} devices, {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_process=T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"stereo_bench: the run loaded {', '.join(bad)}; the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
