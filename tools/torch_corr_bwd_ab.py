#!/usr/bin/env python3
"""Hold the port's correlation backward kernels against other checkouts', on one GPU.

    python3 tools/torch_corr_bwd_ab.py [--time-only] OTHER_CHECKOUT [OTHER_CHECKOUT ...]

Builds each other checkout's ``csrc/correlation.cu`` with the flags of
``ops/cuda_lib.py`` (one ``nvcc`` each, all started together) and loads it
beside this checkout's. At the shapes of
``chip_smoke.py`` (MADNet's five radius-2 calls, DispNet-Corr1D's
radius-40 call and the wide kernels' check shapes), in fp32 and bf16, it
asserts that ``corr_bwd``/``corr_bwd_wide`` (and their ``_bf16``
instances) of every checkout give the same bits on the same inputs, and
times them in turns (this, the others, the others backwards, this) as
``chip_smoke.py`` times a kernel: warm (``ms``) and after a write over
twice the L2 (``cold_ms``). Prints one JSON object a shape and dtype
(``other_ms``, ``other_cold_ms``: a pair a checkout, in the order given),
and the card's name and power limit. Needs a CUDA device; raises where
two differ. ``--time-only`` skips that check, for sources that are cut
down to time a part of a kernel (their outputs are then meaningless).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from real_time_self_adaptive_deep_stereo_torch import ops  # noqa: E402
from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib  # noqa: E402
from real_time_self_adaptive_deep_stereo_torch.ops.correlation import MAX_REGISTER_RADIUS  # noqa: E402


def other_library(n: int, other: Path) -> ctypes.CDLL:
    src = other / "real_time_self_adaptive_deep_stereo_torch" / "csrc" / "correlation.cu"
    out = ROOT / "build" / "torch_kernels_other" / f"libcorrelation{n}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(out), str(src)],
                          check=True, capture_output=True, text=True)
    print(f"ptxas {other}: {'; '.join(cuda_lib.ptxas_usage(proc.stderr, 'corr_bwd'))}", flush=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in cuda_lib._SIGNATURES["correlation"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    args = sys.argv[1:]
    time_only = "--time-only" in args
    args = [a for a in args if a != "--time-only"]
    if not args:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_corr_bwd_ab: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    paths = [Path(a).resolve() for a in args]
    with ThreadPoolExecutor(len(paths)) as pool:
        others = list(pool.map(other_library, range(len(paths)), paths))
    cases = [((1, c, cs.H // f, cs.W // f), cs.RADIUS) for c, f in cs.CORR_LEVELS]
    cases += [(cs.DN_CORR_SHAPE, cs.DN_RADIUS)] + [(sh, cs.DN_RADIUS) for sh in cs.WIDE_CHECK_SHAPES]
    for i, (shape, radius) in enumerate(cases):
        k = 2 * radius + 1
        for dtype in (torch.float32, torch.bfloat16):
            x = cs.seeded(shape, 10 + i).to(dtype)
            y = cs.seeded(shape, 20 + i).to(dtype)
            g = cs.seeded((shape[0], k, *shape[2:]), 60 + i).to(dtype)
            name = ("corr_bwd" + ("_wide" if radius > MAX_REGISTER_RADIUS else "")
                    + ("_bf16" if dtype == torch.bfloat16 else ""))
            dx, dy = torch.empty_like(x), torch.empty_like(y)

            def launcher(lib):
                def theirs():
                    err = getattr(lib, name)(
                        x.data_ptr(), y.data_ptr(), g.data_ptr(), dx.data_ptr(), dy.data_ptr(),
                        *shape, radius, cuda_lib.stream_ptr(x.device))
                    cuda_lib.check(lib, err, name)
                return theirs

            def ours():
                return ops.correlation_bwd_cuda(x, y, g, radius)

            theirs = [launcher(lib) for lib in others]
            got = ours()
            for n, fn in enumerate(theirs):
                fn()
                torch.cuda.synchronize()
                if not time_only and not (torch.equal(got[0], dx) and torch.equal(got[1], dy)):
                    raise AssertionError(f"{name} {shape}: this checkout's kernel and {paths[n]}'s differ")
            row = {"name": name, "shape": list(shape), "radius": radius, "same_bits": not time_only}
            for tag, timer in (("ms", cs.time_ms), ("cold_ms", cs.cold_ms)):
                first = timer(ours)
                there = [timer(fn) for fn in theirs]
                back = [timer(fn) for fn in reversed(theirs)][::-1]
                row[tag] = [first, timer(ours)]
                row["other_" + tag] = [[a, b] for a, b in zip(there, back)]
            print(json.dumps(row), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
