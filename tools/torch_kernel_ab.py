#!/usr/bin/env python3
"""Hold one of the port's kernels against other checkouts' on one GPU.

    python3 tools/torch_kernel_ab.py [--time-only] KERNEL OTHER_CHECKOUT [OTHER_CHECKOUT ...]

KERNEL is one of:

* ``corr_bwd``: the correlation backward, ``corr_bwd`` at MADNet's five
  radius-2 calls and ``corr_bwd_wide`` at DispNet-Corr1D's radius-40 call
  and the wide kernels' check shapes, fp32 and bf16; the same bits
  asserted.
* ``corr_fwd_wide``: the wide correlation forward at the same radius-40
  shapes and, forced, at MADNet's five radius-2 shapes, fp32 and bf16;
  the same bits asserted.
* ``warp_image_bwd``: K4 at [1,3,320,1216] and ``max_disp`` 192 (offsets
  as ``chip_smoke.py`` makes them, and a frame whose every output samples
  left of the row, onto column 0) and at [2,5,9,150], ``max_disp`` 40, in
  each variant (both gradients, ``dimg`` alone, ``ddisp`` alone). Asserted:
  the same ``ddisp`` bits, the same ``dimg`` bits but in column 0, whose
  sum the kernel may take in another order, and column 0 within 1e-5 of
  the largest ``dimg`` entry.

Builds each other checkout's source of the kernel
(``csrc/correlation.cu`` or ``csrc/warp.cu``) with the flags of
``ops/cuda_lib.py`` (one ``nvcc`` each, all started together) and loads it
beside this checkout's, then times the two in turns (this, the others,
the others backwards, this) as ``chip_smoke.py`` times a kernel: warm
(``ms``) and after a write over twice the L2 (``cold_ms``). Prints one
JSON object a case (``other_ms``, ``other_cold_ms``: a pair a checkout, in
the order given), and the card's name and power limit. Needs a CUDA
device; raises where two differ. ``--time-only`` skips the checks, for
sources that are cut down to time a part of a kernel (their outputs are
then meaningless).
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

LIBRARY = {"corr_bwd": "correlation", "corr_fwd_wide": "correlation", "warp_image_bwd": "warp"}
PTXAS = {"corr_bwd": "corr_bwd", "corr_fwd_wide": "corr_fwd_wide_kernel", "warp_image_bwd": "warp_bwd_"}


def other_library(n: int, other: Path, kernel: str) -> ctypes.CDLL:
    name = LIBRARY[kernel]
    src = other / "real_time_self_adaptive_deep_stereo_torch" / "csrc" / f"{name}.cu"
    out = ROOT / "build" / "torch_kernels_other" / f"lib{name}{n}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(out), str(src)],
                          check=True, capture_output=True, text=True)
    print(f"ptxas {other}: {'; '.join(cuda_lib.ptxas_usage(proc.stderr, PTXAS[kernel]))}", flush=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in cuda_lib._SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def correlation_cases(kernel: str):
    """(row, ours, theirs(lib), outputs of theirs, check): each case of a
    correlation kernel, fp32 and bf16."""
    cases = [((1, c, cs.H // f, cs.W // f), cs.RADIUS) for c, f in cs.CORR_LEVELS]
    cases += [(cs.DN_CORR_SHAPE, cs.DN_RADIUS)] + [(sh, cs.DN_RADIUS) for sh in cs.WIDE_CHECK_SHAPES]
    for i, (shape, radius) in enumerate(cases):
        k = 2 * radius + 1
        for dtype in (torch.float32, torch.bfloat16):
            x = cs.seeded(shape, 10 + i).to(dtype)
            y = cs.seeded(shape, 20 + i).to(dtype)
            g = cs.seeded((shape[0], k, *shape[2:]), 60 + i).to(dtype)
            bf16 = "_bf16" if dtype == torch.bfloat16 else ""
            if kernel == "corr_bwd":
                name = "corr_bwd" + ("_wide" if radius > MAX_REGISTER_RADIUS else "") + bf16
                outs = (torch.empty_like(x), torch.empty_like(y))
                args = (x.data_ptr(), y.data_ptr(), g.data_ptr(), *(o.data_ptr() for o in outs))
                ours = lambda x=x, y=y, g=g, r=radius: ops.correlation_bwd_cuda(x, y, g, r)  # noqa: E731
            else:
                name = "corr_fwd_wide" + bf16
                outs = (torch.empty((shape[0], k, *shape[2:]), device=x.device, dtype=dtype),)
                args = (x.data_ptr(), y.data_ptr(), outs[0].data_ptr())
                ours = lambda x=x, y=y, r=radius: (ops.correlation_cuda(x, y, r, wide=True),)  # noqa: E731

            def theirs(lib, name=name, args=args, shape=shape, radius=radius, dev=x.device):
                def run():
                    cuda_lib.check(lib, getattr(lib, name)(*args, *shape, radius, cuda_lib.stream_ptr(dev)), name)
                return run

            def check(got, want, name=name, shape=shape):
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{name} {shape}: the two kernels differ")
            yield {"name": name, "shape": list(shape), "radius": radius}, ours, theirs, outs, check


def piled_left(shape, max_disp):
    """Offsets that put every output's sample left of the row, onto column
    0: d = x + u, u in [0, 3), a third of them within one column of it
    (as far as max_disp lets them)."""
    xs = torch.arange(shape[3], device="cuda", dtype=torch.float32)
    u = cs.seeded((shape[0], 1, shape[2], shape[3]), 33, 0.0, 3.0)
    u[..., ::3] *= 0.3
    return (xs + u).clamp(max=float(max_disp))


def warp_cases():
    """Each case and variant of K4, as :func:`correlation_cases`."""
    for shape, max_disp, kind in [((1, 3, cs.H, cs.W), cs.MAX_DISP, "chip_smoke"),
                                  ((1, 3, cs.H, cs.W), cs.MAX_DISP, "piled left"),
                                  ((2, 5, 9, 150), 40, "chip_smoke")]:
        img = cs.seeded(shape, 30)
        disp = (cs.seeded((shape[0], 1, *shape[2:]), 31, -20.0, max_disp + 40.0) if kind == "chip_smoke"
                else piled_left(shape, max_disp))
        g = cs.seeded(shape, 70)
        for variant, (need_img, need_disp) in cs.VARIANTS.items():
            outs = (torch.empty_like(img), torch.empty_like(disp))
            args = (img.data_ptr(), disp.data_ptr(), g.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr())

            def ours(img=img, disp=disp, g=g, m=max_disp, need=(need_img, need_disp)):
                return ops.warp_image_bwd_cuda(img, disp, g, m, *need)

            def theirs(lib, args=args, shape=shape, m=max_disp, need=(need_img, need_disp), dev=img.device):
                def run():
                    err = lib.warp_image_bwd(*args, *shape, float(m), int(need[0]), int(need[1]),
                                             cuda_lib.stream_ptr(dev))
                    cuda_lib.check(lib, err, "warp_image_bwd")
                return run

            def check(got, want, need=(need_img, need_disp), shape=shape):
                dimg, ddisp = got
                if need[1] and not torch.equal(ddisp, want[1]):
                    raise AssertionError(f"warp_image_bwd {shape}: ddisp differs")
                if need[0]:
                    if not torch.equal(dimg[..., 1:], want[0][..., 1:]):
                        raise AssertionError(f"warp_image_bwd {shape}: dimg differs beyond column 0")
                    err = float((dimg[..., 0] - want[0][..., 0]).abs().max())
                    if not err <= cs.BWD_RTOL * float(want[0].abs().max()):
                        raise AssertionError(f"warp_image_bwd {shape}: column 0 differs by {err}")
                    print(f"warp_image_bwd {shape} {kind}: column 0 differs by {err!r}", flush=True)
            row = {"name": "warp_image_bwd", "shape": list(shape), "max_disp": max_disp, "offsets": kind,
                   "variant": variant}
            yield row, ours, theirs, outs, check


def main() -> int:
    args = sys.argv[1:]
    time_only = "--time-only" in args
    args = [a for a in args if a != "--time-only"]
    if len(args) < 2 or args[0] not in LIBRARY:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    kernel = args[0]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    paths = [Path(a).resolve() for a in args[1:]]
    with ThreadPoolExecutor(len(paths)) as pool:
        others = list(pool.map(other_library, range(len(paths)), paths, [kernel] * len(paths)))
    cases = warp_cases() if kernel == "warp_image_bwd" else correlation_cases(kernel)
    for row, ours, theirs_of, outs, check in cases:
        theirs = [theirs_of(lib) for lib in others]
        got = ours()
        for n, fn in enumerate(theirs):
            fn()
            torch.cuda.synchronize()
            if not time_only:
                check(got, outs)
        row["same_bits_checked"] = not time_only
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
