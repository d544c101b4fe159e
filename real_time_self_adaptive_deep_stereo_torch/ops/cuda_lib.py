"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, and loaded
with ``ctypes``. Nothing is prebuilt: the libraries go into
``build/torch_kernels/`` beside the package (git-ignored), named by a
digest of the source and the flags, so an edited source builds anew.
One ``nvcc`` runs per source, all started together.

Every C entry point takes device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code. ``LAUNCHES`` counts the wrappers'
calls, so a call under CUDA-graph capture counts once, at capture: a
caller that replays graphs records a graph's counts when it captures it
and adds them itself at every replay (``adapt/fused.py`` does). Nothing here runs when the
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

import torch

__all__ = [
    "LAUNCHES", "build_all", "check", "check_float32", "check_same_float", "library",
    "reset_launches", "stream_ptr", "ptxas_usage",
]

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures per library: {function: argtypes}; every function returns int
_SIGNATURES = {
    "correlation": {
        "corr_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
        "corr_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "corr_fwd_wide": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
        "corr_bwd_wide": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        # the bf16 instances of the same four, counted under their own names
        "corr_fwd_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
        "corr_bwd_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "corr_fwd_wide_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
        "corr_bwd_wide_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "warp": {
        "warp_image_fwd": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
        "warp_features_fwd": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
        "warp_image_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
        "warp_features_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _I, _P],
    },
    "warp_tile": {
        "warp_tile_image_fwd": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
        "warp_tile_features_fwd": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
        "warp_tile_image_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
        "warp_tile_features_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _I, _P],
    },
}
# Kernel launches since the last reset_launches(), by kernel name. Each
# wrapper adds one where it launches its kernel, and nowhere else.
LAUNCHES: Dict[str, int] = {fn: 0 for fns in _SIGNATURES.values() for fn in fns}

# ptxas report (registers, spills) of each library built by this process
BUILD_LOGS: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
    if not cand or not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return cand


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile(name: str) -> Path:
    out = _lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    BUILD_LOGS[name] = proc.stderr
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


def build_all() -> Dict[str, Path]:
    """Compile every source in parallel (one nvcc each); returns the paths."""
    with ThreadPoolExecutor(len(_SIGNATURES)) as pool:
        paths = dict(zip(_SIGNATURES, pool.map(_compile, _SIGNATURES)))
    for name in paths:
        library(name)
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>``, built first if needed."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_compile(name)))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def ptxas_usage(log: str, kernel: str) -> list:
    """The lines of an ``nvcc -Xptxas -v`` log that give the registers and
    spills of each entry function whose mangled name holds ``kernel``."""
    out, current = [], ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
        elif kernel in current and ("spill" in line or "registers" in line):
            out.append(line.replace("ptxas info    :", "").strip())
    return out


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def check_float32(what: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is float32, the one type the warp kernels take."""
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{what} takes float32 only, got {[t.dtype for t in tensors]}")


def check_same_float(what: str, *tensors: torch.Tensor) -> torch.dtype:
    """Raise unless the tensors are all float32 or all bfloat16, the two
    types the correlation kernels take; returns that type."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or not dtypes <= {torch.float32, torch.bfloat16}:
        raise TypeError(
            f"{what} takes float32 or bfloat16, all tensors of one type, "
            f"got {[t.dtype for t in tensors]}"
        )
    return dtypes.pop()
