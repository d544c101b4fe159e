"""ctypes bindings and build-at-first-use of the native C++ stereo loader.

Port of ``real_time_self_adaptive_deep_stereo_tpu/runtime/native.py``. The
library is compiled from ``stereo_loader.cc`` on first use with
``g++ -O3 -fPIC -shared -std=c++17`` into ``build/native_loader/`` beside
the package (git-ignored), named by a digest of the source and the flags,
never next to the source. The source picks its decode route from the
headers the compiler finds (libpng, or its own PNG decoder on zlib or on
its own inflate; JPEG only with libjpeg); :func:`route` names it, and only
the libraries that route needs are linked. Where ``g++`` fails,
``available()`` is False, :func:`build_error` says why, and
``StereoDataset(backend="auto")`` decodes in Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["available", "build_error", "route", "NativeStereoLoader"]

SRC = Path(__file__).resolve().parent / "stereo_loader.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native_loader"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
# what each PNG route (the source's SL_PNG_ROUTE) links
_ROUTE_LIBS = {1: ("-lpng",), 2: ("-lz",), 3: ()}

_libs: Dict[Tuple[str, ...], ctypes.CDLL] = {}
_errors: Dict[Tuple[str, ...], str] = {}
_lock = threading.Lock()


def _macros(defines: Sequence[str]) -> Tuple[int, int]:
    """(SL_PNG_ROUTE, SL_HAVE_JPEG) as the compiler resolves them with
    ``defines``: the source's own ``__has_include`` tests, preprocessed."""
    proc = subprocess.run(
        ["g++", "-std=c++17", "-dM", "-E", *defines, str(SRC)],
        capture_output=True, text=True, timeout=120,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ -E failed on {SRC.name}:\n{proc.stderr[-2000:]}")
    found = dict(re.findall(r"^#define (SL_PNG_ROUTE|SL_HAVE_JPEG) (\d)$", proc.stdout, re.M))
    return int(found["SL_PNG_ROUTE"]), int(found["SL_HAVE_JPEG"])


def _build(defines: Tuple[str, ...]) -> Path:
    png_route, jpeg = _macros(defines)
    libs = (*_ROUTE_LIBS[png_route], *(("-ljpeg",) if jpeg else ()), "-lpthread")
    flags = (*CXX_FLAGS, *defines)
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(flags + libs).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libstereo_loader-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        ["g++", *flags, str(SRC), "-o", str(tmp), *libs], capture_output=True, text=True, timeout=240
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed on {SRC.name} (PNG route {png_route}, JPEG {jpeg}, linking {' '.join(libs)}):\n"
            f"{proc.stderr[-2000:]}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


def _load(defines: Sequence[str] = ()) -> Optional[ctypes.CDLL]:
    """The library built with ``defines`` (``-D`` flags; the tests force
    the source's own decoders with them), or None with the reason in
    :func:`build_error`. Prints one line naming the route when it loads."""
    key = tuple(defines)
    with _lock:
        if key in _libs or key in _errors:
            return _libs.get(key)
        try:
            path = _build(key)
            lib = ctypes.CDLL(str(path))
        except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
            _errors[key] = str(e)
            return None
        lib.sl_create.restype = ctypes.c_void_p
        lib.sl_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.sl_destroy.argtypes = [ctypes.c_void_p]
        lib.sl_submit.restype = ctypes.c_long
        lib.sl_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64,
        ]
        lib.sl_next.restype = ctypes.c_int
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.sl_next.argtypes = [
            ctypes.c_void_p, f32p, f32p, f32p, f32p,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.sl_last_error.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.sl_route.restype = ctypes.c_char_p
        _libs[key] = lib
        print(f"native loader: {lib.sl_route().decode()} ({path.name}{' ' + ' '.join(key) if key else ''})",
              flush=True)
        return lib


def available() -> bool:
    """True if the native loader built (or builds) successfully."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the loader did not build (the route it tried, the compiler's
    message), or None where it did."""
    _load()
    return _errors.get(())


def route() -> Optional[str]:
    """The decode route the loader was built with, for example ``"PNG by
    libpng, JPEG by libjpeg"``; None where it did not build."""
    lib = _load()
    return None if lib is None else lib.sl_route().decode()


class NativeStereoLoader:
    """Threaded native decode pipeline with in-order delivery.

    Usage::

        nl = NativeStereoLoader(workers=4, crop_shape=(320, 1216))
        for paths in samples:
            nl.submit(left, right, gt, proxy, train=False, seed=i)
        for _ in samples:
            sample = nl.next()   # dict of float32 arrays

    ``defines`` are extra ``-D`` flags for the library's build (a second
    copy is built for each set): the tests pass ``-DSL_FORCE_OWN_PNG`` and
    ``-DSL_FORCE_OWN_INFLATE`` to hold the source's own PNG decoder and
    inflate against libpng.
    """

    def __init__(self, workers: int = 4, crop_shape=(320, 1216), capacity: int = 16,
                 defines: Sequence[str] = ()):
        lib = _load(defines)
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_errors.get(tuple(defines))}")
        self._lib = lib
        self._h, self._w = int(crop_shape[0]), int(crop_shape[1])
        self._ptr = lib.sl_create(workers, capacity)
        self._lock = threading.Lock()

    def submit(
        self,
        left: str,
        right: str,
        gt: str = "",
        proxy: str = "",
        train: bool = False,
        seed: int = 0,
    ) -> int:
        return self._lib.sl_submit(
            self._ptr,
            left.encode(), right.encode(), gt.encode(), proxy.encode(),
            self._h, self._w, 1 if train else 0, seed,
        )

    def next(self) -> dict:
        h, w = self._h, self._w
        left = np.empty((h, w, 3), np.float32)
        right = np.empty((h, w, 3), np.float32)
        gt = np.empty((h, w, 1), np.float32)
        proxy = np.empty((h, w, 1), np.float32)
        has_proxy = ctypes.c_int(0)
        rw = self._lib.sl_next(
            self._ptr,
            left, right, gt.reshape(h, w), proxy.reshape(h, w),
            ctypes.byref(has_proxy),
        )
        if rw == -2:
            raise RuntimeError("loader shut down")
        if rw == -1:
            msg = ctypes.create_string_buffer(4096)
            self._lib.sl_last_error(self._ptr, msg, len(msg))
            raise IOError(f"native loader failed to decode a sample: {msg.value.decode(errors='replace')}")
        out = {
            "left": left,
            "right": right,
            "target": gt,
            "real_width": np.int32(rw),
        }
        if has_proxy.value:
            out["proxy"] = proxy
        return out

    def close(self) -> None:
        with self._lock:
            if self._ptr:
                self._lib.sl_destroy(self._ptr)
                self._ptr = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
