"""A PNG codec on ``zlib`` and numpy, for the frames and disparities that
the readers and the CLIs read and write.

It stands in for ``cv2.imread`` / ``cv2.imwrite`` in the JAX package's
``data/readers.py`` and ``utils/visual.py``, so that the port needs no
image library. :func:`read_png` takes non-interlaced 8-bit grey, RGB and
RGBA, and 16-bit grey (KITTI's disparity encoding), with any of the five
row filters and the image data split over any number of IDAT chunks. It
returns what the JAX reader returns after its BGR->RGB flip: uint8
``[H,W]``, ``[H,W,3]`` or ``[H,W,4]``, or uint16 ``[H,W]``.
:func:`write_png` writes uint16 and uint8 grey and uint8 RGB, every row
with filter 0.

The Average and Paeth filters predict a byte from the decoded pixels to
its left, above and above-left, so a row cannot be decoded in one numpy
operation. The decoder sweeps anti-diagonals instead: pixel (y, x) needs
only pixels on diagonal x + y - 1 and x + y - 2, so each diagonal is one
vectorised step over its rows, W + H - 1 steps for the image.
"""

from __future__ import annotations

import functools
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["png_size", "read_png", "read_pngs", "write_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels: grey, RGB, RGBA (palette and grey+alpha are not taken)
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes, path: str):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        yield kind, data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


_SPAN = 511  # a - c and b - c lie in [-255, 255]


@functools.lru_cache(maxsize=None)
def _predictor_table() -> np.ndarray:
    """The prediction less c, for filters Sub, Up, Average and Paeth (rows
    0-3), at every (a - c, b - c): the flat index is
    ``(filter - 1) * 511**2 + (a - c + 255) * 511 + (b - c + 255)``. All
    four are functions of the two differences alone (Average's
    ``(a + b) >> 1`` is ``c + (a - c + b - c) >> 1``), so one lookup serves
    every filter, and Paeth's comparisons become a gather."""
    ac = np.arange(-255, 256, dtype=np.int32)[:, None]
    bc = np.arange(-255, 256, dtype=np.int32)[None, :]
    pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(ac + bc)
    paeth = np.where((pa <= pb) & (pa <= pc), ac, np.where(pb <= pc, bc, 0))
    table = np.stack(np.broadcast_arrays(ac, bc, (ac + bc) >> 1, paeth))
    return np.ascontiguousarray(table, dtype=np.int32).reshape(-1)


def _skewed(t: np.ndarray, h: int, w: int) -> np.ndarray:
    """The ``[H, W, B]`` view of a diagonal-major array ``t`` whose entry
    ``[d + 1, y + 1]`` holds pixel (y, x = d - y)."""
    nb = t.shape[2]
    item = t.itemsize
    return np.lib.stride_tricks.as_strided(
        t[1, 1:], shape=(h, w, nb), strides=((t.shape[1] + 1) * nb * item, t.shape[1] * nb * item, item)
    )


def _unfilter_diagonals(scan: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Any mix of the five filters, by an anti-diagonal sweep. ``scan`` is
    ``[H, W, B]`` uint8 and ``filters`` ``[H, B]``: the bytes of a pixel of
    several images of one size, side by side, each with its own rows'
    filters, so that one sweep decodes them all.

    ``t[d + 1, y + 1]`` holds pixel (y, d - y); row 0 (the row above the
    image) and the entries left of column 0 stay zero, which is what the
    filters read there. On diagonal d, pixel (y, x)'s left neighbour a is
    ``t[d, y + 1]``, the one above b ``t[d, y]`` and the one above-left c
    ``t[d - 1, y]``. A step is a lookup in :func:`_predictor_table`."""
    h, w, nb = scan.shape
    n_diag = w + h - 1
    scan = scan.astype(np.int32)
    filters = filters.astype(np.int32)
    none = filters == 0
    if none.any():
        # a None row is the Sub row whose bytes are its differences
        diff = scan.copy()
        diff[:, 1:] -= scan[:, :-1]
        scan = np.where(none[:, None, :], diff & 255, scan)
        filters = np.where(none, 1, filters)
    table = _predictor_table()
    offset = (filters - 1) * _SPAN * _SPAN + 255 * _SPAN + 255  # [H, B]
    raw = np.zeros((n_diag + 1, h + 1, nb), np.int32)
    _skewed(raw, h, w)[...] = scan
    t = np.zeros_like(raw)
    for d in range(n_diag):
        y0, y1 = max(0, d - w + 1), min(h - 1, d) + 1
        a = t[d, y0 + 1 : y1 + 1]
        b = t[d, y0:y1]
        c = t[d - 1, y0:y1]  # t[-1] is still all zero when d = 0
        idx = (a - c) * _SPAN + b - c + offset[y0:y1]
        out = t[d + 1, y0 + 1 : y1 + 1]
        np.add(table.take(idx), c, out=out)
        out += raw[d + 1, y0 + 1 : y1 + 1]
        out &= 255
    return _skewed(t, h, w).astype(np.uint8)


def _parse(path: str):
    """(header, row filters [H], scan [H, W, bpp] uint8) of a PNG file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[: len(_SIGNATURE)] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if color not in _CHANNELS:
        raise ValueError(
            f"{path}: PNG colour type {color} is not supported (grey, RGB and RGBA only)"
        )
    channels = _CHANNELS[color]
    if not (depth == 8 or (depth == 16 and channels == 1)):
        raise ValueError(
            f"{path}: {depth}-bit PNG of colour type {color} is not supported "
            "(8-bit grey, RGB, RGBA and 16-bit grey only)"
        )
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: image data holds {raw.size} bytes, want {h * (w * bpp + 1)}")
    rows = raw.reshape(h, w * bpp + 1)
    filters = rows[:, 0]
    if filters.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown PNG row filter {int(filters.max())}")
    return (h, w, depth, channels), filters, rows[:, 1:].reshape(h, w, bpp)


def png_size(path: str) -> Tuple[int, int]:
    """(height, width) of the PNG at ``path`` from its header (IHDR, the
    first chunk), without decoding it."""
    with open(path, "rb") as f:
        head = f.read(len(_SIGNATURE) + 16)
    if head[: len(_SIGNATURE)] != _SIGNATURE or head[len(_SIGNATURE) + 4 : len(_SIGNATURE) + 8] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    w, h = struct.unpack(">II", head[len(_SIGNATURE) + 8 :])
    return h, w


def read_pngs(paths: Sequence[str]) -> List[np.ndarray]:
    """Decode several PNGs (see the module's docstring for what each may
    be and what it gives). Those of one size share one diagonal sweep: a
    stereo frame's left, right and ground-truth images decode in little
    more time than one."""
    parsed = [_parse(p) for p in paths]
    decoded: List[Optional[np.ndarray]] = [None] * len(parsed)
    sweeps: Dict[Tuple[int, int], List[int]] = {}
    for i, ((h, w, _, _), _, _) in enumerate(parsed):
        sweeps.setdefault((h, w), []).append(i)
    for members in sweeps.values():
        scans = [parsed[i][2] for i in members]
        filters = np.concatenate(
            [np.repeat(parsed[i][1][:, None], s.shape[2], axis=1) for i, s in zip(members, scans)],
            axis=1,
        )
        together = _unfilter_diagonals(np.concatenate(scans, axis=2), filters)
        offsets = np.cumsum([0] + [s.shape[2] for s in scans])
        for i, lo, hi in zip(members, offsets[:-1], offsets[1:]):
            decoded[i] = together[..., lo:hi]
    out = []
    for ((h, w, depth, channels), _, _), pixels in zip(parsed, decoded):
        if depth == 16:
            out.append(np.ascontiguousarray(pixels).reshape(h, w * 2).view(">u2").astype(np.uint16))
        else:
            out.append(np.ascontiguousarray(pixels[..., 0] if channels == 1 else pixels))
    return out


def read_png(path: str) -> np.ndarray:
    """Decode the PNG at ``path`` (see the module's docstring for what it
    takes and returns); raises ``ValueError`` on anything else."""
    return read_pngs([path])[0]


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path: str, array: np.ndarray) -> None:
    """Write uint16 ``[H,W]`` grey, uint8 ``[H,W]`` grey or uint8
    ``[H,W,3]`` RGB to ``path`` as a PNG, every row with filter 0."""
    a = np.asarray(array)
    if a.dtype == np.uint16 and a.ndim == 2:
        depth, color, body = 16, 0, a.astype(">u2")
    elif a.dtype == np.uint8 and (a.ndim == 2 or (a.ndim == 3 and a.shape[2] == 3)):
        depth, color, body = 8, (0 if a.ndim == 2 else 2), a
    else:
        raise ValueError(
            f"write_png takes uint16 [H,W], uint8 [H,W] or uint8 [H,W,3]; got {a.dtype} {a.shape}"
        )
    h, w = a.shape[:2]
    rows = body.reshape(h, -1).view(np.uint8)
    filtered = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
