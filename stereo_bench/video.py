"""Seeded synthetic rectified stereo video, in numpy.

Each camera's video is ``frames`` distinct frames, replayed in order and
cyclically by the window. A frame is a window onto a wide texture
panorama of several octaves of value noise (cells of 128 down to 2 px),
which pans by a few pixels a frame, so that the texture drifts. The
disparity is a smooth field of ``0 .. max_disp`` px, a blend of two fields
of low-frequency noise whose weight goes round a cosine over the video,
so that it too drifts slowly and the replay has no seam. The right view
samples the panorama at ``x + d(x)`` (bilinear), so that the left pixel at
``x`` is the right one at ``x - d``; both views get Gaussian noise of
``noise`` grey levels. Frames are NHWC float32 in 0..255.
"""

from __future__ import annotations

import numpy as np
import torch

OCTAVES = (128, 64, 32, 16, 8, 4, 2)


def _upsample(grid: np.ndarray, cell: int, h: int, w: int) -> np.ndarray:
    """Bilinear upsampling of a coarse ``grid`` ([gh, gw, ...]) by ``cell``,
    cut to ``h x w``."""
    def axis(n, g):
        pos = np.arange(n) / cell
        i0 = np.minimum(pos.astype(np.int64), g - 2)
        return i0, (pos - i0).astype(np.float32)

    (y0, ty), (x0, tx) = axis(h, grid.shape[0]), axis(w, grid.shape[1])
    ty = ty.reshape((-1, 1) + (1,) * (grid.ndim - 2))
    tx = tx.reshape((1, -1) + (1,) * (grid.ndim - 2))
    rows = grid[y0] * (1 - ty) + grid[y0 + 1] * ty
    return rows[:, x0] * (1 - tx) + rows[:, x0 + 1] * tx


def _noise(rng, h: int, w: int, cells, channels=None) -> np.ndarray:
    out = 0.0
    for cell in cells:
        shape = (h // cell + 2, w // cell + 2) + (() if channels is None else (channels,))
        out = out + (cell ** 0.7) * _upsample(rng.random(shape, dtype=np.float32) - 0.5, cell, h, w)
    return out


def make_video(seed: int, camera: int, frames: int, height: int, width: int, device,
               max_disp: float = 90.0, pan: int = 3, noise: float = 2.0):
    """``(left, right)``, each ``[frames, height, width, 3]`` float32 on
    ``device``. The random draws are numpy's, from ``(seed, camera)``; the
    frames are cut and warped from them on ``device`` in a few bulk ops."""
    rng = np.random.default_rng([int(seed) % 2**63, camera])
    margin = int(np.ceil(max_disp)) + 2
    pw = width + margin + pan * frames
    tex = _noise(rng, height, pw, OCTAVES, 3)
    tex = np.clip(128.0 + tex * (55.0 / tex.std()), 0.0, 255.0).astype(np.float32)
    fields = []
    for _ in range(2):
        f = _noise(rng, height, width, (256, 128))
        fields.append((f - f.min()) / (f.max() - f.min()))
    # sensor noise: two frames' worth, each frame taking one rolled by its own offset
    pool = rng.standard_normal((2, 2, height, width, 3), dtype=np.float32) * noise
    shifts = rng.integers(0, width, (frames, 2))

    tex = torch.from_numpy(np.ascontiguousarray(tex)).to(device)
    f0, f1 = (torch.from_numpy(np.ascontiguousarray(f, dtype=np.float32)).to(device) for f in fields)
    pool = torch.from_numpy(pool).to(device)
    t = torch.arange(frames, device=device, dtype=torch.float32).view(-1, 1, 1)
    a = 0.5 - 0.5 * torch.cos(2.0 * np.pi * t / frames)
    disp = max_disp * ((1 - a) * f0 + a * f1)  # [frames, H, W]
    cols = torch.arange(width, device=device, dtype=torch.float32)
    rows = torch.arange(height, device=device).view(1, -1, 1) * pw
    left = torch.empty((frames, height, width, 3), dtype=torch.float32, device=device)
    right = torch.empty_like(left)
    flat = tex.view(-1, 3)
    for i in range(frames):
        left[i] = tex[:, pan * i : pan * i + width]
        pos = cols + pan * i + disp[i]
        x0 = torch.floor(pos)
        w1 = (pos - x0).unsqueeze(-1)
        i0 = (rows[0] + x0.long()).reshape(-1)
        a0 = flat[i0].view(height, width, 3)
        right[i] = a0 + (flat[i0 + 1].view(height, width, 3) - a0) * w1
        for view, k in ((left, 0), (right, 1)):
            view[i] += torch.roll(pool[k, i % 2], int(shifts[i, k]), dims=1)
    return left.clamp_(0.0, 255.0), right.clamp_(0.0, 255.0)
