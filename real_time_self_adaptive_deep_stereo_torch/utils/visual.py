"""Serialisation helpers.

Port of ``real_time_self_adaptive_deep_stereo_tpu/utils/visual.py``:
``save_disparity_png`` writes the 16-bit ``disparity * 256`` PNGs the
reference emits (Stereo_Online_Adaptation.py:246-251), through
:mod:`..data.png`. ``colorize_disparity`` is not ported yet: it needs
matplotlib (``ROADMAP.md``, queue 1, with ``cli/adapt_continual.py``).
"""

from __future__ import annotations

import os

import numpy as np

from real_time_self_adaptive_deep_stereo_torch.data.png import write_png

__all__ = ["save_disparity_png"]


def save_disparity_png(path: str, disp: np.ndarray, max_disp: float = 256.0) -> None:
    """Save 16-bit PNG of clip(disp, 0, max_disp) * 256."""
    d = np.asarray(disp, np.float32)
    if d.ndim == 3:
        d = d[..., 0]
    # 16-bit KITTI encoding has no NaN; encode non-finite pixels as 0
    # (the KITTI "invalid" value) rather than tripping the uint16 cast
    d = np.nan_to_num(d, nan=0.0, posinf=max_disp, neginf=0.0)
    to_save = (np.clip(d, 0, max_disp) * 256.0).astype(np.uint16)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_png(path, to_save)
