"""Visualisation / serialisation helpers.

Port of ``real_time_self_adaptive_deep_stereo_tpu/utils/visual.py``:
``colorize_disparity`` maps a disparity map through a colour map
(reference ``preprocessing.colorize_img``, Data_utils/preprocessing.py:
91-117) for logging and the demo's window; ``save_disparity_png`` writes
the 16-bit ``disparity * 256`` PNGs the reference emits
(Stereo_Online_Adaptation.py:246-251), through :mod:`..data.png`. The
GPU's machine may lack matplotlib: ``jet``, the reference's map, is built
here as matplotlib builds it; any other name is matplotlib's, and is
refused where matplotlib does not import.
"""

from __future__ import annotations

import os

import numpy as np

from real_time_self_adaptive_deep_stereo_torch.data.png import write_png

__all__ = ["colorize_disparity", "save_disparity_png"]

# matplotlib's ``_jet_data`` (matplotlib/_cm.py): per channel, the (x, y0,
# y1) points of a piecewise-linear map of [0, 1]
_JET_DATA = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0), (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
}


def _lookup_table(n: int, data) -> np.ndarray:
    """matplotlib's ``colors._create_lookup_table(n, data)`` at gamma 1:
    the map sampled at ``n`` evenly spaced points of [0, 1], float64."""
    adata = np.array(data, dtype=np.float64)
    x, y0, y1 = adata[:, 0] * (n - 1), adata[:, 1], adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def _jet_table() -> np.ndarray:
    """[256, 3] RGB of matplotlib's ``jet``, float64 in 0..1: what
    ``matplotlib.cm.get_cmap("jet")(np.arange(256))[:, :3]`` gives."""
    return np.stack([_lookup_table(256, _JET_DATA[c]) for c in ("red", "green", "blue")], axis=-1)


def colorize_disparity(
    disp: np.ndarray, vmin=None, vmax=None, cmap: str = "jet"
) -> np.ndarray:
    """[H,W] or [H,W,1] disparity -> [H,W,3] float RGB in 0..1 through the
    colour map ``cmap``: ``jet`` built here, any other matplotlib's."""
    if cmap == "jet":
        table = _jet_table()
    else:
        try:
            from matplotlib import colormaps
        except ImportError as e:
            raise ValueError(
                f"colour map {cmap!r} needs matplotlib, which is not installed; only 'jet' is built in"
            ) from e
        table = colormaps[cmap](np.arange(256))[:, :3]
    d = np.asarray(disp, np.float32)
    if d.ndim == 3:
        d = d[..., 0]
    d = np.nan_to_num(d)  # early-adaptation frames can carry inf/NaN
    vmin = d.min() if vmin is None else vmin
    vmax = d.max() if vmax is None else vmax
    norm = np.clip((d - vmin) / max(vmax - vmin, 1e-12), 0, 1)
    idx = np.round(norm * 255).astype(np.int32)
    return table[idx]


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
