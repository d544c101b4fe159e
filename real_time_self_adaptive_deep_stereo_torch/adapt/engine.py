"""Online-adaptation engine: the per-frame step functions.

Port of ``real_time_self_adaptive_deep_stereo_tpu/adapt/engine.py`` for
this slice: ``infer`` (mode NONE: forward, the full photometric loss and
the EPE / bad3 / D1 metrics, under ``torch.no_grad()``). The adaptation
steps ``adapt_full``, ``adapt_block`` and ``adapt_blocks`` raise
``NotImplementedError`` until the MAD/FULL slice (ROADMAP.md, modules to
port, item 4).

Frames are dicts of NHWC ``left`` / ``right`` images (0..255) and an
NHW1 ``target`` disparity, as tensors or numpy arrays; they are moved to
the engine's device.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from real_time_self_adaptive_deep_stereo_torch.losses import get_reprojection_loss
from real_time_self_adaptive_deep_stereo_torch.utils.device import resolve_device

__all__ = ["AdaptationEngine", "PIXEL_TH", "disparity_metrics", "d1_metric"]

PIXEL_TH = 3.0  # bad-pixel threshold (Stereo_Online_Adaptation.py:20)

_NEXT_SLICE = (
    "MAD and FULL adaptation come with the next slice of the port "
    "(ROADMAP.md, modules to port, item 4)"
)


def _squeeze_c1(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0] if x.dim() == 4 and x.shape[-1] == 1 else x


def disparity_metrics(full_disp: torch.Tensor, gt: torch.Tensor):
    """EPE and bad3 over pixels with gt != 0; bad3 = fraction of them
    with error > 3."""
    full_disp, gt = _squeeze_c1(full_disp), _squeeze_c1(gt)
    valid = (gt != 0).float()
    err = torch.abs(full_disp - gt) * valid
    denom = valid.sum()
    epe = err.sum() / denom
    bad3 = (err > PIXEL_TH).float().sum() / denom
    return epe, bad3


def d1_metric(full_disp: torch.Tensor, gt: torch.Tensor):
    """KITTI D1: % of valid pixels with error > 3px AND >= 5% of gt."""
    full_disp, gt = _squeeze_c1(full_disp), _squeeze_c1(gt)
    valid = gt > 0
    err = torch.abs(full_disp - gt)
    out = valid & (err > 3.0) & (err / torch.clamp(gt, min=1e-9) >= 0.05)
    n_valid = torch.clamp(valid.sum(), min=1).float()
    d1 = 100.0 * out.sum().float() / n_valid
    epe = torch.where(valid, err, torch.zeros_like(err)).sum() / n_valid
    return epe, d1


class AdaptationEngine:
    """Per-frame steps around ``model``. Runs on ``cuda`` unless
    ``device='cpu'``; the model is moved there.

    Args:
      model: a module with ``forward(left, right)`` (NHWC in).
      adaptation: 'reprojection' (photometric); 'proxy' comes later.
      warp_mode: warp mode of the loss's image warp (``ops/warp.py``).
    """

    def __init__(
        self,
        model: torch.nn.Module,
        adaptation: str = "reprojection",
        warp_mode: str = "auto",
        device: Optional[Union[str, torch.device]] = None,
    ):
        if adaptation != "reprojection":
            raise NotImplementedError(
                f"adaptation {adaptation!r} is not ported yet "
                "(ROADMAP.md, modules to port, items 3 and 9)"
            )
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.adaptation = adaptation
        self.warp_mode = warp_mode
        self._full_loss_fn = get_reprojection_loss(
            "mean_SSIM_l1", reduced=True, warp_mode=warp_mode
        )

    def _to_device(self, frame: Dict) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in frame.items():
            t = torch.from_numpy(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
            out[k] = t.to(self.device, torch.float32)
        return out

    def _outputs(self, out: Dict, frame: Dict, loss: torch.Tensor) -> Dict[str, torch.Tensor]:
        epe, bad3 = disparity_metrics(out["full_res_disp"], frame["target"])
        _, d1 = d1_metric(out["full_res_disp"], frame["target"])
        return {"disp": out["full_res_disp"], "loss": loss, "epe": epe, "bad3": bad3, "d1": d1}

    def infer(self, frame: Dict) -> Dict[str, torch.Tensor]:
        """Mode NONE: forward, loss and metrics; results stay on the device."""
        frame = self._to_device(frame)
        with torch.no_grad():
            out = self.model(frame["left"], frame["right"])
            loss = self._full_loss_fn(out["disparities"], frame)
            return self._outputs(out, frame, loss)

    def adapt_full(self, *args, **kwargs):
        raise NotImplementedError(_NEXT_SLICE)

    def adapt_block(self, k: int):
        raise NotImplementedError(_NEXT_SLICE)

    def adapt_blocks(self, ks):
        raise NotImplementedError(_NEXT_SLICE)
