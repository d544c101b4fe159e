"""Online-adaptation engine: the per-frame step functions.

Port of ``real_time_self_adaptive_deep_stereo_tpu/adapt/engine.py``:

* ``infer(frame)``: forward, the full loss and the EPE / bad3 / D1
  metrics under ``torch.no_grad()`` (mode NONE);
* ``adapt_full(frame)``: forward, backward through everything, optimizer
  update of every parameter (FULL);
* ``adapt_block(k, frame)``: forward, backward of block k's loss with
  respect to block k's parameters only, update of those only (MAD);
* ``adapt_blocks(ks, frame)``: several blocks in one step, every gradient
  taken at the pre-step parameters.

The JAX engine builds pure jitted functions of ``(params, opt, frame)``.
This engine owns its module and its optimizer state: a step takes the
frame only and updates the module's parameters in place. Before the
forward of a step, ``requires_grad`` is set on exactly the parameters
that the step trains, so autograd records and runs nothing upstream of
the lowest trained layer: that is what makes MAD cheaper than FULL. The
loss and the metrics that a step returns are those of its pre-step
forward, computed before the update.

Frames are dicts of NHWC ``left`` / ``right`` images (0..255) and an
NHW1 ``target`` disparity, as tensors or numpy arrays; they are moved to
the engine's device.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from real_time_self_adaptive_deep_stereo_torch.adapt.blocks import Block
from real_time_self_adaptive_deep_stereo_torch.losses import (
    get_proxy_loss,
    get_reprojection_loss,
)
from real_time_self_adaptive_deep_stereo_torch.ops.resize import resize_bilinear
from real_time_self_adaptive_deep_stereo_torch.utils import optim
from real_time_self_adaptive_deep_stereo_torch.utils.device import resolve_device

__all__ = ["AdaptationEngine", "PIXEL_TH", "disparity_metrics", "d1_metric"]

PIXEL_TH = 3.0  # bad-pixel threshold (Stereo_Online_Adaptation.py:20)


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


def _resize_nhwc(t: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    return resize_bilinear(t.permute(0, 3, 1, 2), out_h, out_w).permute(0, 2, 3, 1)


def _scale_tensor(t: torch.Tensor, scale: int) -> torch.Tensor:
    """NHWC ``t`` resized to ``shape // scale``."""
    if scale == 1:
        return t
    return _resize_nhwc(t, t.shape[1] // scale, t.shape[2] // scale)


class AdaptationEngine:
    """Per-frame steps around ``model``. Runs on ``cuda`` unless
    ``device='cpu'``; the model is moved there.

    Args:
      model: a module with ``forward(left, right)`` (NHWC in).
      blocks: MAD Blocks of ``model`` (None unless the mode needs them).
      lr: learning rate.
      optimizer: 'momentum' (reference online default) or 'adam' (demo).
      adaptation: 'reprojection' (photometric) or 'proxy' (proxy labels
        under ``frame['proxy']``).
      reprojection_scale: compute block losses at 1/scale resolution.
      momentum: the momentum optimizer's beta.
      warp_mode: warp mode of the loss's image warp (``ops/warp.py``).
    """

    def __init__(
        self,
        model: torch.nn.Module,
        blocks: Optional[Sequence[Block]] = None,
        lr: float = 1e-4,
        optimizer: str = "momentum",
        adaptation: str = "reprojection",
        reprojection_scale: int = 1,
        momentum: float = 0.9,
        warp_mode: str = "auto",
        device: Optional[Union[str, torch.device]] = None,
    ):
        if optimizer not in ("momentum", "adam"):
            raise ValueError(f"unknown optimizer {optimizer!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.blocks = list(blocks) if blocks else []
        self.lr = lr
        self.optimizer = optimizer
        self.adaptation = adaptation
        self.reprojection_scale = int(reprojection_scale)
        self.momentum = momentum
        self.warp_mode = warp_mode

        if adaptation == "reprojection":
            self._full_loss_fn = self._block_base_loss = get_reprojection_loss(
                "mean_SSIM_l1", reduced=True, warp_mode=warp_mode
            )
        elif adaptation == "proxy":
            # full loss weights 0.01, block loss weights 0.1
            # (Stereo_Continual_Adaptation.py:75,112)
            self._full_loss_fn = get_proxy_loss(
                "mean_l1", max_disp=192, weights=[0.01] * 10, reduced=True
            )
            self._block_base_loss = get_proxy_loss(
                "mean_l1", max_disp=192, weights=[0.1] * 10, reduced=True
            )
        else:
            raise ValueError(f"unknown adaptation kind {adaptation!r}")

        self._named_params: Dict[str, torch.nn.Parameter] = dict(self.model.named_parameters())
        self.opt: Optional[Dict] = None

    # ------------------------------------------------------------- opt state
    def init_opt(self) -> Dict:
        """Fresh optimizer state for every parameter of the model, keyed
        by parameter name; kept as ``self.opt`` and returned."""
        if self.optimizer == "momentum":
            self.opt = {"acc": optim.momentum_init(self._named_params)}
        else:
            # ONE step count shared by every block: the reference demo
            # builds all per-block train ops from a single
            # tf.train.AdamOptimizer, whose bias-correction powers advance
            # once per executed train op, so the correction follows the
            # global number of adaptation steps, not per-block counts.
            self.opt = optim.adam_init(self._named_params)
        return self.opt

    def _update(self, updates) -> None:
        """Apply the ``(names, params, grads)`` updates together, in place.
        Only these parameters' slots of the optimizer state are touched.
        With Adam every update reads the pre-step step count, which then
        advances once per update."""
        opt = self.opt or self.init_opt()
        t = opt.get("t", 0) + 1
        for names, params, grads in updates:
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            if self.optimizer == "momentum":
                acc = [opt["acc"][n] for n in names]
                optim.momentum_update(params, acc, grads, self.lr, self.momentum)
            else:
                m, v = ([opt[slot][n] for n in names] for slot in ("m", "v"))
                optim.adam_update(params, m, v, grads, self.lr, t)
        if "t" in opt:
            opt["t"] += len(updates)

    def _set_trainable(self, params=None) -> None:
        """``requires_grad`` on exactly ``params`` (None: on all)."""
        want = None if params is None else {id(p) for p in params}
        for p in self._named_params.values():
            p.requires_grad_(want is None or id(p) in want)

    # ---------------------------------------------------------------- losses
    def block_loss_inputs(self, frame: Dict):
        """Scaled loss inputs and the per-prediction preparation of the
        MAD block losses (the --reprojectionScale protocol,
        Stereo_Online_Adaptation.py:91-107)."""
        s = self.reprojection_scale
        left = _scale_tensor(frame["left"], s)
        inputs = {"left": left, "right": _scale_tensor(frame["right"], s)}
        if "target" in frame:
            inputs["target"] = _scale_tensor(frame["target"], s) / s
        if "proxy" in frame:
            inputs["proxy"] = _scale_tensor(frame["proxy"], s) / s

        def prep(p: torch.Tensor) -> torch.Tensor:
            multiplier = float(frame["left"].shape[1] // p.shape[1])
            return _resize_nhwc(p, left.shape[1], left.shape[2]) * multiplier

        return inputs, prep

    def _block_loss(self, disparities, k: int, frame: Dict) -> torch.Tensor:
        """Loss of MAD block k: its scale's prediction, rescaled to the
        (optionally downscaled) inputs."""
        inputs, prep = self.block_loss_inputs(frame)
        return self._block_base_loss([prep(disparities[k])], inputs)

    def _to_device(self, frame: Dict) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in frame.items():
            t = torch.from_numpy(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
            out[k] = t.to(self.device, torch.float32)
        return out

    def _outputs(self, out: Dict, frame: Dict, loss: torch.Tensor) -> Dict[str, torch.Tensor]:
        disp = out["full_res_disp"].detach()
        epe, bad3 = disparity_metrics(disp, frame["target"])
        _, d1 = d1_metric(disp, frame["target"])
        return {"disp": disp, "loss": loss.detach(), "epe": epe, "bad3": bad3, "d1": d1}

    # ------------------------------------------------------------- step fns
    def infer(self, frame: Dict) -> Dict[str, torch.Tensor]:
        """Mode NONE: forward, loss and metrics; results stay on the device."""
        frame = self._to_device(frame)
        with torch.no_grad():
            out = self.model(frame["left"], frame["right"])
            loss = self._full_loss_fn(out["disparities"], frame)
            return self._outputs(out, frame, loss)

    def adapt_full(self, frame: Dict) -> Dict[str, torch.Tensor]:
        """Mode FULL: one step on every parameter with the full loss."""
        frame = self._to_device(frame)
        names, params = list(self._named_params), list(self._named_params.values())
        self._set_trainable()
        out = self.model(frame["left"], frame["right"])
        loss = self._full_loss_fn(out["disparities"], frame)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        with torch.no_grad():
            res = self._outputs(out, frame, loss)
            self._update([(names, params, grads)])
        return res

    def adapt_block(self, k: int, frame: Dict) -> Dict[str, torch.Tensor]:
        """Mode MAD: one step on block k with block k's loss. ``loss`` is
        the full loss of the same pre-step forward; ``block_loss`` rides
        along."""
        res = self.adapt_blocks([k], frame)
        res["block_loss"] = res["block_loss"][0]
        return res

    def adapt_blocks(self, ks: Sequence[int], frame: Dict) -> Dict[str, torch.Tensor]:
        """One step training several blocks TOGETHER.

        Reference semantics for ``--numBlocks > 1``: all selected
        per-block train ops run in a single ``sess.run``, so every
        block's gradient is evaluated at the same pre-step parameters and
        the disjoint updates land together. One forward serves all of
        them; each block's loss is differentiated with respect to that
        block's parameters only. Duplicate ids collapse. With Adam every
        update reads the pre-step step count, which then advances once
        per block trained. ``block_loss`` is the stack of block losses in
        sorted id order."""
        frame = self._to_device(frame)
        sel = [self.blocks[k] for k in sorted(dict.fromkeys(int(k) for k in ks))]
        self._set_trainable([p for block in sel for p in block.params])
        out = self.model(frame["left"], frame["right"])
        block_losses, grads_list = [], []
        for i, block in enumerate(sel):
            bl = self._block_loss(out["disparities"], block.index, frame)
            grads_list.append(
                torch.autograd.grad(
                    bl, block.params, retain_graph=i + 1 < len(sel), allow_unused=True
                )
            )
            block_losses.append(bl.detach())
        with torch.no_grad():
            # the fetched loss and metrics come from the shared pre-step
            # forward, like the reference's one round-trip
            loss = self._full_loss_fn(out["disparities"], frame)
            res = self._outputs(out, frame, loss)
            res["block_loss"] = torch.stack(block_losses)
            self._update([(b.names, b.params, g) for b, g in zip(sel, grads_list)])
        self._set_trainable()
        return res
