"""Plain online adaptation of one camera: the NONE, FULL and MAD steps and
the MAD controller (Tonioni et al., CVPR 2019, Algorithm 1; the
reference's ``Stereo_Online_Adaptation.py``).

Per frame:

* NONE: the forward alone.
* FULL: the forward, the loss of the served disparity, its gradient with
  respect to every parameter, and a momentum step
  (``acc = 0.9 acc + g; p -= lr acc``).
* MAD: block ``k`` is drawn by PROBABILITY, ``argmax(scores + Gumbel)``
  over the blocks, from ``u ~ U[0, 1)`` drawn from the camera's own
  generator (one draw of ``n`` values a frame); the loss of block ``k``'s
  own prediction is differentiated with respect to block ``k``'s
  parameters alone and those take the momentum step. The loss of the
  served disparity of the same (pre-step) forward feeds the controller:
  ``gain = 2 l[t-1] - l[t-2] - l[t]`` (the first frame's losses stand for
  the missing ones), ``scores = 0.99 scores + 0.01 gain * last_mask``, the
  drawn block's count goes up by one and its mask is kept for the next
  frame.
* FULL and MAD: where the loss is above ``ssim_th`` every weight goes
  back to its starting value (the optimizer state stays), and the reset
  is counted.

The served disparity is that of the pre-step forward.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from stereo_bench.reference import loss as L
from stereo_bench.reference import models as M

DECAY, UF = 0.99, 0.01


class PlainStream:
    """One camera's weights, optimizer and controller, all float32."""

    def __init__(self, model: str, blocks: List[List[str]], params: Dict[str, torch.Tensor],
                 params0: Dict[str, torch.Tensor], mode: str, lr: float, momentum: float, ssim_th: float,
                 bulkhead: bool, generator: Optional[torch.Generator], state: Optional[Dict] = None):
        self.forward = M.MODELS[model][0]
        self.blocks, self.mode = blocks, mode
        self.lr, self.momentum, self.ssim_th, self.bulkhead = lr, momentum, ssim_th, bulkhead
        self.generator = generator
        self.params = {k: v.detach().clone() for k, v in params.items()}
        self.params0 = params0
        dev = next(iter(params.values())).device
        n = len(blocks) if mode == "MAD" else 1
        state = state or {}
        self.acc = {k: state["acc"][k].clone() if "acc" in state else torch.zeros_like(v) for k, v in params.items()}
        z = torch.zeros((), device=dev)
        self.scores = state.get("scores", torch.zeros(n, device=dev)).clone()
        self.loss_t1 = state.get("loss_t1", z).clone()
        self.loss_t2 = state.get("loss_t2", z).clone()
        self.last_mask = state.get("last_mask", torch.zeros(n, device=dev)).clone()
        self.steps = int(state.get("steps", 0))
        self.resets = int(state.get("resets", 0))
        self.fetch_counter = state.get("fetch_counter", torch.zeros(n, device=dev)).clone().long()
        self.losses: List[float] = []  # the served disparity's loss of each step
        self.grad_norms: Dict[str, float] = {}  # per leaf, the largest gradient norm of the steps run

    def draw(self) -> int:
        n = len(self.blocks)
        u = torch.rand(n, generator=self.generator, device=self.scores.device, dtype=torch.float32)
        gumbel = -torch.log(-torch.log(u + 1e-20) + 1e-20)
        return int(torch.argmax(self.scores + gumbel))

    def step(self, left, right) -> torch.Tensor:
        """One frame; returns the served disparity ([1, H, W, 1])."""
        if self.mode == "NONE":
            with torch.no_grad():
                disp = self.forward(self.params, left, right, self.bulkhead)[-1]
            self.steps += 1
            return disp
        if self.mode == "FULL":
            trained = list(self.params)
        else:
            k = self.draw()
            trained = self.blocks[k]
        p = {n: v.detach().requires_grad_(n in trained) for n, v in self.params.items()}
        disps = self.forward(p, left, right, self.bulkhead)
        target = disps[-1] if self.mode == "FULL" else disps[k]
        grads = torch.autograd.grad(L.reprojection_loss(target, left, right), [p[n] for n in trained])
        for n, g in zip(trained, grads):
            self.grad_norms[n] = max(self.grad_norms.get(n, 0.0), float(g.norm()))
        with torch.no_grad():
            new_loss = L.reprojection_loss(disps[-1], left, right)
            for n, g in zip(trained, grads):
                self.acc[n].mul_(self.momentum).add_(g)
                self.params[n] = self.params[n] - self.lr * self.acc[n]
            if self.mode == "MAD":
                if self.steps == 0:
                    self.loss_t1 = self.loss_t2 = new_loss
                gain = 2.0 * self.loss_t1 - self.loss_t2 - new_loss
                self.scores = DECAY * self.scores + UF * gain * self.last_mask
                mask = torch.zeros_like(self.scores)
                mask[k] = 1.0
                self.fetch_counter[k] += 1
                self.loss_t2, self.loss_t1, self.last_mask = self.loss_t1, new_loss, mask
            if float(new_loss) > self.ssim_th:
                self.params = {n: v.clone() for n, v in self.params0.items()}
                self.resets += 1
        self.losses.append(float(new_loss))
        self.steps += 1
        return disps[-1].detach()
