"""Online adaptation session: the host-side frame loop.

Port of ``real_time_self_adaptive_deep_stereo_tpu/adapt/runner.py``:
reward-driven block sampling, score updates, the loss-threshold network
reset and metric accumulation around the :class:`AdaptationEngine` steps,
in the modes NONE, FULL and MAD.

Each frame makes one device-to-host transfer, of the loss and the metric
scalars together; the reward update and the reset test run on those host
floats. The disparity map stays on the device unless the caller fetches
it. The session runs on its engine's device and adapts the engine's
module in place; the pristine weights for the reset are kept as separate
tensors.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from real_time_self_adaptive_deep_stereo_torch.adapt.engine import AdaptationEngine
from real_time_self_adaptive_deep_stereo_torch.adapt.samplers import get_sampler, softmax

__all__ = ["OnlineAdaptationSession", "SessionStats"]


@dataclass
class SessionStats:
    epe: List[float] = field(default_factory=list)
    bad3: List[float] = field(default_factory=list)
    d1: List[float] = field(default_factory=list)
    loss: List[float] = field(default_factory=list)
    fetch_counter: List[int] = field(default_factory=list)
    sample_distribution: Optional[np.ndarray] = None
    reset_counter: int = 0
    steps: int = 0
    exec_time: float = 0.0

    @property
    def fps(self) -> float:
        return self.steps / self.exec_time if self.exec_time > 0 else 0.0


class OnlineAdaptationSession:
    """Drives NONE / FULL / MAD adaptation of an engine's module over a
    frame stream.

    Reward bookkeeping matches the reference: after each step the
    expected loss is linearly extrapolated from the two previous losses,
    and the realised gain is credited to the last-trained blocks with
    exponential decay (Stereo_Online_Adaptation.py:211-224; ``decay`` and
    ``uf`` tunable as in Stereo_Continual_Adaptation.py:225-238).
    """

    def __init__(
        self,
        engine: AdaptationEngine,
        mode: str = "MAD",
        sample_mode: str = "PROBABILITY",
        num_blocks: int = 1,
        fixed_id=0,
        sample_frequency: int = 1,
        ssim_th: float = 0.5,
        decay: float = 0.99,
        uf: float = 0.01,
        dilation: int = 1,
        seed: Optional[int] = None,
    ):
        if mode not in ("NONE", "FULL", "MAD"):
            raise ValueError(f"unknown adaptation mode {mode!r}")
        if mode == "MAD" and not engine.blocks:
            raise ValueError("mode MAD needs an engine built with blocks")
        self.engine = engine
        self.mode = mode
        self.ssim_th = ssim_th
        self.decay = decay
        self.uf = uf
        self.dilation = max(1, dilation)
        self.sample_frequency = max(1, sample_frequency)

        # pristine weights for the reset safeguard: clones on the device,
        # never views of the live parameters, which the steps update in place
        self.params0 = {
            name: p.detach().clone() for name, p in engine.model.named_parameters()
        }
        if mode != "NONE":
            engine.init_opt()

        n_actions = len(engine.blocks) if mode == "MAD" else 1
        self.n_actions = n_actions
        self.sampler = (
            get_sampler(sample_mode, num_blocks, fixed_id, seed) if mode == "MAD" else None
        )
        self.scores = np.zeros((n_actions,), np.float64)
        self._loss_t1 = 0.0
        self._loss_t2 = 0.0
        self._last_trained: List[int] = []
        self._blocks_to_train: List[int] = []
        self.stats = SessionStats(fetch_counter=[0] * n_actions)

    # ------------------------------------------------------------------ step
    def step(self, frame: Dict) -> Dict:
        """Process one frame: adapt (per mode) and return the scalar
        metrics and the disparity (``disp``, left on the device)."""
        t0 = time.perf_counter()
        step_idx = self.stats.steps

        if self.mode == "MAD" and step_idx % self.sample_frequency == 0:
            distribution = softmax(self.scores)
            self._blocks_to_train = [int(k) for k in self.sampler.sample(distribution)]
            for k in self._blocks_to_train:
                self.stats.fetch_counter[k] += 1

        train_this_step = step_idx % self.dilation == 0
        if self.mode == "NONE" or not train_this_step:
            res = self.engine.infer(frame)
        elif self.mode == "FULL":
            res = self.engine.adapt_full(frame)
        else:  # MAD; with numBlocks > 1 all gradients are taken at the
            # pre-step parameters and the disjoint updates land together
            res = self.engine.adapt_blocks(self._blocks_to_train, frame)

        # the single host sync per frame
        new_loss, epe, bad3, d1 = torch.stack(
            [res["loss"], res["epe"], res["bad3"], res["d1"]]
        ).tolist()

        # The reward/score update runs EVERY frame: only the train ops are
        # dilation-gated (Stereo_Continual_Adaptation.py:212 gates the op,
        # :225-238 updates scores and rolls loss_t_1/loss_t_2 unconditionally).
        if self.mode == "MAD":
            if step_idx == 0:
                self._loss_t1 = self._loss_t2 = new_loss
            expected = 2.0 * self._loss_t1 - self._loss_t2
            gain = expected - new_loss
            self.scores *= self.decay
            for k in self._last_trained:
                self.scores[k] += self.uf * gain
            self._last_trained = self._blocks_to_train
            self._loss_t2 = self._loss_t1
            self._loss_t1 = new_loss

        # reset safeguard (Stereo_Online_Adaptation.py:241-244)
        if new_loss > self.ssim_th and self.mode != "NONE":
            self.reset()

        self.stats.epe.append(epe)
        self.stats.bad3.append(bad3)
        self.stats.d1.append(d1)
        self.stats.loss.append(new_loss)
        self.stats.steps += 1
        self.stats.exec_time += time.perf_counter() - t0
        self.stats.sample_distribution = self.scores.copy()
        return {"loss": new_loss, "epe": epe, "bad3": bad3, "d1": d1, "disp": res["disp"]}

    def reset(self) -> None:
        """Restore the pristine weights in place (optimizer state
        intentionally kept, matching the reference whose restore touches
        model variables only)."""
        with torch.no_grad():
            for name, p in self.engine.model.named_parameters():
                p.copy_(self.params0[name])
        self.stats.reset_counter += 1
