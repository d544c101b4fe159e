"""Online adaptation session: the host-side frame loop.

Port of ``real_time_self_adaptive_deep_stereo_tpu/adapt/runner.py`` for
mode NONE: each frame runs :meth:`AdaptationEngine.infer` and makes one
device-to-host transfer, of the loss and the metric scalars together.
FULL and MAD raise ``NotImplementedError`` until the next slice, which
also brings the block sampling, the reward update and the reset
safeguard. The session runs on its engine's device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from real_time_self_adaptive_deep_stereo_torch.adapt.engine import AdaptationEngine

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
    """Drives an :class:`AdaptationEngine` over a frame stream."""

    def __init__(self, engine: AdaptationEngine, mode: str = "NONE"):
        if mode not in ("NONE", "FULL", "MAD"):
            raise ValueError(f"unknown adaptation mode {mode!r}")
        if mode != "NONE":
            raise NotImplementedError(
                f"mode {mode} comes with the MAD/FULL slice of the port "
                "(ROADMAP.md, modules to port, items 4-5)"
            )
        self.engine = engine
        self.mode = mode
        self.n_actions = 1
        self.scores = np.zeros((1,), np.float64)
        self.stats = SessionStats(fetch_counter=[0])

    def step(self, frame: Dict) -> Dict:
        """Process one frame; returns the scalar metrics and the disparity
        (``disp``, left on the device)."""
        t0 = time.perf_counter()
        res = self.engine.infer(frame)
        # the single host sync per frame
        loss, epe, bad3, d1 = torch.stack(
            [res["loss"], res["epe"], res["bad3"], res["d1"]]
        ).tolist()
        self.stats.epe.append(epe)
        self.stats.bad3.append(bad3)
        self.stats.d1.append(d1)
        self.stats.loss.append(loss)
        self.stats.steps += 1
        self.stats.exec_time += time.perf_counter() - t0
        self.stats.sample_distribution = self.scores.copy()
        return {"loss": loss, "epe": epe, "bad3": bad3, "d1": d1, "disp": res["disp"]}
