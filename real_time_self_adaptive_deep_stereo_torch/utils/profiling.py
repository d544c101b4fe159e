"""Wall-clock timing of a frame loop.

Port of ``StepTimer`` from ``real_time_self_adaptive_deep_stereo_tpu/utils/profiling.py``
(the reference's only introspection is wall-clock per-100-frames timing,
Stereo_Online_Adaptation.py:230-239). It is framework-free. The JAX
module's ``trace`` and ``summarize_trace`` wrap ``jax.profiler`` and are
not ported: ``chip_smoke.py --profile`` reads ``torch.profiler`` instead.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

__all__ = ["StepTimer"]


class StepTimer:
    """Rolling wall-clock stats for the frame loop: ``tick()`` once a
    frame; ``avg_ms`` over the last ``window`` intervals, ``fps`` over all."""

    def __init__(self, window: int = 100):
        self.window = window
        self._times: deque = deque(maxlen=window)
        self._last: Optional[float] = None
        self.total = 0.0
        self.steps = 0

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            self.total += dt
            self.steps += 1
        self._last = now

    @property
    def avg_ms(self) -> float:
        return 1000.0 * sum(self._times) / len(self._times) if self._times else 0.0

    @property
    def fps(self) -> float:
        return self.steps / self.total if self.total > 0 else 0.0
