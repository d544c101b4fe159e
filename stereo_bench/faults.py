"""Faults planted in the program, to show that the output check catches
them and to read the numbers they give (``calibrate.py --fault``). Each
is a context manager that patches ``FusedOnlineSession`` for the process
and restores it; a session built inside it carries the fault into its
captured graphs. The benchmark's own runs plant none.

* ``frozen``: a train step that returns its state unchanged: no update,
  no controller (the step count still advances);
* ``altered``: every served disparity altered where it is produced, one
  pixel moved by 1 px;
* ``half``: half of a rig's cameras left out of the adaptation: their
  frames are served by the forward alone, their state unchanged.
"""

from __future__ import annotations

import contextlib

FAULTS = ("frozen", "altered", "half")


@contextlib.contextmanager
def planted(fault: str):
    from real_time_self_adaptive_deep_stereo_torch.adapt.fused import FusedOnlineSession as S

    saved = {k: getattr(S, k) for k in ("_apply", "_control", "_device_step")}
    step = saved["_device_step"]
    if fault == "frozen":
        S._apply = lambda self, st, block, grads, t: None
        S._control = lambda self, st, new_loss, row: st.step_count.add_(1)
    elif fault == "altered":
        def altered(self, st, branch, frame):
            disp = step(self, st, branch, frame).clone()
            disp.view(-1)[disp.numel() // 2] += 1.0
            return disp
        S._device_step = altered
    elif fault == "half":
        def half(self, st, branch, frame):
            if st.index is not None and st.index >= max(self.num_streams // 2, 1):
                return self._forward_only(frame)[1]
            return step(self, st, branch, frame)
        S._device_step = half
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(S, k, v)
