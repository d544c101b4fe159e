"""The output check: what the timed path produced against the plain
reference (``reference/``), number by number, each against its limit.

What is compared, for every camera:

* the start: the reference runs the first three frames from the seed's
  weights (a zero momentum, a zero controller, the camera's generator
  from its seed) and is compared with the served disparities of those
  frames, the momentum after the first step (the first gradient as the
  optimizer took it), and the state after the third;
* a stretch of the window: from the program's state before frame ``j``
  (``j`` drawn from the seed, inside the window), the reference runs
  frames ``j .. j+2`` (its generator advanced by the ``j`` draws before)
  and is compared with their served disparities and the state before
  frame ``j+3``. The reference cannot follow the window's thousands of
  frames in its own time, so it starts here from the program's own state;
  the start above checks the stretch that this skips from the seed;
* without adaptation (NONE), a sample of the window's frames drawn from
  the seed, against the seed's weights.

Numbers (the worst over cameras and parts):

* ``fwd_err``: ``max |d - d_ref| / max |d_ref|`` over the served pixels of
  the frames that each part starts with (frames 0 and ``j``, and the
  sampled frames), whose weights both sides hold alike: the forward. The
  frames after a part's first step are served from weights that carry the
  update's rounding, which the next numbers judge;
* ``grad_err``: the worst leaf's gap between the norm of the program's
  first gradient and the reference's, over the larger of the reference's
  norm of that leaf and of the median leaf's; leaves whose reference
  gradient is under a thousandth of the median leaf's are left out (they
  move by round-off);
* ``update_err``: the same gap for the change over the three steps, the
  median over the leaves either side moved; the limits compare it.
  ``update_worst``, the worst leaf's gap, is printed and not compared:
  where a leaf's three-step change is a few float32 spacings of its
  values, one element rounded the other way moves that leaf's gap by a
  large share. In MADNet a one-element bias near -1 moves some twenty
  spacings, and one spacing reads 0.05; in DispNet most elements do not
  move at all (the median leaf's change is about 1e-9 in norm), and one
  element rounded the other way read up to 1e-3 on sound seeds. The
  median leaf rounds alike on both sides;
* ``loss_err``: the relative gap of the last two steps' losses;
* ``scores_err``: ``max |s - s_ref| / max |s_ref|`` of the blocks' scores;
* ``fetch_mismatch``, ``reset_mismatch``, ``step_mismatch``: entries of
  the blocks' counts, resets and steps that differ (limit 0).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import numpy as np
import torch

from stereo_bench.reference import models as M
from stereo_bench.reference.session import PlainStream

GRAD_FLOOR = 1e-3  # of the median leaf's gradient norm: below it a leaf moves by round-off alone


def unravel(flat: torch.Tensor, entries) -> Dict[str, torch.Tensor]:
    return {name: flat[off : off + size].view(shape) for name, shape, off, size in entries}


def disp_err(prog: np.ndarray, ref: torch.Tensor) -> float:
    r = ref.detach().double().cpu().numpy().reshape(prog.shape)
    return float(np.abs(prog.astype(np.float64) - r).max() / max(np.abs(r).max(), 1e-12))


def leaf_gaps(prog, ref, base, excluded=()):
    """``(gap, name)`` of each leaf that either side moved:
    ``| |p - b| - |r - b| |`` over the larger of ``|r - b|`` and the median of
    the moved leaves' ``|r - b|``."""
    def norms(t):
        return {n: float((t[n] - base[n]).double().norm()) if base is not None else float(t[n].double().norm())
                for n in ref}
    np_, nr = norms(prog), norms(ref)
    moved = [v for n, v in nr.items() if v > 0 and n not in excluded]
    med = statistics.median(moved) if moved else 0.0
    return [(abs(np_[n] - nr[n]) / max(nr[n], med), n) for n in ref
            if n not in excluded and max(nr[n], np_[n]) > 0 and max(nr[n], med) > 0]


def worst_leaf(prog, ref, base, excluded=()):
    return max(leaf_gaps(prog, ref, base, excluded), default=(0.0, None))


def median_leaf(prog, ref, base, excluded=()):
    gaps = leaf_gaps(prog, ref, base, excluded)
    return (statistics.median(g for g, _ in gaps), f"median of {len(gaps)} leaves") if gaps else (0.0, None)


def excluded_leaves(stream: PlainStream) -> set:
    if not stream.grad_norms:
        return set()
    med = statistics.median(stream.grad_norms.values())
    return {n for n, g in stream.grad_norms.items() if g < GRAD_FLOOR * med}


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


class Checker:
    """Collects the numbers of one run, each the worst seen."""

    def __init__(self, mode: str):
        self.mode = mode
        self.where: Dict[str, str] = {}  # where each number's worst reading came from
        self.excluded: set = set()  # leaves left out by GRAD_FLOOR
        self.part = ""
        self.values: Dict[str, float] = {"fwd_err": 0.0, "step_mismatch": 0.0}
        if mode != "NONE":
            self.values.update(grad_err=0.0, update_err=0.0, update_worst=0.0, reset_mismatch=0.0)
        if mode == "MAD":
            self.values.update(loss_err=0.0, scores_err=0.0, fetch_mismatch=0.0)

    def worst(self, key: str, value, where: str = "") -> None:
        if isinstance(value, tuple):
            value, where = value
        if float(value) > self.values[key] or key not in self.where:
            self.where[key] = f"{self.part} {where or ''}".strip()
        self.values[key] = max(self.values[key], float(value))

    def state(self, stream: PlainStream, snap: Dict, row: Optional[int], entries, base, excluded) -> None:
        self.excluded |= excluded
        pick = (lambda t: t) if row is None else (lambda t: t[row])
        self.worst("step_mismatch", abs(int(pick(snap["step_count"])) - stream.steps))
        if self.mode == "NONE":
            return
        after = unravel(pick(snap["flat"]), entries)
        self.worst("update_err", median_leaf(after, stream.params, base, excluded))
        self.worst("update_worst", worst_leaf(after, stream.params, base, excluded))
        self.worst("reset_mismatch", abs(int(pick(snap["reset_count"])) - stream.resets))
        if self.mode == "MAD":
            counts = pick(snap["fetch_counter"]).long().cpu()
            self.worst("fetch_mismatch", int((counts != stream.fetch_counter.cpu()).sum()))
            scores_ref = stream.scores.double().cpu()
            gap = (pick(snap["scores"]).double().cpu() - scores_ref).abs().max()
            self.worst("scores_err", float(gap) / max(float(scores_ref.abs().max()), 1e-30))
            for key, i in (("loss_t1", -1), ("loss_t2", -2)):
                self.worst("loss_err", rel(float(pick(snap[key])), stream.losses[i]))


def run_checks(cell, w0: Dict[str, torch.Tensor], entries, snaps: Dict[int, Dict], kept: Dict[int, np.ndarray],
               frame_at, seeds: List[int], follow: int, samples: List[int]) -> Dict[str, float]:
    """The numbers of one run. ``snaps[i]``: the program's state before
    frame ``i`` (1, 3, ``follow`` and ``follow + 3``); ``kept[i]``: the
    served disparity of frame ``i`` (``[N, 1, H, W, 1]`` with N cameras);
    ``frame_at(i)``: frame ``i``'s ``(left, right)`` on the device."""
    cfg, trf = cell.config, cell.traffic
    mode = trf["mode"]
    rig = trf["num_streams"] > 0
    names = list(w0)
    blocks = M.block_names(cfg["model"], cfg["blocks"], names)
    bulkhead = cfg.get("bulkhead_in", {}).get(mode, False)
    dev = next(iter(w0.values())).device
    chk = Checker(mode)

    def stream(params, state=None, draws=0, seed=0):
        g = None
        if mode == "MAD":
            g = torch.Generator(device=dev).manual_seed(int(seed))
            for _ in range(draws):
                torch.rand(len(blocks), generator=g, device=dev, dtype=torch.float32)
        return PlainStream(cfg["model"], blocks, params, w0, mode, trf["lr"], trf["momentum"], trf["ssim_th"],
                           bulkhead, g, state)

    def served(i, c, d):
        chk.worst("fwd_err", disp_err(kept[i][c] if rig else kept[i], d), f"frame {i}")

    def state_of(snap, c):
        pick = (lambda t: t[c]) if rig else (lambda t: t)
        out = {k: pick(snap[k]) for k in ("scores", "loss_t1", "loss_t2", "last_mask", "fetch_counter") if k in snap}
        out["steps"], out["resets"] = int(pick(snap["step_count"])), int(pick(snap["reset_count"]))
        if "acc" in snap:
            out["acc"] = unravel(pick(snap["acc"]), entries)
        return out

    prev_tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for c, seed in enumerate(seeds):
            row = c if rig else None
            chk.part = f"camera {c} start"
            cam = (lambda i: tuple(t[c] for t in frame_at(i))) if rig else frame_at
            # the start, from the seed
            s = stream(w0, seed=seed)
            for i in range(3):
                d = s.step(*cam(i))
                if i == 0:
                    served(i, c, d)
                if i == 0 and mode != "NONE":
                    acc1 = unravel(snaps[1]["acc"][c] if rig else snaps[1]["acc"], entries)
                    chk.worst("grad_err", worst_leaf(acc1, s.acc, None, excluded_leaves(s)))
            chk.state(s, snaps[3], row, entries, w0, excluded_leaves(s))
            # a stretch of the window, from the program's state before it
            chk.part = f"camera {c} from frame {follow}"
            st = state_of(snaps[follow], c)
            base = unravel(snaps[follow]["flat"][c] if rig else snaps[follow]["flat"], entries)
            s = stream(base, st, draws=follow, seed=seed)
            for i in range(follow, follow + 3):
                d = s.step(*cam(i))
                if i == follow:
                    served(i, c, d)
            chk.state(s, snaps[follow + 3], row, entries, base, excluded_leaves(s))
            # frames sampled over the window, where the weights stay the seed's
            if mode == "NONE":
                chk.part = f"camera {c} sampled"
                s = stream(w0)
                for i in samples:
                    served(i, c, s.step(*cam(i)))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev_tf32
    chk.where["left out as round-off"] = sorted(chk.excluded)
    return chk.values, chk.where
