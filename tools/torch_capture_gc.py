#!/usr/bin/env python3
"""Whether a garbage collection during a fused session's CUDA-graph capture
ends the capture, on the card.

    python tools/torch_capture_gc.py [--rounds 10] [--height 128 --width 256]

Each round leaves a fused MADNet MAD session as garbage in a reference
cycle (two branches captured and replayed, its pinned staging and fetch
buffers used), then builds a new session and steps it through two frames,
whose branches are captured at first use. Three variants, each in a
process of its own, which stops at its first failed round:

* ``collect-dead``: ``gc.collect()`` right after each capture begins,
  with the dead session waiting to be collected;
* ``collect-clean``: the same collection, with nothing of CUDA's waiting
  (the dead session collected before the new one is built);
* ``automatic``: no forced collection; a collection due at every few
  allocations (``gc.set_threshold(1)``) while ``adapt/fused.py`` keeps the
  collector off during its captures.

A variant that reads ``failed`` names the round and the error. Prints one
JSON line per variant; the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VARIANTS = ("collect-dead", "collect-clean", "automatic")


def frames(h: int, w: int, n: int):
    r = np.random.default_rng(0)
    return [{"left": (r.random((1, h, w, 3)) * 255).astype(np.float32),
             "right": (r.random((1, h, w, 3)) * 255).astype(np.float32)} for _ in range(n)]


def session():
    from real_time_self_adaptive_deep_stereo_torch.adapt import (
        AdaptationEngine,
        FusedOnlineSession,
        default_block_config_path,
        load_block_config,
        make_blocks,
    )
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net

    net = get_stereo_net("MADNet", bulkhead=True)
    blocks = make_blocks(load_block_config(default_block_config_path("MADNet")), net)
    engine = AdaptationEngine(net, blocks, lr=1e-4, optimizer="momentum")
    return FusedOnlineSession(engine, mode="MAD", sample_mode="SEQUENTIAL", compute_metrics=False)


def run_variant(variant: str, rounds: int, h: int, w: int) -> dict:
    import torch

    pairs = frames(h, w, 2)
    begin = torch.cuda.CUDAGraph.capture_begin
    if variant != "automatic":
        def capture_begin(self, *a, **k):
            begin(self, *a, **k)
            gc.collect()

        torch.cuda.CUDAGraph.capture_begin = capture_begin
    else:
        gc.set_threshold(1, 1, 1)
    for i in range(rounds):
        try:
            old = session()
            for f in pairs:
                old.step(f)
            old.fetch_disp()()
            old.cycle = old  # only the collector frees it
            del old
            if variant == "collect-clean":
                gc.collect()
            new = session()
            for f in pairs:
                new.step(f)
            new.fetch_disp()()
            torch.cuda.synchronize()
            del new
            gc.collect()  # before the next round's first capture
        except Exception as e:  # the round's failure is the reading
            return {"variant": variant, "result": "failed", "round": i, "error": f"{type(e).__name__}: {e}"[:400]}
    return {"variant": variant, "result": "passed", "rounds": rounds}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--variant", choices=VARIANTS, default=None, help="run one variant in this process")
    args = ap.parse_args()
    if args.variant:
        print(json.dumps(run_variant(args.variant, args.rounds, args.height, args.width)), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for variant in VARIANTS:
        out = subprocess.run([sys.executable, __file__, "--variant", variant, "--rounds", str(args.rounds),
                              "--height", str(args.height), "--width", str(args.width)],
                             capture_output=True, text=True, timeout=600)
        lines = out.stdout.strip().splitlines()
        print(lines[-1] if lines else json.dumps({"variant": variant, "result": f"exit {out.returncode}",
                                                  "stderr": out.stderr[-400:]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
