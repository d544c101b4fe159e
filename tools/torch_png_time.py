#!/usr/bin/env python3
"""Time the port's PNG decoder on the fixture frames of
``tests/fixtures/realworld`` (320x1216), on this host's CPU.

    python tools/torch_png_time.py [--reps 5]

Prints, per fixture PNG, the median and best of ``--reps`` decodes by
``data/png.py::read_png`` and, per scene, of ``read_pngs`` over the frame's
left, right and ground-truth images in one sweep.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from real_time_self_adaptive_deep_stereo_torch.data.png import read_png, read_pngs  # noqa: E402

FIXTURE = ROOT / "tests" / "fixtures" / "realworld"


def timed(fn, reps):
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms), min(ms)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    rgb = []
    for path in sorted(FIXTURE.glob("*.png")):
        med, best = timed(lambda: read_png(str(path)), args.reps)
        if not path.name.endswith("_gt.png"):
            rgb.append(med)
        print(f"{path.name}: median {med:.1f} ms, best {best:.1f} ms")
    frames = []
    for scene in sorted({p.name.rsplit("_", 1)[0] for p in FIXTURE.glob("*_left.png")}):
        paths = [str(FIXTURE / f"{scene}_{k}.png") for k in ("left", "right", "gt")]
        med, best = timed(lambda: read_pngs(paths), args.reps)
        frames.append(med)
        print(f"{scene} frame (left, right, gt in one sweep): median {med:.1f} ms, best {best:.1f} ms")
    print(f"RGB images: medians {min(rgb):.1f}-{max(rgb):.1f} ms; frames: medians "
          f"{min(frames):.1f}-{max(frames):.1f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
