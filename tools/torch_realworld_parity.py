#!/usr/bin/env python3
"""End-to-end accuracy parity of the PyTorch/CUDA port on real-imagery
frames at the reference's KITTI operating resolution (320x1216).

The counterpart of ``tools/realworld_parity.py``: the checked-in
real-photograph fixture (``tests/fixtures/realworld``: photographic
texture, occlusion-aware ground truth in KITTI's 16-bit PNG format) cycled
into a sequence and run through the port's online-adaptation loop
(``tools/torch_parity_results.py::run_our_loop``, exact: gather warps, the
plain correlation, fp32 ``highest``) in NONE and MAD (and FULL with
``--full``), SEQUENTIAL, lr 1e-4, SSIMTh 0.5. With ``--reference JSON``
(``tests/fixtures/torch_parity_reference.json``) the JAX loop's rows on the
same frames and weights stand beside the port's, with the first and last
quarter's and each mode's D1 delta against the north star's 0.5 points. The
JAX tool's TF1 loop is left out: the repository lacks TensorFlow and the
reference's code.

    python tools/torch_realworld_parity.py --paramsNpz tests/fixtures/realworld/weights_scene01.npz \\
        --scenes scene2,scene3 --full --reference tests/fixtures/torch_parity_reference.json

The PNGs are read with the port's decoder (``data/png.py``), not PIL. Runs
on the card unless ``--device cpu``; without ``--out`` the section goes to
stdout. Imports the port, numpy and torch, never JAX.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools.torch_parity_results import (  # noqa: E402
    TABLE_HEAD,
    emit,
    fmt_row,
    find_reference,
    initial_weights,
    parity_runs,
    run_our_loop,
    verdict_lines,
)

FIXTURE = ROOT / "tests" / "fixtures" / "realworld"


def load_fixture_sequence(frames: int, height: int, width: int, scenes_filter=None):
    """Cycle the fixture scenes (sorted by name; ``scenes_filter``, a set of
    scene names, keeps some) into ``frames`` tuples of (left, right, ground
    truth) float32 arrays; the ground truth is the 16-bit PNG over 256. A
    smaller size is an integer nearest downscale of 320x1216, the ground
    truth divided by the factor."""
    from real_time_self_adaptive_deep_stereo_torch.data.png import read_pngs

    scenes = []
    for lp in sorted(glob.glob(os.path.join(FIXTURE, "*_left.png"))):
        name = os.path.basename(lp)[: -len("_left.png")]
        if scenes_filter and name not in scenes_filter:
            continue
        left, right, gt = (a.astype(np.float32) for a in read_pngs(
            [lp, os.path.join(FIXTURE, f"{name}_right.png"), os.path.join(FIXTURE, f"{name}_gt.png")]))
        gt = gt / 256.0
        if (height, width) != left.shape[:2]:
            # integer-factor nearest downscale keeps GT semantics exact
            fy = left.shape[0] // height
            fx = left.shape[1] // width
            assert fy >= 1 and fx >= 1 and fy == fx, (
                "use an integer common downscale factor of 320x1216"
            )
            left = left[::fy, ::fx][:height, :width]
            right = right[::fy, ::fx][:height, :width]
            gt = gt[::fy, ::fx][:height, :width] / fy  # disparity scales with W
        scenes.append((left, right, gt))
    assert scenes, f"fixture missing — run tools/realworld_fixture.py ({FIXTURE})"
    return [scenes[i % len(scenes)] for i in range(frames)]


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--height", type=int, default=320)
    ap.add_argument("--width", type=int, default=1216)
    ap.add_argument("--pretrainSteps", type=int, default=200)
    ap.add_argument(
        "--paramsNpz",
        default="",
        help="skip pretraining, load these params (the committed "
        "held-out-protocol weights are "
        "tests/fixtures/realworld/weights_scene01.npz — trained on "
        "scene0/1, adapt with --scenes scene2,scene3)",
    )
    ap.add_argument("--scenes", default="", help="comma-separated fixture scenes to adapt on (default all)")
    ap.add_argument("--full", action="store_true", help="also run FULL mode")
    ap.add_argument("--out", default=None, help="write the section into this markdown file (default: stdout)")
    ap.add_argument("--reference", default=None,
                    help="the JAX loop's rows (tests/fixtures/torch_parity_reference.json)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return ap


def main_realworld(args, loop=run_our_loop):
    """NONE and MAD (and FULL with ``--full``) exact on the fixture
    sequence, beside the JAX loop's rows with ``--reference``. Returns (the
    section, ``parity_runs``'s results); ``loop`` stands in for
    ``run_our_loop``."""
    from real_time_self_adaptive_deep_stereo_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    scenes_filter = set(args.scenes.split(",")) if args.scenes else None
    seq = load_fixture_sequence(args.frames, args.height, args.width, scenes_filter)
    print(f"{len(seq)} frames @ {args.height}x{args.width} (real imagery)", flush=True)
    params = initial_weights(args, device, size=(96, 320))
    reference = (find_reference(args.reference, "realworld", args.height, args.width, args.frames,
                                scenes_filter) if args.reference else None)
    modes = ("NONE", "MAD") + (("FULL",) if args.full else ())
    results = parity_runs(modes, seq, params, reference, device, loop)

    asym = bool(scenes_filter) and any(s.startswith("asym") for s in scenes_filter)
    lines = [
        f"## Real-imagery parity of the PyTorch/CUDA port vs the JAX loop ({device.type}, fp32) — "
        + ("PHOTOMETRICALLY ASYMMETRIC fixture @ " if asym else "photographic fixture @ ")
        + f"{args.height}x{args.width}"
        + (f" — scenes {args.scenes}" if args.scenes else ""),
        "",
        f"{args.frames} frames cycling tests/fixtures/realworld"
        + (f" scenes {{{args.scenes}}}" if args.scenes else "")
        + " (real photographs, occlusion-aware GT, KITTI 16-bit-PNG format), "
        + (f"initial weights from `{os.path.basename(args.paramsNpz)}`" if args.paramsNpz
           else "synthetic-pretrained weights")
        + ", SEQUENTIAL sampling, lr=1e-4, SSIMTh=0.5; exact numerics. "
        + (f"JAX loop: `{args.reference}`, set `{reference[0]}`." if reference else
           "No reference rows (--reference); the TF1 loop is not in the repository."),
        "",
        *TABLE_HEAD,
    ]
    q = max(len(seq) // 4, 1)  # adaptation trend: first vs last quarter
    for mode, r in results.items():
        named = ([("JAX loop", r["ref_rows"], r["ref_resets"])] if reference else []) + [
            ("port", r["rows"], r["resets"])]
        for who, rows, resets in named:
            lines.append(fmt_row(f"{who} {mode}", rows, resets))
        if mode != "NONE":
            for who, rows, _ in named:
                lines.append(fmt_row(f"{who} {mode} (first {q}f)", rows[:q], ""))
                lines.append(fmt_row(f"{who} {mode} (last {q}f)", rows[-q:], ""))
            print(f"  adaptation trend (D1 first->last {q}f): "
                  + "  ".join(f"{who} {rows[:q].mean(0)[2]:.2f}->{rows[-q:].mean(0)[2]:.2f}"
                              for who, rows, _ in named), flush=True)
    lines += ["", *verdict_lines(results, "real-imagery D1-all delta")]
    return "\n".join(lines).rstrip("\n"), results


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    emit(main_realworld(args)[0], args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
