#!/usr/bin/env python3
"""The accuracy half of the north star on the PyTorch/CUDA port: EPE,
bad3 and D1 of the port's online-adaptation loop, frame by frame, held to
the JAX package's loop on the same frames and weights; and with ``--drift``
the precision drift of the port's fast path.

The counterpart of ``tools/parity_results.py``. Two measurement modes:

* default: the port's host session (``adapt/runner.py``) in NONE, MAD and
  FULL on the synthetic domain-shift sequence, exact. With ``--reference
  JSON`` (``tests/fixtures/torch_parity_reference.json``, the JAX tool's
  own ``run_our_loop`` on the same frames and weights, made on a CPU by
  ``tools/torch_cli_reference.py --parity``) the JAX loop's rows stand
  beside the port's, with each mode's D1 delta against the north star's
  0.5 points (``BASELINE.json``). The JAX tool's TF1 loop is left out: it
  needs TensorFlow and the reference's code, which the repository lacks.
* ``--drift``: the same loops exact, then fast in ``default``, ``bf16`` and
  ``bf16_act``, and the drift of each fast run from the exact one, against
  the 0.1-point bound by which ``PARITY_RESULTS.md`` promoted ``bf16_act``.

*Exact* is the reference's numerics, named by the caller: ``gather`` warps,
the plain correlation (``corr_mode="torch"``, JAX's ``"jnp"``) and fp32
``highest`` convolutions with TF32 off. *Fast* is the card's path: the
warp mode given (``auto``, the clamped-window kernels K2-K5 on the card;
``mxu``, the tiled K6/K7), the correlation kernels (their bf16 instances
under ``bf16_act``) and the precision mode given.

    python tools/torch_parity_results.py --paramsNpz tests/fixtures/realworld/weights_scene01.npz \\
        --reference tests/fixtures/torch_parity_reference.json [--out FILE]
    python tools/torch_parity_results.py --drift [--height 384 --width 1280]

Runs on the card unless ``--device cpu``; without ``--out`` the section goes
to stdout, and no default writes a file (``PARITY_RESULTS.md`` holds the
JAX package's rows and is refused). Imports the port, numpy and torch,
never JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools.torch_validate_adaptation import make_sequence, pretrain  # noqa: E402

BLOCK_CONFIG = ROOT / "block_config" / "MadNet_full.json"
MODES = ("NONE", "MAD", "FULL")
# the fast runs of --drift: (precision mode, warp mode)
DRIFT_RUNS = (("default", "auto"), ("bf16", "auto"), ("bf16_act", "auto"))
NORTH_STAR = 0.5  # D1-all points (BASELINE.json)
PROMOTION_BOUND = 0.1  # D1-all points of drift (PARITY_RESULTS.md, the bf16_act promotion)
TABLE_HEAD = ("| run | EPE | bad3 | D1-all | resets |", "|---|---|---|---|---|")


def _metrics(disp, gt):
    valid = gt > 0
    err = np.abs(disp - gt)
    epe = float(err[valid].mean())
    bad3 = float((err[valid] > 3.0).mean())
    d1 = float(
        100.0
        * ((err > 3.0) & (err / np.maximum(gt, 1e-9) >= 0.05) & valid).sum()
        / max(valid.sum(), 1)
    )
    return epe, bad3, d1


def load_weights(params):
    """A ``state_dict`` from ``params``: the path of a JAX-layout ``.npz``
    (``utils/checkpoint.py::load_params``), a JAX-layout tree, or a
    ``state_dict`` (returned as it is)."""
    import torch

    from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import load_params, params_from_jax

    if isinstance(params, (str, os.PathLike)):
        params = load_params(str(params))
    if all(isinstance(v, torch.Tensor) for v in params.values()):
        return params
    return params_from_jax(params)


def run_our_loop(mode, seq, params, lr=1e-4, ssim_th=0.5, fast=False, precision="default",
                 warp_mode="auto", device=None):
    """The port's host session on ``seq`` (tuples of left, right and ground
    truth, numpy) from ``params`` (:func:`load_weights`): MADNet (with the
    bulkhead for MAD), ``block_config/MadNet_full.json``, momentum at
    ``lr``, SEQUENTIAL sampling, ``ssim_th``, seed 0. ``fast=False`` is the
    exact numerics (gather warps, the plain correlation, ``highest``);
    ``fast=True`` runs ``warp_mode``, the correlation kernels and
    ``precision``. Returns the per-frame (EPE, bad3, D1) rows and the
    reset count; the precision goes back to ``highest`` (TF32 off) after."""
    from real_time_self_adaptive_deep_stereo_torch.adapt import (
        AdaptationEngine,
        OnlineAdaptationSession,
        load_block_config,
        make_blocks,
    )
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.ops.conv import set_conv_precision

    wm = warp_mode if fast else "gather"
    set_conv_precision(precision if fast else "highest")
    try:
        model = get_stereo_net(
            "MADNet", bulkhead=(mode == "MAD"), warp_mode=wm,
            corr_mode="auto" if fast else "torch", device=device,
        )
        model.load_state_dict(load_weights(params))
        blocks = make_blocks(load_block_config(str(BLOCK_CONFIG)), model)
        engine = AdaptationEngine(model, blocks, lr=lr, warp_mode=wm, device=device)
        sess = OnlineAdaptationSession(
            engine, mode=mode, sample_mode="SEQUENTIAL", ssim_th=ssim_th, seed=0,
        )
        rows = []
        for left, right, gt in seq:
            frame = {"left": left[None], "right": right[None], "target": gt[None, ..., None]}
            out = sess.step({k: np.ascontiguousarray(v) for k, v in frame.items()})
            rows.append(_metrics(out["disp"][0, ..., 0].cpu().numpy(), gt))
        return np.asarray(rows), sess.stats.reset_counter
    finally:
        set_conv_precision("highest")


def fmt_row(name, rows, resets):
    epe, bad3, d1 = rows.mean(axis=0)
    return f"| {name} | {epe:.3f} | {100*bad3:.2f}% | {d1:.2f}% | {resets} |"


def initial_weights(args, device, size=None):
    """``--paramsNpz``'s weights, else MADNet pretrained for
    ``--pretrainSteps`` at ``size`` (the run's by default) from the port's
    seeded weights (``tools/torch_validate_adaptation.py::pretrain``)."""
    if args.paramsNpz:
        print(f"loaded initial weights from {args.paramsNpz}", flush=True)
        return load_weights(args.paramsNpz)
    h, w = size or (args.height, args.width)
    print(f"pretraining initial weights on scene A @ {h}x{w} ...", flush=True)
    return pretrain(h, w, steps=args.pretrainSteps, device=device)[0]


def find_reference(path, kind, height, width, frames, scenes=None):
    """The set of the reference JSON whose sequence (``kind``, size, frames,
    scenes) is this run's: (its name, the set). Raises where none is."""
    sets = json.loads(Path(path).read_text())["sets"]
    key = {name: (s["kind"], s["height"], s["width"], s["frames"], sorted(s["scenes"] or ()))
           for name, s in sets.items()}
    want = (kind, height, width, frames, sorted(scenes or ()))
    for name, s in sets.items():
        if key[name] == want:
            return name, s
    raise ValueError(f"{path} has no set for {want}; its sets: {key}")


def compare(ours, ref):
    """The port's rows against the reference's: the D1 delta of the means
    and the largest per-frame |delta| of D1 and EPE."""
    diff = np.abs(ours - ref)
    return {"d1_delta": float(abs(ours.mean(axis=0)[2] - ref.mean(axis=0)[2])),
            "max_frame_d1": float(diff[:, 2].max()), "max_frame_epe": float(diff[:, 0].max())}


def parity_runs(modes, seq, params, reference, device, loop):
    """Each mode's exact loop, beside the reference set's rows when given:
    {mode: {"rows", "resets", and with a reference "ref_rows", "ref_resets"
    and :func:`compare`'s deltas}}."""
    results = {}
    for mode in modes:
        print(f"port loop, mode={mode} ...", flush=True)
        rows, resets = loop(mode, seq, params, device=device)
        results[mode] = {"rows": rows, "resets": resets}
        if reference is not None:
            ref = reference[1]["modes"][mode]
            results[mode].update(ref_rows=np.asarray(ref["rows"]), ref_resets=ref["resets"],
                                 **compare(rows, np.asarray(ref["rows"])))
            print(f"mode={mode}: D1 delta = {results[mode]['d1_delta']:.3f}%", flush=True)
    return results


def verdict_lines(results, what="D1-all delta"):
    """The north star's verdict a mode, worded as the JAX tool's, and the
    largest per-frame deltas."""
    lines = []
    for mode, r in results.items():
        if "d1_delta" not in r:
            continue
        status = "PASS" if r["d1_delta"] < NORTH_STAR else "FAIL"
        lines.append(f"- {what} ({mode}): **{r['d1_delta']:.3f}%** (north-star < 0.5%: {status})")
        lines.append(f"  - largest per-frame delta: D1 {r['max_frame_d1']:.3f} points, EPE "
                     f"{r['max_frame_epe']:.4f}; resets {r['resets']} against the JAX loop's {r['ref_resets']}")
    return lines


def main_parity(args, loop=run_our_loop):
    """NONE, MAD and FULL exact on the synthetic sequence, beside the JAX
    loop's rows with ``--reference``. Returns (the section, :func:`parity_runs`'s
    results); ``loop`` stands in for :func:`run_our_loop`."""
    from real_time_self_adaptive_deep_stereo_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    params = initial_weights(args, device)
    seq = make_sequence(args.height, args.width, args.frames, seed=7, d_bg=8.0, d_fg=20.0)
    reference = (find_reference(args.reference, "synthetic", args.height, args.width, args.frames)
                 if args.reference else None)
    results = parity_runs(MODES, seq, params, reference, device, loop)
    weights = f"`{os.path.basename(args.paramsNpz)}`" if args.paramsNpz else "pretrained"
    lines = [
        f"## End-to-end adaptation parity of the PyTorch/CUDA port vs the JAX loop ({device.type}, fp32)",
        "",
        f"Synthetic domain-shift sequence, {args.frames} frames @ {args.height}x{args.width}, "
        f"identical {weights} weights, SEQUENTIAL block sampling, lr=1e-4, SSIMTh=0.5; exact numerics "
        "(gather warps, the plain correlation, fp32 highest convolutions, TF32 off). "
        + (f"JAX loop: `{args.reference}`, set `{reference[0]}`." if reference else
           "No reference rows (--reference); the TF1 loop is not in the repository."),
        "",
        *TABLE_HEAD,
    ]
    for mode, r in results.items():
        if reference is not None:
            lines.append(fmt_row(f"JAX loop {mode}", r["ref_rows"], r["ref_resets"]))
        lines.append(fmt_row(f"port {mode}", r["rows"], r["resets"]))
    lines += ["", *verdict_lines(results)]
    return "\n".join(lines).rstrip("\n"), results


def main_drift(args, runs=DRIFT_RUNS, loop=run_our_loop):
    """Each mode exact, then fast in each (precision, warp mode) of
    ``runs``, and each fast run's drift from the exact one. Returns (the
    section, {mode: {"exact": (rows, resets), "fast": {label: (rows,
    resets)}, "drift": {label: mean delta of (EPE, bad3, D1)}}}); a label
    is the precision mode, with ``/warp`` where the warp mode is not
    ``auto``."""
    from real_time_self_adaptive_deep_stereo_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    params = initial_weights(args, device)
    seq = make_sequence(args.height, args.width, args.frames, seed=7, d_bg=8.0, d_fg=20.0)
    lines = [
        f"## Precision drift of the port's fast mode (one GPU, {device.type})"
        + ("" if (args.height, args.width) == (96, 320) else f" @ {args.height}x{args.width}"),
        "",
        f"Same sequence/protocol as above, {args.frames} frames @ {args.height}x{args.width}. "
        "exact = gather warps + the plain correlation + fp32 highest convolutions, TF32 off; "
        "fast = the warp mode (`auto`: the clamped-window CUDA kernels K2-K5; `mxu`: the tiled "
        "K6/K7), the correlation kernels and the given precision mode.",
        "",
        *TABLE_HEAD,
    ]
    results, bounds = {}, []
    for mode in MODES:
        exact, r1 = loop(mode, seq, params, fast=False, device=device)
        lines.append(fmt_row(f"exact {mode}", exact, r1))
        results[mode] = {"exact": (exact, r1), "fast": {}, "drift": {}}
        for prec, wm in runs:
            label = prec if wm == "auto" else f"{prec}/{wm}"
            fast, r2 = loop(mode, seq, params, fast=True, precision=prec, warp_mode=wm, device=device)
            d = fast.mean(axis=0) - exact.mean(axis=0)
            results[mode]["fast"][label], results[mode]["drift"][label] = (fast, r2), d
            lines.append(fmt_row(f"fast/{label} {mode}", fast, r2))
            lines.append(f"| drift/{label} {mode} | {d[0]:+.4f} | {100*d[1]:+.3f}% | {d[2]:+.3f}% | |")
            within = "within" if abs(d[2]) <= PROMOTION_BOUND else "beyond"
            bounds.append(f"- D1-all drift ({label} {mode}): **{d[2]:+.3f}%** "
                          f"(promotion bound {PROMOTION_BOUND}%: {within})")
            print(f"mode={mode} prec={label}: EPE drift {d[0]:+.4f}, D1 drift {d[2]:+.3f}%", flush=True)
    lines += ["", *bounds, "",
              "The drift is a reading of the precision mode against the exact loop, not a check of the port."]
    return "\n".join(lines), results


def write_section(path, section):
    """Write ``section`` into the markdown file ``path`` as the JAX tool
    does: under the file's header, replacing a section of the same heading.
    ``PARITY_RESULTS.md`` holds the JAX package's rows and is refused."""
    if Path(path).resolve() == (ROOT / "PARITY_RESULTS.md").resolve():
        raise ValueError("PARITY_RESULTS.md holds the JAX package's rows; write the port's elsewhere")
    header = "# PARITY_RESULTS — accuracy parity & precision drift\n"
    existing = Path(path).read_text() if os.path.exists(path) else ""
    if not existing.startswith("# PARITY_RESULTS"):
        existing = header + "\n"
    marker = section.splitlines()[0]
    if marker in existing:  # replace the section
        existing = existing.split(marker)[0]
    Path(path).write_text(existing.rstrip("\n") + "\n\n" + section + "\n")


def emit(section, out=None):
    """``section`` into the markdown file ``out`` (:func:`write_section`), or to stdout."""
    if out:
        write_section(out, section)
        print(f"wrote {out}")
    else:
        print(section)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--pretrainSteps", type=int, default=200)
    ap.add_argument("--drift", action="store_true", help="the fast path's precision drift")
    ap.add_argument("--out", default=None, help="write the section into this markdown file (default: stdout)")
    ap.add_argument(
        "--paramsNpz", default="",
        help="skip pretraining, load these JAX-layout params (e.g. "
        "tests/fixtures/realworld/weights_scene01.npz, the weights of the reference rows)",
    )
    ap.add_argument("--reference", default=None,
                    help="the JAX loop's rows (tests/fixtures/torch_parity_reference.json)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    emit((main_drift(args) if args.drift else main_parity(args))[0], args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
