#!/usr/bin/env python3
"""KITTI-raw adaptation protocol runner on the PyTorch/CUDA port: the
papers' per-sequence D1 table end to end, from a local KITTI checkout and
the published pretrained checkpoint.

The counterpart of ``tools/kitti_eval.py``, with the same flags, lists,
rows and table. Protocol (reference ``Stereo_Continual_Adaptation.py:244-249``
for the metric, ``README.MD:46-63`` for the data and weights, TPAMI
"Continual Adaptation for Deep Stereo" §5 for the grouping of sequences):

* each *sequence* is one or more KITTI raw drives streamed in order at
  320x1216,
* every frame is scored with KITTI D1-all (error > 3 px and > 5 % of the
  ground truth) and EPE against the ground truth *before* that frame's
  adaptation update, then used to adapt (mode NONE, FULL or MAD),
* each sequence's averages make one row of the table.

Expected data layout (a KITTI raw sync+rect checkout):

    <kittiRoot>/<date>/<date>_drive_XXXX_sync/image_02/data/*.png   left
    <kittiRoot>/<date>/<date>_drive_XXXX_sync/image_03/data/*.png   right
    <gtRoot>/<drive>/<frame>.png      16-bit disparity PNG, value/256
    <proxyRoot>/<drive>/<frame>.png   optional proxy labels (TPAMI): with
                                      them the continual (proxy-loss)
                                      pipeline runs, else the CVPR
                                      photometric one

Weights: a JAX-layout ``.npz``, or the published TF1 checkpoint
(``README.MD:46-47`` of the reference), read with numpy alone
(``utils/checkpoint.py::read_tf1_checkpoint``) and cached as
``<output>/imported_weights.npz``.

    python tools/torch_kitti_eval.py \\
        --kittiRoot /data/kitti_raw --gtRoot /data/kitti_disp_gt \\
        --weights MADNet/synthetic/weights.ckpt \\
        --sequences city=2011_09_26_drive_0005_sync,2011_09_26_drive_0011_sync \\
        --mode MAD --output out/kitti_mad

Writes ``<output>/<sequence>__<mode>/`` with the CLI's artifacts, the
list ``<output>/<sequence>.csv``, ``<output>/kitti_table.csv`` and the
printed table

    sequence   mode  frames  avg_D1  avg_EPE  FPS  resets

It is host-side orchestration over the port's ``cli/adapt.py`` and
``cli/adapt_continual.py``. It reads no image itself: the CLIs decode the
frames (the native loader, or ``data/png.py``). It runs on the GPU;
``main(args, device="cpu")`` runs the plain PyTorch versions on the CPU.
It imports the port, numpy and torch, never JAX.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--kittiRoot", required=True, help="KITTI raw root")
    p.add_argument("--gtRoot", required=True, help="per-drive 16-bit GT disparity PNGs")
    p.add_argument("--proxyRoot", default=None, help="optional proxy disparities (TPAMI)")
    p.add_argument("--weights", required=True, help="published ckpt (.ckpt or .npz)")
    p.add_argument(
        "--sequences",
        required=True,
        help="name=drive[,drive...] specs separated by ';', or a JSON file "
        "{name: [drives]} (the paper's city/residential/campus/road groups)",
    )
    p.add_argument("--output", required=True)
    p.add_argument("--mode", default="MAD", choices=["NONE", "FULL", "MAD"])
    p.add_argument("--modelName", default="MADNet")
    p.add_argument("--blockConfig", default="block_config/MadNet_full.json")
    p.add_argument("--lr", type=float, default=0.0001)
    p.add_argument("--sampleMode", default="PROBABILITY")
    p.add_argument("--numBlocks", type=int, default=1)
    p.add_argument("--imageShape", type=int, nargs="+", default=[320, 1216])
    p.add_argument("--SSIMTh", type=float, default=0.5)
    p.add_argument("--dilation", type=int, default=1)
    p.add_argument("--decay", type=float, default=0.99)
    p.add_argument("--uf", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--maxFrames", type=int, default=None, help="cap frames/sequence")
    p.add_argument(
        "--listOnly",
        action="store_true",
        help="only build and validate the per-sequence CSV lists, then exit",
    )
    return p


def parse_sequences(spec: str):
    """'city=d1,d2;road=d3' or a JSON file path -> {name: [drives]}."""
    if os.path.isfile(spec):
        with open(spec) as f:
            data = json.load(f)
        return {str(k): list(v) for k, v in data.items()}
    out = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad --sequences entry {part!r} (want name=drive,...)")
        name, drives = part.split("=", 1)
        out[name.strip()] = [d.strip() for d in drives.split(",") if d.strip()]
    if not out:
        raise ValueError("--sequences parsed to nothing")
    return out


def _find_drive_dir(kitti_root: str, drive: str) -> str:
    """A drive's directory: directly under the root, or under one date
    directory; raises where it is missing or found under several."""
    direct = os.path.join(kitti_root, drive)
    if os.path.isdir(direct):
        return direct
    hits = glob.glob(os.path.join(kitti_root, "*", drive))
    if len(hits) == 1:
        return hits[0]
    raise FileNotFoundError(
        f"drive {drive!r} not found (or ambiguous: {hits}) under {kitti_root}"
    )


def build_sequence_list(
    kitti_root: str,
    gt_root: str,
    proxy_root,
    drives,
    out_csv: str,
    max_frames=None,
) -> int:
    """Write the reference-format CSV (left,right,gt[,proxy] absolute
    paths, ``README.MD:52-60``) of one sequence; returns its frame count.
    Frames without GT (KITTI's LiDAR GT skips some) are dropped, as the
    papers score only GT frames, and with ``proxy_root`` those without a
    proxy too. A flat ``<drive>/left_*.png`` layout is also read."""
    rows = []
    for drive in drives:
        ddir = _find_drive_dir(kitti_root, drive)
        lefts = sorted(glob.glob(os.path.join(ddir, "image_02", "data", "*")))
        if not lefts:
            lefts = sorted(glob.glob(os.path.join(ddir, "left_*")))
        for lp in lefts:
            frame = os.path.basename(lp)
            rp = lp.replace("image_02", "image_03").replace("left_", "right_")
            gp = os.path.join(gt_root, drive, frame.replace("left_", "gt_"))
            if not os.path.isfile(rp):
                raise FileNotFoundError(f"right image missing for {lp}: {rp}")
            if not os.path.isfile(gp):
                continue
            cols = [lp, rp, gp]
            if proxy_root is not None:
                pp = os.path.join(proxy_root, drive, frame.replace("left_", "proxy_"))
                if not os.path.isfile(pp):
                    continue
                cols.append(pp)
            rows.append(",".join(cols))
    if max_frames is not None:
        rows = rows[:max_frames]
    if not rows:
        raise FileNotFoundError(
            f"no usable frames for drives {drives} (left/right found but no GT?)"
        )
    with open(out_csv, "w") as f:
        f.write("\n".join(rows) + "\n")
    return len(rows)


def _resolve_weights(weights: str, model_name: str, out_dir: str) -> str:
    """A ``.npz`` passes through. A TF1 checkpoint is read once over the
    port model's ``tf_name_map()`` and cached in the JAX layout as
    ``<out_dir>/imported_weights.npz``; raises if no variable was restored.
    A variable the checkpoint lacks keeps the port model's seeded init
    (built on the CPU: only its values are kept)."""
    if weights.endswith(".npz"):
        return weights
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import (
        params_to_jax,
        save_params,
        tf1_checkpoint_to_params,
    )

    model = get_stereo_net(model_name, device="cpu")
    base = params_to_jax(model.state_dict())
    params, n = tf1_checkpoint_to_params(weights, model, base)
    if n == 0:
        raise ValueError(f"no variables restored from {weights}")
    cached = os.path.join(out_dir, "imported_weights.npz")
    save_params(cached, params)
    print(f"Imported {n} variables from TF1 checkpoint -> {cached}")
    return cached


def main(args, device=None) -> list:
    """Run the protocol of ``args`` (``build_argparser``) on ``device``:
    ``cuda`` unless ``device="cpu"``; raises where no GPU is available.
    Returns the table's rows (``[]`` with ``--listOnly``)."""
    from real_time_self_adaptive_deep_stereo_torch.utils.device import resolve_device

    device = resolve_device(device)
    os.makedirs(args.output, exist_ok=True)
    sequences = parse_sequences(args.sequences)

    lists = {}
    for name, drives in sequences.items():
        out_csv = os.path.join(args.output, f"{name}.csv")
        n = build_sequence_list(
            args.kittiRoot, args.gtRoot, args.proxyRoot, drives, out_csv,
            args.maxFrames,
        )
        lists[name] = (out_csv, n)
        print(f"sequence {name}: {n} frames ({len(drives)} drives)")
    if args.listOnly:
        return []

    weights = _resolve_weights(args.weights, args.modelName, args.output)
    use_proxy = args.proxyRoot is not None
    if use_proxy:
        from real_time_self_adaptive_deep_stereo_torch.cli import adapt_continual as runner
    else:
        from real_time_self_adaptive_deep_stereo_torch.cli import adapt as runner

    results = []
    for name, (list_csv, n) in lists.items():
        run_out = os.path.join(args.output, f"{name}__{args.mode.lower()}")
        os.makedirs(run_out, exist_ok=True)
        run_args = runner.build_argparser().parse_args(
            [
                "-l", list_csv,
                "-o", run_out,
                "--weights", weights,
                "--modelName", args.modelName,
                "--blockConfig", args.blockConfig,
                "--mode", args.mode,
                "--sampleMode", args.sampleMode,
                "--numBlocks", str(args.numBlocks),
                "--lr", str(args.lr),
                "--imageShape", str(args.imageShape[0]), str(args.imageShape[1]),
                "--SSIMTh", str(args.SSIMTh),
                "--seed", str(args.seed),
            ]
            + (
                ["--dilation", str(args.dilation), "--decay", str(args.decay),
                 "--uf", str(args.uf)]
                if use_proxy
                else []
            )
        )
        stats = runner.main(run_args, device=device)
        row = {
            "sequence": name,
            "mode": args.mode,
            "frames": n,
            "avg_d1": round(stats.get("avg_d1", float("nan")), 3),
            "avg_epe": round(stats.get("avg_epe", float("nan")), 3),
            "fps": round(stats.get("fps", 0.0), 2),
            "resets": stats.get("resets", 0),
        }
        results.append(row)
        print(
            f"[{name}] D1 {row['avg_d1']:.3f}%  EPE {row['avg_epe']:.3f}  "
            f"{row['fps']:.1f} FPS  resets {row['resets']}"
        )

    table = os.path.join(args.output, "kitti_table.csv")
    with open(table, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(results[0].keys()))
        w.writeheader()
        w.writerows(results)
    print(f"\n{'sequence':<16}{'mode':<6}{'frames':>7}{'D1':>8}{'EPE':>8}{'FPS':>8}")
    for r in results:
        print(
            f"{r['sequence']:<16}{r['mode']:<6}{r['frames']:>7}"
            f"{r['avg_d1']:>8.3f}{r['avg_epe']:>8.3f}{r['fps']:>8.2f}"
        )
    print(f"Table saved to {table}")
    return results


if __name__ == "__main__":
    main(build_argparser().parse_args())
