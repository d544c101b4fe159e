"""The op counts of ``rooflines/`` against hand counts, and their least
times against the ``bound`` column of the kernel checks that ran on the
card at the main path's shapes (``chip_smoke.py`` phase 3, ``PERF.md``'s
table of kernels: bytes over 3.35 TB/s or fp32 operations over 67
TFLOP/s, in ms, rounded as printed there)."""

import json
from pathlib import Path

import pytest

from stereo_bench import rooflines

PEAK = json.loads((Path(rooflines.__file__).parent / "peaks.json").read_text())
FP32, HBM = PEAK["fp32"]["value"], PEAK["hbm"]["value"]
MADNET_CORR = [(192, 5, 19), (128, 10, 38), (96, 20, 76), (64, 40, 152), (32, 80, 304)]  # scales 6..2 at 320x1216
MADNET_FEAT = MADNET_CORR[1:]


def corr(kind, c, h, w, r, grads=("x", "y")):
    args = {"b": 1, "c": c, "h": h, "w": w, "radius": r}
    return (kind, dict(args, grads=grads) if kind.endswith("bwd") else args)


def warp(kind, c, h, w, grads=()):
    args = {"b": 1, "c": c, "h": h, "w": w}
    return (kind, dict(args, grads=grads) if kind.endswith("bwd") else args)


def test_hand_counts():
    # corr at C=2, 1x3 pixels, radius 1: 3 shifts; x, y read (2*2*3), 9 outputs
    assert rooflines.count(corr("corr_fwd", 2, 1, 3, 1)) == (2 * 3 * 2 * 3, 4 * (12 + 9))
    # its backward, dx alone: the 9 gradient entries and y read, dx written
    assert rooflines.count(corr("corr_bwd", 2, 1, 3, 1, ("x",))) == (2 * 3 * 2 * 3, 4 * (9 + 12))
    assert rooflines.count(corr("corr_bwd", 2, 1, 3, 1)) == (2 * 2 * 3 * 2 * 3, 4 * (9 + 24))
    # warp of 3 channels over 4 pixels: source and offset read, output written
    assert rooflines.count(warp("warp_fwd", 3, 1, 4)) == (3 * 3 * 4, 4 * 4 * 7)
    # the image warp's backward for the offset alone: g, source, offset read, doff written
    assert rooflines.count(warp("warp_bwd", 3, 1, 4, ("off",))) == (4 * 3 * 4, 4 * 4 * (6 + 2))
    assert rooflines.count(warp("warp_bwd", 3, 1, 4, ("src",))) == (4 * 3 * 4, 4 * 4 * (6 + 1))
    # bf16 halves the bytes
    assert rooflines.count(corr("corr_fwd", 2, 1, 3, 1), itemsize=2)[1] == 2 * (12 + 9)


def ms(records):
    return 1e3 * sum(rooflines.least_seconds(r, FP32, HBM) for r in records)


@pytest.mark.parametrize("records,bound_ms", [
    ([corr("corr_fwd", c, h, w, 2) for c, h, w in MADNET_CORR], 0.0035),  # K1, MADNet's five scales
    ([corr("corr_bwd", c, h, w, 2) for c, h, w in MADNET_CORR], 0.0068),
    ([corr("corr_fwd", 128, 80, 304, 40)], 0.0098),  # DispNet's radius 40
    ([corr("corr_bwd", 128, 80, 304, 40)], 0.0172),
    ([warp("warp_fwd", 3, 320, 1216)], 0.0033),  # K2, the loss's image warp
    ([warp("warp_bwd", 3, 320, 1216, ("off",))], 0.0037),  # K4, ddisp alone (the main path's)
    ([warp("warp_bwd", 3, 320, 1216, ("src", "off"))], 0.0051),
    ([warp("warp_fwd", c, h, w) for c, h, w in MADNET_FEAT], 0.0033),  # K3, scales 5..2
    ([warp("warp_bwd", c, h, w, ("src",)) for c, h, w in MADNET_FEAT], 0.00329),  # K5, dfeats alone
    ([warp("warp_bwd", c, h, w, ("src", "off")) for c, h, w in MADNET_FEAT], 0.0050),
])
def test_least_time_is_the_kernel_checks_bound(records, bound_ms):
    digits = len(str(bound_ms).split(".")[1])
    assert round(ms(records), digits) == pytest.approx(bound_ms, abs=10 ** -digits)


def test_peaks_have_their_source():
    assert "H100 SXM" in PEAK["source"]
    assert PEAK["fp32"]["value"] == 67e12 and PEAK["hbm"]["value"] == 3.35e12
