"""The harness on the CPU at a tiny size: found by name, data-driven, its
result line, and the output check failing on faults planted in the timed
path. No device metric is reported off the card."""

import json
import subprocess
import sys

import pytest

from stereo_bench import faults
from stereo_bench.harness import run_cell
from stereo_bench.tests.tiny import BENCH, ROOT, SEED, make_tiny_root

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("workload", ["madnet-mad-stream", "madnet-none-stream", "madnet-mad-rig4",
                                      "dispnet-full-stream"])
def test_a_cell_runs_correct(tiny, workload):
    r = run_cell(workload, SEED, 0.5, False, "cpu", root=tiny)
    assert list(r)[: len(KEYS)] == KEYS and list(r)[-1] == "checks" and "breakdown" not in r
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"frames_per_s", "disp_p95_ms", "setup_s"}
    assert r["device"]["platform"] == "cpu" and "busy_s" not in r["device"]
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


def test_traced_run_reports_no_device_metric_off_the_card(tiny):
    r = run_cell("madnet-mad-stream", SEED, 0.5, True, "cpu", root=tiny)
    assert set(r["metrics"]) == {"host_issue_ms"}  # the one host-clock metric
    assert "breakdown" not in r and "busy_s" not in r["device"]


@pytest.mark.parametrize("workload,fault", [("madnet-mad-stream", "frozen"), ("madnet-mad-stream", "altered"),
                                            ("madnet-none-stream", "altered"), ("madnet-mad-rig4", "half"),
                                            ("madnet-mad-rig4", "frozen")])
def test_a_fault_in_the_timed_path_is_caught(tiny, workload, fault):
    with faults.planted(fault):
        r = run_cell(workload, SEED, 0.5, False, "cpu", root=tiny)
    assert not r["correct"], r["checks"]


def test_new_files_are_found_by_name(tiny, tmp_path):
    """A configuration, a mix and a per-layer metric added as files, and
    their entries: found, with no file of the harness edited."""
    import shutil

    root = tmp_path / "checkout"
    shutil.copytree(tiny, root)
    before = {p: p.read_bytes() for p in (root / BENCH.name).rglob("*") if p.is_file()}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "stereo_bench/configs/madnet-kitti-320x1216-fp32.json").read_text())
    cfg["name"] = "madnet-tiny-wide"
    cfg["input"]["width"] = 192
    (root / "stereo_bench/configs/madnet-tiny-wide.json").write_text(json.dumps(cfg))
    trf = json.loads((root / "stereo_bench/traffic/stream-none.json").read_text())
    trf["frames_per_camera"] = 3
    (root / "stereo_bench/traffic/stream-none-short.json").write_text(json.dumps(trf))
    (root / "stereo_bench/limits/madnet-tiny-none.json").write_text(json.dumps({"fwd_err": 1e-4, "step_mismatch": 0}))
    (root / "stereo_bench/layer_metrics/frames_handed.py").write_text(
        "def read(ctx):\n    return float(ctx.window['frames'])\n")
    bench["configs"].append({"name": "madnet-tiny-wide", "source": "test", "file": "stereo_bench/configs/madnet-tiny-wide.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "madnet-tiny-none", "config": "madnet-tiny-wide", "traffic": "stream-none-short",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "frames_handed", "unit": "frames", "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "frames_per_s", "workloads": ["madnet-tiny-none"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run_cell("madnet-tiny-none", SEED, 0.3, True, "cpu", root=root)
    assert r["correct"]
    assert r["metrics"]["frames_handed"]["value"] > 0 and "host_issue_ms" in r["metrics"]
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_unknown_workload_fails_clearly():
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "no-such-cell", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True)
    assert p.returncode != 0 and not p.stdout.strip()
    assert "unknown workload 'no-such-cell'" in p.stderr


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the benchmark runs")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "madnet-mad-stream", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True)
    assert p.returncode != 0 and not p.stdout.strip()
    assert "no CUDA device" in p.stderr
