"""The spans stretch's readers (``spans.py``, ``layer_metrics/``): each
number on a record made by hand, the log's parts, a program without the
tracer read as nothing, and a tiny traced run on the CPU."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from stereo_bench import spans
from stereo_bench.harness import run_cell
from stereo_bench.spec import Cell
from stereo_bench.tests.tiny import SEED, make_tiny_root

NEW = ("stage_host_ms", "upload_device_ms", "queue_wait_ms", "step_device_ms", "stream_idle_pct")
MS = 1_000_000


def _record():
    """Three step calls of one camera, handed in at 0, 30.6 and 33 ms on the
    host; each call's device marks (ns): upload 1 ms, pick 0.5, step 9
    (block 4) or 6 (block 1), fetch 0.2. Call 0 ends on the device at 30.7
    ms; call 1's first mark runs at 31.2 (the stream idles 0.5 ms while the
    host stages call 1) and its last at 41.9, where call 2's first runs (no
    gap); call 2 ends at 49.6."""
    spans_, ranges = [], []
    host = [0, 30_600_000, 33 * MS]
    dev0 = [20 * MS, 31_200_000, 41_900_000]  # each call's first mark on the device
    steps = [9 * MS, 9 * MS, 6 * MS]
    for i, t in enumerate(host):
        spans_.append(["fused.step", i, -1, t, t + 3 * MS])
        root = len(spans_) - 1
        spans_.append(["fused.load_frame", i, root, t + 100_000, t + 1_600_000])  # 1.5 ms
        spans_.append(["fused.pick", i, root, t + 1_600_000, t + 2 * MS])
        spans_.append(["fused.launch", i, root, t + 2 * MS, t + 3 * MS])
        spans_.append(["fused.fetch_disp", i, -1, t + 3 * MS, t + 3_100_000])
        d0 = dev0[i]
        marks = [d0, d0 + MS, d0 + 1_500_000, d0 + 1_500_000 + steps[i], d0 + 1_700_000 + steps[i]]
        spans_.append(["fused.materialize", i, -1, t + 4 * MS, marks[4] + 50_000])
        enq = [t + 200_000, t + 1_500_000, t + 1_900_000, t + 2_900_000, t + 3_050_000]
        ranges.append({"frame": i, "enqueued": enq, "device": marks, "tags": [[4], [4], [1]][i]})
    return {"spans": spans_, "counters": {"steps": 3, "replays": 3, "eager_steps": 0, "captures": 0,
                                          "staged_bytes": 3 * 9_338_880, "fetched_bytes": 3 * 1_556_480},
            "marks": ["upload", "uploaded", "picked", "launched", "fetched"], "ranges": ranges,
            "clock": {"uncertainty_ns": 4000, "drift_ppm": 1.5}, "device": "test", "start_ns": 0,
            "stop_ns": 60 * MS}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


def test_each_reader_reads_its_number_from_a_record(tiny):
    rec = _record()
    ctx = SimpleNamespace(spans_record=rec)
    cell = Cell("madnet-mad-stream", tiny)
    got = {name: cell.reader(name)(ctx) for name in NEW}
    want = {
        "stage_host_ms": 1.5,
        "upload_device_ms": 1.0,
        "queue_wait_ms": float(np.percentile([19.8, 0.4, 8.7], 95)),
        "step_device_ms": 8.0,
        "stream_idle_pct": 100 * 0.5 / (49.6 - 20.0),
    }
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-9), k


def test_the_device_readers_read_nothing_without_ranges(tiny):
    rec = _record()
    rec["ranges"], rec["clock"] = [], None
    ctx = SimpleNamespace(spans_record=rec)
    cell = Cell("madnet-mad-stream", tiny)
    assert {name: cell.reader(name)(ctx) for name in NEW} == {
        "stage_host_ms": pytest.approx(1.5), **{k: None for k in NEW[1:]}}
    rec["counters"]["staged_bytes"] = 0  # no frame staged: the host number too reads nothing
    assert cell.reader("stage_host_ms")(ctx) is None
    assert spans.summary({**rec, "stretch": _stretch()})[-1] == "no device ranges (no card)"


def test_a_failed_stretch_raises(monkeypatch, tiny):
    """A stretch whose process fails fails the reader, with its errors in
    the log, rather than reading as a program without the tracer."""
    cell = Cell("madnet-mad-stream", tiny)
    ctx = SimpleNamespace(cell=cell, build=SimpleNamespace(device="cpu"))
    monkeypatch.setattr(spans, "HERE", tiny)  # no spans.py there: the process exits non-zero
    with pytest.raises(RuntimeError, match="the spans stretch failed"):
        cell.reader("stage_host_ms")(ctx)


def test_the_cost_mode_logs_the_three_stretches_and_the_tracers_own_work(tiny):
    lines = spans.cost("madnet-mad-stream", SEED, 4, "cpu", tiny)
    assert lines[0].startswith("cost: frames/s untraced, traced, untraced ")
    assert "the tracer's own work alone" in lines[0]


def _stretch():
    """The stretch of ``_record``: 3 frames of blocks 4, 4, 1 in 0.0291 s, the calls' device periods."""
    return {"first_frame": 0, "frames": 3, "seconds": 0.0291, "latency_ns": [31 * MS, 31 * MS, 31 * MS],
            "issue_s": 0.009, "blocks": [0, 1, 0, 0, 2], "cameras": 1}


def test_the_log_splits_latency_and_idle_and_steps_by_block():
    rec = _record()
    split = spans.latency_split(rec)
    parts = ("host", "queue", "upload", "pick", "step", "fetch", "notice")
    np.testing.assert_allclose(sum(split[k] for k in parts), split["total"])
    np.testing.assert_allclose(split["step"], [9 * MS, 9 * MS, 6 * MS])
    np.testing.assert_allclose(split["queue"], [19.8 * MS, 0.4 * MS, 8.7 * MS])
    np.testing.assert_allclose(split["host"], [0.2 * MS] * 3)
    np.testing.assert_allclose(split["notice"], [0.05 * MS] * 3)
    # the one gap, 30.7 to 31.2 ms on the device, lies in call 1's host spans: load_frame (30.7-32.2)
    # overlaps it all, as does its parent fused.step, frame 0's materialize 0.05 ms; the innermost
    # of the most overlap is named
    assert spans.idle_gaps(rec) == [(30.7 * MS, 31.2 * MS)]
    assert spans.idle_by_span(rec) == {"fused.load_frame": pytest.approx(0.5)}
    assert spans.step_by_block(rec) == {1: (1, pytest.approx(6.0)), 4: (2, pytest.approx(9.0))}
    # the window: 3 frames of block 1 in 23.1 ms, the period they predict
    window = {"frames": 3, "seconds": 0.0231, "issue": [0.002] * 3}
    lines = spans.summary({**rec, "stretch": _stretch()}, window, [0, 3, 0, 0, 0])
    text = "\n".join(lines)
    assert "frames/s 103.093 against the window's 129.870 (the tracer's cost 20.619%); host in step+fetch us a " \
           "call 3000.000 against the window's 2000.000" in text
    assert "check: stage_host_ms 1.5000 <= the stretch's host in step+fetch 3.0000: True" in text
    assert "idle ms by span (1 gaps): fused.load_frame 0.5000" in text
    assert "ranges' share less the idle inside them (0.000%) 98.311% against 100 - stream_idle_pct 98.311%" in text
    assert "step ms by block (frames): 1: 6.0000 (1), 4: 9.0000 (2)" in text
    # the other device ms a call 1.7: a frame of block 1 predicts 7.7 ms, of block 4 10.7; both stretches
    # run at the period their blocks predict, so the tracer costs nothing for those blocks
    assert "the tracer's cost for those blocks 0.000% (period against the blocks' prediction: traced 1.0000, " \
           "the window 1.0000)" in text


def test_a_mark_the_device_reached_at_its_enqueue_counts_the_wait_before_it_as_idle():
    """Call 1's ``picked`` mark reaches the device 5 us after the host
    enqueued it, within the reference window's 8 us: the device had
    finished the upload at 32.2 ms and waited for the host until 32.695;
    the ``launched`` mark, 9 ms after its enqueue, counts nothing."""
    rec = _record()
    r = rec["ranges"][1]
    r["enqueued"][2] = r["device"][2] - 5_000
    assert spans.idle_gaps(rec) == [(30_700_000, 31_200_000), (32_200_000, 32_695_000)]
    assert spans.stream_idle_pct(rec) == pytest.approx(100 * (0.5 + 0.495) / (49.6 - 20.0))
    # the wait lies in call 1's pick (32.2-32.6) and launch (32.6-33.6); their parent overlaps it all
    assert spans.idle_by_span(rec) == {"fused.load_frame": pytest.approx(0.5), "fused.step": pytest.approx(0.495)}
    text = "\n".join(spans.summary({**rec, "stretch": _stretch()}))
    assert "ranges' share less the idle inside them (1.672%) 96.639% against 100 - stream_idle_pct 96.639%" in text
    r["enqueued"][2] = r["device"][2] - 9_000  # past the window: the device was behind the host
    assert spans.idle_gaps(rec) == [(30.7 * MS, 31.2 * MS)]


def test_a_program_without_the_tracer_reads_nothing(monkeypatch, tiny):
    from real_time_self_adaptive_deep_stereo_torch.utils import profiling

    monkeypatch.delattr(profiling, "tracer")
    cell = Cell("madnet-mad-stream", tiny)
    ctx = SimpleNamespace(cell=cell)
    assert all(cell.reader(name)(ctx) is None for name in NEW)
    assert ctx.spans_record is None


def test_a_tiny_traced_run_reads_nothing_off_the_card(tiny, capfd):
    """Off the card no frame is staged and no range recorded: the five
    read nothing, while the stretch ran and logged its counters."""
    r = run_cell("madnet-none-stream", SEED, 0.3, True, "cpu", root=tiny)
    assert r["correct"] and set(r["metrics"]) == {"host_issue_ms"}
    err = capfd.readouterr().err
    assert "spans stretch: counters {'steps': 16, 'replays': 0, 'eager_steps': 16" in err
    assert "stage_host_ms None" in err and "no device ranges (no card)" in err
    json.dumps(r)
