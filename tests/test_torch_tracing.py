"""The fused session under the port's tracer (``utils/profiling.py``'s
``tracer``), on the CPU.

Each step call records the span tree ``fused.step`` ⊃ ``fused.load_frame``,
``fused.pick``, ``fused.launch``, and ``fetch_disp`` its ``fused.fetch_disp``
and ``fused.materialize``, all under the session's frame id; the counters
count the calls and the eager steps; the trajectory (every disparity and
every state tensor) is bit for bit the untraced one (one intra-op thread:
the CPU's threaded conv backward otherwise sums in an order that varies
from run to run); the device ranges are absent on the CPU; an idle
tracer records and allocates nothing. On the card
``tests/test_torch_cuda.py`` holds the device ranges, the tags and the
graph counters.
"""

import json
import os
import tracemalloc

import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch.adapt import AdaptationEngine, FusedOnlineSession
from real_time_self_adaptive_deep_stereo_torch.adapt import blocks as tblocks
from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
from real_time_self_adaptive_deep_stereo_torch.utils import profiling
from real_time_self_adaptive_deep_stereo_torch.utils.profiling import tracer

BLOCK_CONFIG = "block_config/MadNet_full.json"
H, W = 32, 64
STEP_CHILDREN = ["fused.load_frame", "fused.pick", "fused.launch"]


def _session(mode="MAD", **kw):
    model = get_stereo_net("MADNet", bulkhead=True, seed=0, device="cpu")
    blocks = tblocks.make_blocks(tblocks.load_block_config(BLOCK_CONFIG), model)
    eng = AdaptationEngine(model, blocks, lr=1e-2, device="cpu")
    return FusedOnlineSession(eng, mode=mode, ssim_th=1e9, max_steps=8, seed=3, **kw)


def _frames(n, seed, streams=0):
    r = np.random.default_rng(seed)
    lead = (streams,) if streams else ()
    return [
        {
            "left": (r.random(lead + (1, H, W, 3)) * 255).astype(np.float32),
            "right": (r.random(lead + (1, H, W, 3)) * 255).astype(np.float32),
            "target": np.full(lead + (1, H, W, 1), 4.0, np.float32),
        }
        for _ in range(n)
    ]


def _run(sess, frames):
    """The harness's loop: step, fetch, the previous frame materialised."""
    out, pending = [], None
    for f in frames:
        sess.step(f)
        fetch = sess.fetch_disp()
        if pending is not None:
            out.append(pending())
        pending = fetch
    out.append(pending())
    return out


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def traced():
    """The process's tracer, on for the test and off after it."""
    tracer.start("cpu")
    yield tracer
    if tracer.on:
        tracer.stop()


@pytest.mark.parametrize(
    "mode,kw",
    [("MAD", {}), ("NONE", {}), ("FULL", {}), ("MAD", dict(num_streams=2, stream_impl="map"))],
    ids=["mad", "none", "full", "mad-two-streams"],
)
def test_each_step_call_records_its_span_tree_under_its_frame_id(traced, mode, kw):
    streams = kw.get("num_streams", 0)
    sess = _session(mode, **kw)
    sess.step(_frames(1, 1, streams)[0])  # a step before the record: frame 0 is not in it
    sess.fetch_disp()()
    traced.stop()
    traced.start("cpu")
    frames = _frames(3, 2, streams)
    _run(sess, frames)
    rec = traced.stop()
    spans = rec["spans"]
    by_frame = {}
    for i, (name, frame, parent, t0, t1) in enumerate(spans):
        assert t0 <= t1
        if parent >= 0:
            p = spans[parent]
            assert p[3] <= t0 and t1 <= p[4] and p[1] == frame  # inside its parent, of its frame
        by_frame.setdefault(frame, []).append((i, name, parent))
    assert sorted(by_frame) == [1, 2, 3]
    for frame, rows in by_frame.items():
        roots = [(i, name) for i, name, parent in rows if parent < 0]
        assert [name for _, name in roots] == ["fused.step", "fused.fetch_disp", "fused.materialize"]
        step = roots[0][0]
        assert [name for i, name, parent in rows if parent == step] == STEP_CHILDREN
        # the CPU's frame needs no staging; the graphs none of a capture
        assert not {name for _, name, _ in rows} & {"fused.stage_wait", "fused.capture"}
    assert rec["ranges"] == [] and rec["clock"] is None and rec["device"] is None


@pytest.mark.parametrize("streams", [0, 2])
def test_counters_count_the_calls_and_their_eager_steps(traced, streams):
    sess = _session(num_streams=streams) if streams else _session()
    _run(sess, _frames(4, 5, streams))
    rec = traced.stop()
    assert rec["counters"] == {
        "steps": 4,
        "replays": 0,
        "eager_steps": 4 * max(streams, 1),  # a stream's step a dispatch on the eager path
        "captures": 0,
        "staged_bytes": 0,  # no pinned staging off the card
        "fetched_bytes": 0,
    }


def _state(sess):
    return {k: getattr(sess, k).clone() for k in ("scores", "loss_t1", "loss_t2", "last_mask", "step_count",
                                                    "reset_count", "fetch_counter", "cur_blocks", "metrics")}


@pytest.mark.parametrize("mode", ["MAD", "FULL"])
def test_the_trajectory_is_bit_for_bit_the_untraced_one(one_thread, mode):
    frames = _frames(4, 9)
    plain = _session(mode)
    want = _run(plain, frames)
    sess = _session(mode)
    tracer.start("cpu")
    try:
        got = _run(sess, frames)
    finally:
        rec = tracer.stop()
    assert rec["counters"]["steps"] == len(frames)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for k, v in _state(plain).items():
        assert torch.equal(_state(sess)[k], v), k
    assert torch.equal(sess.arena.flat, plain.arena.flat)
    assert torch.equal(sess.opt["acc"][0], plain.opt["acc"][0])
    assert not torch.equal(plain.arena.flat, plain.arena.flat0)


def test_an_idle_tracer_records_and_allocates_nothing():
    sess = _session()
    frames = _frames(3, 4)
    _run(sess, frames[:1])  # the session's own first-use allocations
    assert not tracer.on
    spans_before = tracer._spans
    tracemalloc.start()
    try:
        _run(sess, frames[1:])
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = snap.filter_traces([tracemalloc.Filter(True, profiling.__file__)])
    assert mine.statistics("filename") == []
    assert tracer._spans is spans_before and tracer._spans == [] and tracer._ranges == {}


def test_a_chrome_trace_holds_the_session_spans(tmp_path, traced):
    """Under ``utils.profiling.trace()`` each span also opens a
    ``record_function`` range: the exported trace shows them."""
    sess = _session()
    logdir = str(tmp_path / "tr")
    with profiling.trace(logdir):
        _run(sess, _frames(2, 6))
    rec = traced.stop()
    (path,) = os.listdir(logdir)
    with open(os.path.join(logdir, path)) as fh:
        events = json.load(fh)["traceEvents"]
    names = [e["name"] for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    for name in ("fused.step", "fused.load_frame", "fused.pick", "fused.launch", "fused.fetch_disp",
                 "fused.materialize"):
        assert names.count(name) == 2, name
    assert [s[0] for s in rec["spans"]].count("fused.launch") == 2
