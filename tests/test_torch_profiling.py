"""The port's ``utils/profiling.py``: ``summarize_trace`` and ``trace`` on
the CPU, against the JAX package's ``summarize_trace``.

* ``summarize_trace`` on a Chrome trace written here as ``torch.profiler``
  writes one: device events on two tracks (kernels, copies and sets; the
  ``record_function`` ranges as the device ran them), host events and
  metadata to be ignored, numbered names to be folded. The same events,
  written in the JAX profiler's format (a ``/device:`` process with an
  "XLA Ops" and an "XLA Modules" thread, and a host process), go through
  the JAX function: the two tables are equal where the two formats allow,
  that is for every name but a CUDA kernel's. The CUDA kernels' families
  (a template instance its own family, the argument list dropped) are
  checked against counts worked out by hand.
* ``trace`` on a CPU-only profile: one trace file, whose host track holds
  the ops run inside the block, and whose device tracks are empty.
* ``Tracer`` on its own: spans nest, with their parents and frame ids;
  counters count; an idle tracer holds nothing and refuses ``stop``; it
  starts and stops again and again, each record its own. The fused
  session's spans under it, and under ``trace``: ``test_torch_tracing.py``.
"""

import gzip
import json
import os

import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch.utils import profiling as tprof
from real_time_self_adaptive_deep_stereo_tpu.utils import profiling as jprof

# (name, cat, duration in us): the device's events, as both packages see them
DEVICE = [
    ("fusion.12", "kernel", 30.0),
    ("fusion.3", "kernel", 10.5),
    ("fusion", "kernel", 4.0),
    ("convolution.4", "kernel", 50.0),
    ("convolution.4.1", "kernel", 25.0),
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 7.25),
    ("Memset (Device)", "gpu_memset", 1.0),
]
STEPS = [("frame 0", 120.0), ("frame 1", 118.0), ("serve", 40.0)]
HOST = [("aten::conv2d", "cpu_op", 900.0), ("frame 0", "user_annotation", 2000.0),
        ("cudaLaunchKernel", "cuda_runtime", 3.0), ("fusion.12", "cpu_op", 1.0)]
# CUDA kernels: the port's, PyTorch's and cuDNN's names
KERNELS = [
    ("void corr_fwd_kernel<2>(float const*, float const*, float*, int, int, int, int)", 4.0),
    ("void corr_fwd_kernel<2>(float const*, float const*, float*, int, int, int, int)", 5.0),
    ("void corr_fwd_kernel<40>(float const*, float const*, float*, int, int, int, int)", 30.0),
    ("void feat_bwd_offset_kernel(float const*, float const*, float*, int)", 6.0),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
     "at::detail::Array<char*, 3> >(int, at::native::CUDAFunctor_add<float>, at::detail::Array<char*, 3>)", 2.0),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
     "at::detail::Array<char*, 3> >(int, at::native::CUDAFunctor_add<float>, at::detail::Array<char*, 3>)", 3.0),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc_tilesize128x128x32_execute_kernel__5x_cudnn", 40.0),
    ("void at::native::elementwise_kernel_with_index<int, at::native::arange_functor>(int, int)", 1.5),
]


def _torch_trace(path, device, steps, host):
    """A trace as ``torch.profiler``'s ``export_chrome_trace`` writes it."""
    events = [{"ph": "M", "name": "process_name", "pid": 7, "tid": 0, "args": {"name": "python3"}},
              {"ph": "M", "name": "thread_name", "pid": 7, "tid": 7, "args": {"name": "thread 7 (python3)"}}]
    ts = 1000.0
    for name, cat, dur in device:
        events.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur,
                       "args": {"device": 0, "stream": 7}})
        events.append({"ph": "f", "id": 1, "pid": 0, "tid": 7, "ts": ts, "cat": "ac2g", "name": "ac2g"})
        ts += dur
    for name, dur in steps:
        events.append({"ph": "X", "cat": "gpu_user_annotation", "name": name, "pid": 0, "tid": 7, "ts": ts,
                       "dur": dur})
    for name, cat, dur in host:
        events.append({"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": 7, "ts": ts, "dur": dur})
    events.append({"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)", "pid": "Spans",
                   "tid": "PyTorch Profiler", "ts": 0.0, "dur": 5000.0})
    with open(path, "w") as fh:
        json.dump({"schemaVersion": 1, "traceEvents": events}, fh)


def _jax_trace(logdir, device, steps, host):
    """The same events as the JAX profiler writes them: a device process
    with its "XLA Ops" and "XLA Modules" threads, and a host process."""
    events = [
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 2, "args": {"name": "XLA Ops"}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 3, "args": {"name": "XLA Modules"}},
        {"ph": "M", "name": "process_name", "pid": 9, "args": {"name": "/host:CPU"}},
        {"ph": "M", "name": "thread_name", "pid": 9, "tid": 1, "args": {"name": "python3"}},
    ]
    events += [{"ph": "X", "name": n, "pid": 1, "tid": 2, "ts": 0, "dur": d} for n, _, d in device]
    events += [{"ph": "X", "name": n, "pid": 1, "tid": 3, "ts": 0, "dur": d} for n, d in steps]
    events += [{"ph": "X", "name": n, "pid": 9, "tid": 1, "ts": 0, "dur": d} for n, _, d in host]
    run = os.path.join(logdir, "plugins", "profile", "run0")
    os.makedirs(run)
    with gzip.open(os.path.join(run, "host.trace.json.gz"), "wt") as fh:
        json.dump({"traceEvents": events}, fh)


@pytest.fixture
def traces(tmp_path):
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    os.makedirs(port / "run")
    _torch_trace(port / "run" / "a.pt.trace.json", DEVICE, STEPS, HOST)
    _jax_trace(str(jax_dir), DEVICE, STEPS, HOST)
    return str(port), str(jax_dir)


def test_summarize_trace_matches_the_jax_function_on_both_device_tracks(traces):
    port, jax_dir = traces
    for track, jax_track in (("kernels", "XLA Ops"), ("steps", "XLA Modules")):
        got = tprof.summarize_trace(port, track=track)
        want = jprof.summarize_trace(jax_dir, track=jax_track)
        assert got == want, track
    # worked out by hand: the numbered names folded, the host events left out
    assert tprof.summarize_trace(port) == [
        ("convolution", 2, 0.075),
        ("fusion", 3, 0.0445),
        ("Memcpy HtoD (Pageable -> Device)", 1, 0.00725),
        ("Memset (Device)", 1, 0.001),
    ]
    assert tprof.summarize_trace(port, track="steps") == [("frame ", 2, 0.238), ("serve", 1, 0.04)]
    assert tprof.summarize_trace(port, top=1) == [("convolution", 2, 0.075)]
    assert tprof.summarize_trace(port, top=None, track="host") == [("aten::conv2d", 1, 0.9), ("fusion", 1, 0.001)]


def test_summarize_trace_folds_cuda_kernels_by_family(tmp_path):
    path = tmp_path / "k.pt.trace.json.gz"
    plain = tmp_path / "plain.json"
    _torch_trace(plain, [(n, "kernel", d) for n, d in KERNELS], [], HOST)
    with open(plain) as src, gzip.open(path, "wt") as dst:
        dst.write(src.read())
    got = {name: (n, round(ms * 1000, 6)) for name, n, ms in tprof.summarize_trace(str(tmp_path), top=None)}
    add = ("at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
           "at::detail::Array<char*, 3> >")
    assert got == {
        "corr_fwd_kernel<2>": (2, 9.0),
        "corr_fwd_kernel<40>": (1, 30.0),
        "feat_bwd_offset_kernel": (1, 6.0),
        add: (2, 5.0),
        # no "_kernel" word: the whole name, as the JAX rule leaves it
        KERNELS[6][0]: (1, 40.0),
        "void at::native::elementwise_kernel_with_index<int, at::native::arange_functor>(int, int)": (1, 1.5),
    }
    # one file named alone reads as the directory of that file
    assert tprof.summarize_trace(str(path), top=None) == tprof.summarize_trace(str(tmp_path), top=None)


def test_summarize_trace_refuses_an_unknown_track(traces):
    with pytest.raises(ValueError, match="unknown track 'XLA Ops'"):
        tprof.summarize_trace(traces[0], track="XLA Ops")


def test_trace_writes_a_cpu_profile_that_summarize_trace_reads(tmp_path):
    x = torch.randn(1, 3, 16, 16)
    w = torch.randn(4, 3, 3, 3)
    logdir = str(tmp_path / "tr")
    with tprof.trace(logdir) as prof:
        with torch.profiler.record_function("frame 0"):
            torch.nn.functional.conv2d(x, w).relu()
    assert prof is not None
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].startswith("trace_") and files[0].endswith(".pt.trace.json")
    host = {name: n for name, n, _ in tprof.summarize_trace(logdir, top=None, track="host")}
    assert host["aten::conv2d"] == 1 and host["aten::relu"] == 1
    assert all(ms >= 0 for *_, ms in tprof.summarize_trace(logdir, top=None, track="host"))
    # no card: nothing on the device's tracks
    assert tprof.summarize_trace(logdir) == []
    assert tprof.summarize_trace(logdir, track="steps") == []


def test_trace_writes_its_file_when_the_block_raises(tmp_path):
    logdir = str(tmp_path / "tr")
    with pytest.raises(KeyError):
        with tprof.trace(logdir):
            torch.ones(3).sum()
            raise KeyError("inside")
    assert len(os.listdir(logdir)) == 1


def test_tracer_spans_nest_with_their_parents_and_frame_ids():
    tr = tprof.Tracer()
    tr.start("cpu")
    for frame in (7, 8):
        with tr.span("fused.step", frame):
            with tr.span("fused.load_frame", frame):
                with tr.span("fused.stage_wait", frame):
                    pass
            with tr.span("fused.launch", frame):
                pass
    with tr.span("fused.materialize", 8):
        pass
    rec = tr.stop()
    rows = [(name, frame, parent) for name, frame, parent, _, _ in rec["spans"]]
    assert rows == [
        ("fused.step", 7, -1), ("fused.load_frame", 7, 0), ("fused.stage_wait", 7, 1), ("fused.launch", 7, 0),
        ("fused.step", 8, -1), ("fused.load_frame", 8, 4), ("fused.stage_wait", 8, 5), ("fused.launch", 8, 4),
        ("fused.materialize", 8, -1),
    ]
    for name, frame, parent, t0, t1 in rec["spans"]:
        assert rec["start_ns"] <= t0 <= t1 <= rec["stop_ns"]
        if parent >= 0:
            assert rec["spans"][parent][3] <= t0 and t1 <= rec["spans"][parent][4]
    assert rec["marks"] == list(tprof.MARKS) and rec["ranges"] == [] and rec["clock"] is None


def test_tracer_counters_count():
    tr = tprof.Tracer()
    tr.start("cpu")
    for _ in range(3):
        tr.count("steps")
        tr.count("staged_bytes", 1024)
    tr.count("replays", 2)
    rec = tr.stop()
    assert rec["counters"] == {"steps": 3, "replays": 2, "eager_steps": 0, "captures": 0,
                               "staged_bytes": 3072, "fetched_bytes": 0}
    tr.start("cpu")
    with pytest.raises(KeyError):
        tr.count("no such counter")
    tr.stop()


def test_an_idle_tracer_holds_nothing():
    tr = tprof.Tracer()
    assert not tr.on and tprof.tracer.on is False
    with pytest.raises(RuntimeError, match="not on"):
        tr.stop()
    assert tr._spans == [] and tr._ranges == {} and tr._events == [] and tr._tags is None
    # no device on the CPU: no range, nothing allocated for one
    tr.start("cpu")
    assert tr.open_range(0, torch.device("cpu")) is None
    tr.mark(None, 0)
    tr.stop()
    assert tr._events == [] and tr._tags is None


def test_tracer_starts_and_stops_again_each_record_its_own():
    tr = tprof.Tracer()
    records = []
    for k in range(3):
        tr.start("cpu")
        with pytest.raises(RuntimeError, match="already on"):
            tr.start("cpu")
        with tr.span("fused.step", k):
            tr.count("steps")
        records.append(tr.stop())
        assert not tr.on
    assert [[(s[0], s[1], s[2]) for s in r["spans"]] for r in records] == [[("fused.step", k, -1)] for k in range(3)]
    assert [r["counters"]["steps"] for r in records] == [1, 1, 1]
    assert records[0]["stop_ns"] <= records[1]["start_ns"]
