"""Fused on-device adaptation session: one graph replay per frame, no
host read of the loss.

Port of ``real_time_self_adaptive_deep_stereo_tpu/adapt/fused.py``. The
host session (:mod:`.runner`) fetches the loss every frame for the reward
update and the reset test, and launches a frame's few thousand PyTorch ops
one by one. This session moves the whole controller onto the device and
takes the host out of the frame:

* the controller state (``scores``, ``loss_t1``, ``loss_t2``,
  ``last_mask``, ``step``, ``reset_count``, ``fetch_counter``,
  ``cur_blocks``, the ``[max_steps, 4]`` metrics ring) are device
  tensors, updated in place;
* the reward bookkeeping, the loss-threshold reset (one ``where`` over
  the flat parameter arena, :mod:`.arena`) and the metrics write are
  device ops at the end of every step;
* ``step`` never reads the loss. ``finalize`` makes the one transfer.

Where the JAX session compiles one program with a ``lax.switch`` over
the block branches, this one captures **one CUDA graph per branch**: the
forward-only step, the FULL step, one MAD step per trained block set,
and the shared-forward step. The host picks the graph where it knows the
branch without reading the device: ``step % dilation`` and ``step %
sample_frequency`` it counts itself, and with the FIXED and SEQUENTIAL
samplers it knows the block too. With ARGMAX, RANDOM and PROBABILITY the
block depends on the scores, hence on the previous frame's loss: the
sample is drawn on the device, and the device picks the branch too. The
MAD graphs of every sorted set of ``num_blocks`` of the blocks
(``C(n, num_blocks)`` branches: 5 for MADNet at one block a frame) are
the bodies of a conditional SWITCH node in a parent graph
(:class:`..ops.graph_switch.GraphSwitch`, ``csrc/graph_switch.cu``),
behind a kernel that reads ``cur_blocks`` and sets the node's value, as
``lax.switch`` reads ``blocks_now``. A train frame is one launch of the
parent, and no steady frame reads the device, whatever the sampler;
``shared_forward=True`` needs no switch (its graph selects the block
loss by a device index). Without graphs (the CPU, ``use_graphs=False``,
a ``gloo`` width-sharded session) Python runs the block's code, so the
host reads the ids each resample and picks the branch through the
switch's plain lookup (:func:`..ops.graph_switch.switch_index_torch`).

Graphs are captured lazily. The first frame that takes a branch runs it
eagerly on a side stream (that is the frame's real step; it carries
cuDNN's first-call set-up of that branch's backward, and it builds and
loads whatever kernel library the branch launches); the branch is then
captured, without running, and every later frame of that branch is one
``replay``. So the first frame of each branch costs an eager step plus a
capture, and a SEQUENTIAL session is steady after its first round. A
switch needs every body before its first launch, and ARGMAX may never
visit some blocks: at its first train frame the session snapshots the
state a step writes, then for each branch runs it eagerly on the side
stream, restores the snapshot and captures it; the frame itself is the
parent's first launch. All graphs of a session share one memory pool,
since one runs at a time: the disparity a step returns (``last_disp``)
lives in that pool and holds its values until the next step only. (A
switched branch copies it, inside its graph, into one buffer, since the
host does not know which branch ran.) ``fetch_disp`` therefore enqueues
the copy to a pinned host buffer on the same stream right away.

The kernel wrappers count their launches in ``ops.cuda_lib.LAUNCHES``
when Python calls them, which under capture is once, with nothing
launched. The session takes a capture's counts back out, keeps them with
the graph, and adds them at every direct replay, so the counters go on
meaning launches. A switched launch counts its switch kernels
(``graph_switch``) at once; which branch ran only the device knows, so
the switch counts the branches it took on the device, and the session
adds each branch's launches times its count when it syncs anyway
(:meth:`~FusedOnlineSession.finalize`,
:meth:`~FusedOnlineSession.block_until_ready`) or when asked
(:meth:`~FusedOnlineSession.sync_launches`). That read also raises if a
switch found ids that name no branch, where it ran no step.

On a CPU device (the tests) the same step function runs eagerly; on the
card ``use_graphs=False`` does the same, for comparisons.

``num_streams=N`` runs N independent adaptation streams, one per camera
of a rig, as the JAX session's ``num_streams`` does: every state tensor
carries a leading ``[N]`` axis (the arena is ``[N, P]``), each stream has
its own ``torch.Generator``, and frames carry a leading ``[N]`` axis. One
``step`` advances a frame of every stream, the streams one after another,
each with its own branch (its sampled block's partial backward). With
``stream_impl="map"`` each (stream, branch) pair is one captured graph, and
a frame replays N of them in stream order. With ``"unroll"`` a frame whose
N streams all take one branch is one replay of a graph that holds the N
streams' steps in order (so SEQUENTIAL, FIXED, FULL and NONE replay one
graph a frame). Under PROBABILITY, RANDOM and ARGMAX, with either, one
parent holds N switches in stream order, each over its stream's (stream,
branch) graphs, so a frame is one launch even where the streams draw
different blocks. A graph per tuple of branches would be up to
``n_actions ** N`` captures; this way a branch has at most N + 1 graphs.
The graphs read their stream's row of the arena: the module is
bound to that row (:meth:`.arena.Arena.bind`) while its step runs eagerly
and while it is captured. Each stream's disparity is copied, inside its
graph, into one ``[N, ...]`` buffer, which is ``last_disp``.

With ``stream_impl="vmap"`` the N streams run batched, as the JAX
session's ``jax.vmap`` runs them: one function of a stream's arena row,
sampled block and frame (``torch.func.functional_call`` on views of the
row, ``grad_and_value`` with respect to the views, raveled into the
row's layout) is vmapped over the
stream axis. Convolutions with per-stream weights become grouped ones,
and each kernel Function folds the streams into its batch axis, so a
frame-batch launches each kernel once. MAD then runs the shared-forward
step (a vmapped choice between block branches would run every branch):
one graph a branch for all N streams, and no host read. The samplers stay
on the host side, each stream drawing into its row of ``cur_blocks``
from its own generator, and the optimizer updates and the controller
run over the ``[N]`` state elementwise.

With a ``mesh`` and no streams the frame is sharded along its width over
the mesh axis's ranks (:mod:`..parallel.spatial`): each rank runs the
step on its columns, exchanging halos, backpropagates its own term of
the loss, and sums the loss and the gradient over the ranks, so the
controller, replicated, sees the whole frame's loss on every rank and
every rank takes the same update. Under ``gloo`` the exchanges go through
host memory and the step runs eagerly. With a mesh and streams the
stream axis is sharded instead: rank r runs streams ``local_slice(N, R,
r)`` under ``vmap``, with no collective a frame.

While the process's tracer (:data:`..utils.profiling.tracer`) is on, a
step call records the spans ``fused.step`` (the frame id: the session's
step count) ⊃ ``fused.load_frame`` (⊃ ``fused.stage_wait``), ``fused.pick``
(the branch pick, with the sampler's device ops), ``fused.launch`` (the
replay or the switch's launch; at a branch's first use its eager step and
``fused.capture``); ``fetch_disp`` records ``fused.fetch_disp`` and its
materializer ``fused.materialize``, each under the id of its own frame.
On the card it also records the call's device range: timing events at the
tracer's marks (before and after the upload, after the pick's device ops,
after the launch, after the disparity's copy) and under MAD a device copy
of the ids the launch reads. Off, a site reads the tracer's ``on`` and
nothing more.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from real_time_self_adaptive_deep_stereo_torch.adapt.arena import build_arena
from real_time_self_adaptive_deep_stereo_torch.adapt.engine import (
    AdaptationEngine,
    metric_sums,
    metrics_from_sums,
)
from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib
from real_time_self_adaptive_deep_stereo_torch.ops.graph_switch import (
    GraphSwitch,
    branch_sets,
    branch_table,
    switch_index_torch,
)
from real_time_self_adaptive_deep_stereo_torch.parallel import spatial
from real_time_self_adaptive_deep_stereo_torch.parallel.sharding import local_slice
from real_time_self_adaptive_deep_stereo_torch.utils import optim
from real_time_self_adaptive_deep_stereo_torch.utils.profiling import tracer as _TRACER

__all__ = ["FusedOnlineSession"]

Branch = Tuple  # ("none",) | ("full",) | ("shared",) | ("mad", (k, ...)) | ("switch",)
_SWITCH: Branch = ("switch",)  # the sampled blocks' branch, picked on the device
_SAMPLED = ("ARGMAX", "RANDOM", "PROBABILITY")
_FRAME_KEYS = ("left", "right", "target", "proxy")
_STATE = ("scores", "loss_t1", "loss_t2", "last_mask", "step_count", "reset_count", "fetch_counter",
          "cur_blocks", "metrics")


class _Stream:
    """One stream's state: views of the session's tensors (row ``index``
    of each where the session has a stream axis), its generator, and the
    blocks its next train step takes where the host picks the branch (the
    eager path, FIXED, SEQUENTIAL; a switched session leaves them
    empty)."""

    def __init__(self, index: Optional[int], **tensors):
        self.index = index
        self.host_blocks: Tuple[int, ...] = ()
        for k, v in tensors.items():
            setattr(self, k, v)


_SIDE_STREAMS: Dict[Tuple[int, str], "torch.cuda.Stream"] = {}


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The stream on which every session of this thread on ``device``
    runs its graphs' first eager step and their captures. cuBLAS keeps a
    workspace (32 MiB on an H100) for each pair of handle and stream that
    it meets, for the life of the process: a stream of its own for each
    session would leave two of them behind a session (this thread's
    handle and the autograd thread's), each pinning the memory segment it
    lies in."""
    key = (threading.get_ident(), str(device))
    if key not in _SIDE_STREAMS:
        _SIDE_STREAMS[key] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[key]


def _numpy(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class FusedOnlineSession:
    """Device-resident NONE / FULL / MAD adaptation session.

    Usage::

        eng = AdaptationEngine(model, blocks, lr=1e-4)
        sess = FusedOnlineSession(eng, mode="MAD", sample_mode="SEQUENTIAL",
                                  max_steps=N)
        for frame in frames:          # dicts of NHWC arrays
            sess.step(frame)          # async; no host sync
        stats = sess.finalize()       # one transfer

    The session adapts the engine's module in place. ``params`` is an
    optional ``state_dict`` loaded into it first. With ``arena=True`` the
    module's parameters become views of one flat vector.

    ``num_streams=N`` (with ``arena=True``) runs N independent streams;
    ``seed`` is then an int (stream s takes ``seed + s``) or a list of N
    seeds, and ``stream_impl`` is ``"map"``, ``"unroll"`` or ``"vmap"``
    (``"auto"``: ``"vmap"`` under a mesh, else ``"map"``). Under
    ``"vmap"`` MAD needs ``num_blocks=1`` and momentum, and runs the
    shared-forward step.

    ``mesh`` (a ``DeviceMesh`` over an initialized process group, axis
    ``spatial_axis``): without streams every frame is sharded along its
    width over the axis's ranks (``shard_batch(frame,
    width_sharded(mesh))``'s pieces in, the disparity's piece of the same
    cut out) and the controller is replicated; with streams (``"vmap"``)
    the stream axis is sharded instead, rank r running the streams
    ``local_slice(N, R, r)`` (``shard_batch(frames, batch_sharded(mesh))``'s
    pieces), and ``finalize`` and ``current_params`` gather all N.
    """

    def __init__(
        self,
        engine: AdaptationEngine,
        params: Optional[Dict[str, torch.Tensor]] = None,
        mode: str = "MAD",
        sample_mode: str = "PROBABILITY",
        num_blocks: int = 1,
        fixed_id=0,
        sample_frequency: int = 1,
        ssim_th: float = 0.5,
        decay: float = 0.99,
        uf: float = 0.01,
        dilation: int = 1,
        max_steps: int = 100_000,
        seed: Union[int, Sequence[int]] = 0,
        mesh=None,
        spatial_axis: str = "data",
        shared_forward: bool = False,
        arena: bool = True,
        num_streams: int = 0,
        stream_impl: str = "auto",
        compute_metrics: bool = True,
        disp_dtype: Optional[torch.dtype] = None,
        use_graphs: Optional[bool] = None,
    ):
        """``compute_metrics=False`` is the serving contract: frames need
        no ``target``, the EPE/bad3/D1 computations and the metrics ring
        drop out, and NONE also skips the loss (it only fed the metrics).
        ``disp_dtype`` is the type of the returned disparity (for example
        ``torch.float16``, which halves a per-frame fetch); state and loss
        stay float32. ``use_graphs``: replay CUDA graphs (default on a
        CUDA device, never on the CPU) or run every step eagerly."""
        if mode not in ("NONE", "FULL", "MAD"):
            raise ValueError(f"unknown mode {mode!r}")
        if stream_impl not in ("auto", "map", "vmap", "unroll"):
            raise ValueError(f"unknown stream_impl {stream_impl!r}")
        if stream_impl == "auto":
            stream_impl = "vmap" if mesh is not None else "map"
        self.num_streams = int(num_streams)
        self.stream_impl = stream_impl
        if self.num_streams < 0:
            raise ValueError(f"num_streams must be >= 0, got {num_streams}")
        if self.num_streams:
            if not arena:
                raise ValueError("num_streams requires arena=True")
            if stream_impl in ("map", "unroll") and mesh is not None:
                raise ValueError(
                    f"stream_impl={stream_impl!r} composes streams inside "
                    "one device program — use 'vmap' for stream-parallel "
                    "execution over a mesh"
                )
            if stream_impl == "vmap" and mode == "MAD":
                if num_blocks != 1 or engine.optimizer != "momentum":
                    raise ValueError(
                        "num_streams MAD under vmap requires num_blocks=1 "
                        "+ momentum (the shared-forward step)"
                    )
                shared_forward = True
        self.mesh, self.spatial_axis = mesh, spatial_axis
        self._group = mesh.get_group(spatial_axis) if mesh is not None else None
        # the width-sharded step: its layout is made at the first frame
        self._sharded = mesh is not None and not self.num_streams
        self._layout: Optional[spatial.Layout] = None
        if self._sharded:
            spatial.check_model(engine.model)
        # the streams this process runs: all N, or with a mesh its piece
        self._stream_rows = (
            local_slice(self.num_streams, self._group.size(), self._group.rank())
            if self.num_streams and mesh is not None
            else slice(0, self.num_streams)
        )
        self._rows = self._stream_rows.stop - self._stream_rows.start
        if self.num_streams and not self._rows:
            raise ValueError(
                f"{self.num_streams} streams over {self._group.size()} ranks leave rank "
                f"{self._group.rank()} none"
            )
        if mode == "MAD" and not engine.blocks:
            raise ValueError("mode MAD needs an engine built with blocks")
        self.engine = engine
        self.device = engine.device
        self.mode = mode
        self.sample_mode = sample_mode
        self.num_blocks = int(num_blocks)
        self.n_actions = len(engine.blocks) if mode == "MAD" else 1
        if mode == "MAD" and sample_mode not in (
            "FIXED", "SEQUENTIAL", "ARGMAX", "RANDOM", "PROBABILITY"
        ):
            raise KeyError(f"Unknown sampler {sample_mode!r}")
        if sample_mode == "FIXED":
            # FIXED trains exactly the configured id list; the state's
            # shapes are static, so its length must equal num_blocks
            ids = [int(k) for k in np.atleast_1d(fixed_id)]
            if len(ids) != self.num_blocks:
                raise ValueError(
                    f"FIXED needs len(fixed_id) == num_blocks for the fused "
                    f"session (got {len(ids)} ids, num_blocks={num_blocks}); "
                    "pass num_blocks=len(fixed_id) or use the host session"
                )
        self.fixed_id = fixed_id
        self.sample_frequency = max(1, int(sample_frequency))
        self.ssim_th = float(ssim_th)
        self.decay = float(decay)
        self.uf = float(uf)
        self.dilation = max(1, int(dilation))
        self.max_steps = int(max_steps)
        self.compute_metrics = bool(compute_metrics)
        self.disp_dtype = disp_dtype
        if shared_forward and not (
            mode == "MAD" and self.num_blocks == 1 and engine.optimizer == "momentum"
        ):
            raise ValueError(
                "shared_forward requires mode='MAD', num_blocks=1 and the "
                "momentum optimizer (got mode=%r, num_blocks=%d, optimizer=%r)"
                % (mode, self.num_blocks, engine.optimizer)
            )
        self.shared_forward = bool(shared_forward)
        on_cuda = self.device.type == "cuda"
        self.use_graphs = (on_cuda and not self._sharded) if use_graphs is None else bool(use_graphs)
        if self.use_graphs and not on_cuda:
            raise ValueError("use_graphs=True needs a CUDA device")
        if self.use_graphs and self._sharded:
            if dist.get_backend(self._group) == "gloo":
                raise ValueError(
                    "a width-sharded session exchanges its halos every frame, and "
                    "gloo's collectives cannot be captured in a CUDA graph: use_graphs=False"
                )
            raise NotImplementedError(
                "CUDA graphs of a width-sharded session under NCCL are not ported: "
                "ROADMAP.md, queue 1"
            )
        # the sampled MAD branches picked on the device, by a graph switch
        self._switching = (
            self.use_graphs and mode == "MAD" and sample_mode in _SAMPLED and not self.shared_forward
        )

        if params is not None:
            engine.model.load_state_dict(params)
        self._names = list(engine._named_params)
        self._all_params = list(engine._named_params.values())
        self._index = {name: i for i, name in enumerate(self._names)}
        self.arena = build_arena(engine.model, engine.blocks, self._rows) if arena else None
        self.spec = self.arena.spec if arena else None
        self._host_step = 0
        self._init_state(seed)

        self.last_disp: Optional[torch.Tensor] = None
        self._pending_disp: Optional[Callable] = None
        # by branch: the captured graph with its output disparity, and the
        # kernel launches one replay of it stands for
        # (keyed by the branch; with streams by (stream, branch), and under
        # "unroll" also by the N-tuple of a branch all streams take)
        self._graphs: Dict[Tuple, Tuple] = {}
        self._vmapped: Dict[str, Callable] = {}  # by branch kind: the vmapped step
        self.graph_launches: Dict[Tuple, Dict[str, int]] = {}
        # the switch over the sampled branches (a slot a stream), and the
        # graph keys of its bodies, [slot][branch]; built at the first
        # sampled train frame
        self._switch: Optional[Tuple[GraphSwitch, List[List[Tuple]]]] = None
        # the streams' disparities ([N, ...]), or a switched session's one
        self._disp_out: Optional[torch.Tensor] = None
        if on_cuda:
            self._side_stream = _side_stream(self.device)
            self._pool = torch.cuda.graph_pool_handle() if self.use_graphs else None
        self._frame_bufs: Dict[str, torch.Tensor] = {}
        self._stage: List[Dict[str, torch.Tensor]] = [{}, {}]
        self._stage_events: List[Optional[torch.cuda.Event]] = [None, None]
        self._disp_host: List[Optional[torch.Tensor]] = [None, None]
        self._fetches = 0
        self._range: Optional[int] = None  # the tracer's device range of the last step call

    # ------------------------------------------------------------------ state
    def _init_state(self, seed) -> None:
        """The state tensors, with a leading ``[num_streams]`` axis where
        the session has streams, and one :class:`_Stream` of views per
        stream (one in all without streams)."""
        eng, dev, n = self.engine, self.device, self.n_actions
        ns = self._rows
        lead = (ns,) if ns else ()
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        total = max(self.num_streams, 1)
        seeds = list(seed) if isinstance(seed, (list, tuple)) else [int(seed) + s for s in range(total)]
        if len(seeds) != total:
            raise ValueError(f"need {total} seeds, got {len(seeds)}")
        seeds = seeds[self._stream_rows] if ns else seeds
        # the parameters, their pristine copies and the optimizer slots,
        # each as a list of tensors: one flat vector with the arena
        if self.arena is not None:
            self._params = [self.arena.flat]
            self._params0 = [self.arena.flat0]
            new_slot = lambda: [self.arena.new_slot()]  # noqa: E731
        else:
            self._params = [p.data for p in self._all_params]
            self._params0 = [p.detach().clone() for p in self._all_params]
            new_slot = lambda: [torch.zeros_like(p) for p in self._params]  # noqa: E731
        if self.mode == "NONE":
            self.opt: Dict = {}
        elif eng.optimizer == "momentum":
            self.opt = {"acc": new_slot()}
        else:  # adam: one step count for the whole optimizer, on the device
            self.opt = {"m": new_slot(), "v": new_slot(), "t": torch.zeros(lead, **i32)}
        self.scores = torch.zeros(lead + (n,), **f32)
        self.loss_t1 = torch.zeros(lead, **f32)
        self.loss_t2 = torch.zeros(lead, **f32)
        self.last_mask = torch.zeros(lead + (n,), **f32)
        self.step_count = torch.zeros(lead, **i32)
        self.reset_count = torch.zeros(lead, **i32)
        self.fetch_counter = torch.zeros(lead + (n,), **i32)
        self.cur_blocks = torch.zeros(lead + (self.num_blocks,), **i32)
        self.metrics = torch.zeros(lead + (self.max_steps, 4), **f32) if self.compute_metrics else None
        self._arange_n = torch.arange(n, **i32)

        def row(t, s):
            return t if not ns or t is None else t[s]

        self._streams = [
            _Stream(
                s if ns else None,
                params=[row(p, s) for p in self._params],
                opt={k: row(v, s) if k == "t" else [row(x, s) for x in v] for k, v in self.opt.items()},
                **{k: row(getattr(self, k), s) for k in _STATE},
                generator=torch.Generator(device=dev).manual_seed(int(seeds[s])),
            )
            for s in range(max(ns, 1))
        ]
        # the vmapped step's view: every stream's rows at once
        self._all = _Stream(
            None,
            params=self._params,
            opt=self.opt,
            **{k: getattr(self, k) for k in _STATE},
        )
        if self.mode == "MAD":
            m = self.num_blocks
            if self.sample_mode == "FIXED":
                ids = [int(k) for k in np.atleast_1d(self.fixed_id)]
                self.cur_blocks.copy_(torch.tensor(ids, dtype=torch.int32))
                for st in self._streams:
                    st.host_blocks = tuple(sorted(set(ids)))
            elif self.sample_mode == "SEQUENTIAL":
                # the n possible draws, on the device: a resample is one
                # device-to-device copy
                self._seq_blocks = [
                    torch.tensor([(base + j) % n for j in range(m)], **i32) for base in range(n)
                ]
            else:
                # the branches of a draw, and the table from the ids'
                # bitmask to a branch (the switch's, on either path)
                self._branch_sets = branch_sets(n, m)
                self._branch_table = branch_table(n, m, dev)
            # owning block of every parameter element (shared-forward update)
            if self.shared_forward:
                if self.arena is not None:
                    self._block_ids = [torch.from_numpy(self.spec.block_ids()).to(dev)]
                else:
                    owner = {name: b.index for b in eng.blocks for name in b.names}
                    self._block_ids = [owner.get(name, -1) for name in self._names]

    # ---------------------------------------------------------------- sampler
    def _sample(self, scores: torch.Tensor, generator: Optional[torch.Generator], step: int):
        """Block sampling on ``scores``' device; returns ``[num_blocks]``
        int32 ids. PROBABILITY samples in proportion to softmax(scores)
        (Gumbel top-k: without replacement for several blocks, exactly
        categorical for one); RANDOM is uniform; ARGMAX takes the top k;
        SEQUENTIAL goes round; FIXED is constant. ``step`` is the host's
        frame count."""
        n, m = self.n_actions, self.num_blocks
        mode = self.sample_mode
        dev = scores.device
        if mode == "FIXED":
            return torch.tensor(
                [int(k) for k in np.atleast_1d(self.fixed_id)], dtype=torch.int32, device=dev
            )
        if mode == "SEQUENTIAL":
            base = (step // self.sample_frequency) % n
            return torch.tensor([(base + j) % n for j in range(m)], dtype=torch.int32, device=dev)
        if mode == "ARGMAX":
            return torch.topk(scores, m).indices.to(torch.int32)
        u = torch.rand(n, generator=generator, device=dev, dtype=torch.float32)
        gumbel = -torch.log(-torch.log(u + 1e-20) + 1e-20)
        if mode == "RANDOM":
            return torch.topk(gumbel, m).indices.to(torch.int32)
        return torch.topk(scores + gumbel, m).indices.to(torch.int32)

    def _resample(self, step: int) -> None:
        """Draw this frame's blocks of every stream into ``cur_blocks`` and,
        where the host picks the branch by them, into each stream's
        ``host_blocks``."""
        n = self.n_actions
        if self.sample_mode == "FIXED":
            return  # set once, at construction
        if self.sample_mode == "SEQUENTIAL":
            base = (step // self.sample_frequency) % n
            self.cur_blocks.copy_(self._seq_blocks[base])  # every stream's row
            for st in self._streams:
                st.host_blocks = tuple(sorted({(base + j) % n for j in range(self.num_blocks)}))
            return
        for st in self._streams:
            st.cur_blocks.copy_(self._sample(st.scores, st.generator, step))
        if self.shared_forward or self._switching:
            return  # the graph selects by the device's ids
        # the eager path's host read: every stream's branch, by the switch's
        # plain lookup of its [num_blocks] ids, which depend on the scores
        # and so on the previous frame's loss
        index = switch_index_torch(self.cur_blocks, self._branch_table, n).reshape(-1).tolist()
        for st, k in zip(self._streams, index):
            if k < 0:
                raise RuntimeError(f"sampled blocks {st.cur_blocks.tolist()} name no branch")
            st.host_blocks = self._branch_sets[k]

    @property
    def _host_blocks(self) -> Tuple[int, ...]:
        """The blocks the next train step of the (first) stream takes, as
        the host picked them: meaningful on the eager path only. A session
        that replays graphs raises (the device's ``cur_blocks`` is the
        record there: a switched session never reads it)."""
        if self.use_graphs:
            raise RuntimeError("a session that replays graphs keeps its sampled blocks in cur_blocks only")
        return self._streams[0].host_blocks

    def _pick_branches(self, step: int) -> List[Branch]:
        """Each stream's branch for the frame the host counts as ``step``."""
        if self.mode == "NONE":
            return [("none",)] * len(self._streams)
        train = step % self.dilation == 0
        if self.mode == "FULL":
            return [("full",) if train else ("none",)] * len(self._streams)
        if step % self.sample_frequency == 0:
            self._resample(step)
        if not train:
            return [("none",)] * len(self._streams)
        if self.shared_forward:
            return [("shared",)] * len(self._streams)
        if self._switching:
            return [_SWITCH] * len(self._streams)
        return [("mad", st.host_blocks) for st in self._streams]

    # ------------------------------------------------------------ the device step
    def _views(self, st: _Stream, block: Optional[int]):
        """(parameters, optimizer slots) of stream ``st``'s block ``block``
        (None: of everything) as lists of tensors: with the arena one slice
        of each vector."""
        if self.arena is not None:
            cut = (
                (lambda v: v)
                if block is None
                else (lambda v: self.arena.block_slice(v, block))
            )
            slots = {k: [cut(v[0])] for k, v in st.opt.items() if k != "t"}
            return [cut(st.params[0])], slots
        if block is None:
            idx = range(len(self._names))
        else:
            idx = [self._index[name] for name in self.engine.blocks[block].names]
        slots = {k: [v[i] for i in idx] for k, v in st.opt.items() if k != "t"}
        return [st.params[i] for i in idx], slots

    def _grads(self, loss: torch.Tensor, block: Optional[int], retain: bool) -> List[torch.Tensor]:
        """The gradient of ``loss`` with respect to block ``block``'s
        parameters (None: all), in the layout of :meth:`_views`. With the
        arena, ``backward`` accumulates into the parameters' ``grad``
        views, whose slice of the flat gradient vector is zeroed first."""
        params = self._all_params if block is None else self.engine.blocks[block].params
        if self.arena is not None:
            g = self.arena.grad if block is None else self.arena.block_slice(self.arena.grad, block)
            g.zero_()
            loss.backward(inputs=params, retain_graph=retain)
            grads = [g]
        else:
            grads = torch.autograd.grad(loss, params, retain_graph=retain, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        # width-sharded: each rank took the gradient of its own term of the
        # loss; the whole loss's is their sum, which every rank applies
        for g in grads:
            self._reduce(g)
        return grads

    @torch.no_grad()
    def _apply(self, st: _Stream, block: Optional[int], grads: List[torch.Tensor], t) -> None:
        """The optimizer update of ``st``'s block ``block`` (None: of every
        parameter) as Adam's step ``t``. ``st`` is one stream, or under
        ``vmap`` every stream, each row of the arena with its own count."""
        eng = self.engine
        params, slots = self._views(st, block)
        if eng.optimizer == "momentum":
            optim.momentum_update(params, slots["acc"], grads, eng.lr, eng.momentum)
        else:
            optim.adam_update(params, slots["m"], slots["v"], grads, eng.lr, t[:, None] if t.dim() else t)

    def _update_all(self, st: _Stream, grads: List[torch.Tensor]) -> None:
        """The FULL update of every parameter; Adam's count advances once."""
        t = st.opt["t"] + 1 if "t" in st.opt else None
        self._apply(st, None, grads, t)
        if t is not None:
            st.opt["t"].copy_(t)

    @torch.no_grad()
    def _update_owned(self, st: _Stream, k: torch.Tensor, grads: List[torch.Tensor]) -> None:
        """The shared-forward momentum update, masked by block ownership:
        an element moves only where its block is the sampled ``k`` (one
        stream's id, or under ``vmap`` the ``[N]`` ids along the rows)."""
        eng = self.engine
        for p, acc, g, bid in zip(st.params, st.opt["acc"], grads, self._block_ids):
            own = k.reshape(k.shape + (1,) * (p.dim() - k.dim())) == bid
            acc.copy_(torch.where(own, eng.momentum * acc + g, acc))
            p.copy_(torch.where(own, p - eng.lr * acc, p))

    def _train_full(self, st: _Stream, frame):
        eng = self.engine
        eng._set_trainable()
        out = eng.model(frame["left"], frame["right"])
        loss = eng._full_loss_fn(out["disparities"], frame)
        self._update_all(st, self._grads(loss, None, retain=False))
        return loss.detach(), out["full_res_disp"].detach()

    def _train_blocks(self, st: _Stream, ks: Sequence[int], frame):
        """The sampled blocks in one step: one forward, each block's loss
        differentiated with respect to that block's parameters at the
        pre-step weights, the disjoint updates applied together; Adam's
        count advances once per block."""
        eng = self.engine
        eng._set_trainable([p for k in ks for p in eng.blocks[k].params])
        out = eng.model(frame["left"], frame["right"])
        grads = [
            self._grads(eng._block_loss(out["disparities"], k, frame), k, retain=i + 1 < len(ks))
            for i, k in enumerate(ks)
        ]
        with torch.no_grad():
            loss = eng._full_loss_fn(out["disparities"], frame)
            t = st.opt["t"] + 1 if "t" in st.opt else None
            for k, g in zip(ks, grads):
                self._apply(st, k, g, t)
            if t is not None:
                st.opt["t"].add_(len(ks))
        eng._set_trainable()
        return loss, out["full_res_disp"].detach()

    def _train_shared(self, st: _Stream, frame):
        """One forward, the block losses stacked and selected by the
        sampled id on the device, one backward through everything, and a
        momentum update masked by block ownership: the block-k restriction
        of the full gradient of loss k is what
        ``minimize(loss_k, var_list=block_k)`` computes."""
        eng = self.engine
        eng._set_trainable()
        inputs, prep = eng.block_loss_inputs(frame)
        out = eng.model(frame["left"], frame["right"])
        stacked = torch.stack([prep(out["disparities"][i]) for i in range(self.n_actions)], 0)
        k = st.cur_blocks[0]
        sel = stacked.index_select(0, k.view(1).long())[0]
        grads = self._grads(eng._block_base_loss([sel], inputs), None, retain=False)
        with torch.no_grad():
            loss = eng._full_loss_fn(out["disparities"], frame)
            self._update_owned(st, k, grads)
        return loss, out["full_res_disp"].detach()

    def _forward_only(self, frame):
        eng = self.engine
        with torch.no_grad():
            out = eng.model(frame["left"], frame["right"])
            if self.mode == "NONE" and not self.compute_metrics:
                # serving without metrics: the loss fed only the ring
                loss = torch.zeros((), dtype=torch.float32, device=self.device)
            else:
                loss = eng._full_loss_fn(out["disparities"], frame)
        return loss, out["full_res_disp"]

    def _device_step(self, st: _Stream, branch: Branch, frame: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One frame of stream ``st`` on the device: the branch's forward
        (and training), then the controller. Reads and writes tensors only,
        so that it can be captured once and replayed."""
        kind = branch[0]
        if kind == "none":
            new_loss, disp = self._forward_only(frame)
        elif kind == "full":
            new_loss, disp = self._train_full(st, frame)
        elif kind == "shared":
            new_loss, disp = self._train_shared(st, frame)
        else:
            new_loss, disp = self._train_blocks(st, branch[1], frame)
        with torch.no_grad():
            new_loss = self._reduce(new_loss)
            row = self._metrics_row(disp, frame, new_loss) if self.compute_metrics else None
            self._control(st, new_loss, row)
        return disp if self.disp_dtype is None else disp.to(self.disp_dtype)

    def _metrics_row(self, disp, frame, loss) -> torch.Tensor:
        """``[epe, bad3, d1, loss]`` of one stream's disparity (with a
        width-sharded frame, of the whole frame: the ranks' sums added)."""
        epe, bad3, _, d1 = metrics_from_sums(self._reduce(metric_sums(disp, frame["target"])))
        return torch.stack([epe, bad3, d1, loss], -1)

    def _control(self, st: _Stream, new_loss: torch.Tensor, row: Optional[torch.Tensor]) -> None:
        """The controller after a step: the reward bookkeeping, the reset,
        the metrics ring and the step count. ``st`` holds one stream's
        state (a scalar ``new_loss``) or, under ``vmap``, every stream's
        (``new_loss`` ``[N]``): each state tensor has the loss's leading
        axes."""
        step = st.step_count
        if self.mode == "MAD":
            # reward bookkeeping (Stereo_Online_Adaptation.py:211-224),
            # every frame: only the train ops are dilation-gated
            first = step == 0
            loss_t1 = torch.where(first, new_loss, st.loss_t1)
            loss_t2 = torch.where(first, new_loss, st.loss_t2)
            gain = (2.0 * loss_t1 - loss_t2) - new_loss
            st.scores.copy_(self.decay * st.scores + self.uf * gain[..., None] * st.last_mask)
            cur_mask = (st.cur_blocks[..., :, None] == self._arange_n).sum(-2)
            if self.sample_frequency == 1:
                st.fetch_counter.add_(cur_mask.to(torch.int32))
            else:
                resample = (step % self.sample_frequency) == 0
                st.fetch_counter.add_(
                    torch.where(resample[..., None], cur_mask, torch.zeros_like(cur_mask)).to(torch.int32)
                )
            st.loss_t2.copy_(loss_t1)
            st.loss_t1.copy_(new_loss)
            st.last_mask.copy_(cur_mask.to(torch.float32))
        if self.mode != "NONE":
            # reset safeguard (Stereo_Online_Adaptation.py:241-244):
            # model weights only, the optimizer state stays
            do_reset = new_loss > self.ssim_th
            for p, p0 in zip(st.params, self._params0):
                at = do_reset.reshape(do_reset.shape + (1,) * (p.dim() - do_reset.dim()))
                p.copy_(torch.where(at, p0, p))
            st.reset_count.add_(do_reset.to(torch.int32))
        if row is not None:
            at = torch.clamp(step.reshape(-1)[:1], max=self.max_steps - 1).long()
            st.metrics.index_copy_(-2, at, row.unsqueeze(-2))
        st.step_count.add_(1)

    def _reduce(self, t: torch.Tensor) -> torch.Tensor:
        """A rank's term of a width-sharded frame's loss summed over the
        ranks (in place); the tensor itself otherwise."""
        if self._layout is not None:
            dist.all_reduce(t, group=self._group)
        return t

    # ------------------------------------------------------------- vmap streams
    def _stream_fn(self, kind: str) -> Callable:
        """The step of branch ``kind`` of one stream as a function of
        tensors alone, ``(flat, k, frame) -> (grad, loss, disp, row)``
        (``grad`` for the train branches only, ``row`` the metrics where
        the session computes them), vmapped over the stream axis with
        ``torch.func``: the module runs on views of the stream's arena row
        (``functional_call``), the gradient is taken with respect to the
        views (``grad_and_value``) and raveled into the row's layout
        (:meth:`..arena.ArenaSpec.ravel`), and every kernel Function folds
        the streams into its batch axis and launches once. ``k`` is the
        stream's sampled block (shared-forward MAD); ``flat`` is not
        updated here."""
        fn = self._vmapped.get(kind)
        if fn is not None:
            return fn
        eng, model, n, spec = self.engine, self.engine.model, self.n_actions, self.spec

        def forward(params, frame):
            return torch.func.functional_call(model, params, (frame["left"], frame["right"]))

        def tail(loss, disp, frame):
            row = (self._metrics_row(disp, frame, loss),) if self.compute_metrics else ()
            return (loss, disp if self.disp_dtype is None else disp.to(self.disp_dtype)) + row

        def none(flat, k, frame):
            out = forward(spec.views(flat), frame)
            if self.mode == "NONE" and not self.compute_metrics:
                loss = torch.zeros((), dtype=torch.float32, device=flat.device)
            else:
                loss = eng._full_loss_fn(out["disparities"], frame)
            return tail(loss, out["full_res_disp"], frame)

        def full(flat, k, frame):
            def loss_fn(p):
                out = forward(p, frame)
                return eng._full_loss_fn(out["disparities"], frame), out["full_res_disp"]

            g, (loss, disp) = torch.func.grad_and_value(loss_fn, has_aux=True)(spec.views(flat))
            return (spec.ravel(g),) + tail(loss, disp, frame)

        def shared(flat, k, frame):
            # one forward, the block losses stacked and selected by the
            # stream's block, one backward through everything
            inputs, prep = eng.block_loss_inputs(frame)

            def loss_fn(p):
                out = forward(p, frame)
                stacked = torch.stack([prep(out["disparities"][i]) for i in range(n)], 0)
                sel = stacked.index_select(0, k.view(1).long())[0]
                return eng._block_base_loss([sel], inputs), out

            g, (_, out) = torch.func.grad_and_value(loss_fn, has_aux=True)(spec.views(flat))
            with torch.no_grad():
                loss = eng._full_loss_fn(out["disparities"], frame)
            return (spec.ravel(g),) + tail(loss, out["full_res_disp"], frame)

        fn = torch.func.vmap({"none": none, "full": full, "shared": shared}[kind])
        self._vmapped[kind] = fn
        return fn

    def _vmap_step(self, branch: Branch, frame: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One frame of every stream under ``vmap``: the vmapped branch,
        then the optimizer updates and the controller of one stream, over
        the ``[N]`` state."""
        kind, st = branch[0], self._all
        k = st.cur_blocks[:, 0] if self.mode == "MAD" else st.step_count
        fn = self._stream_fn(kind)
        if kind == "none":
            with torch.no_grad():
                loss, disp, *row = fn(st.params[0], k, frame)
        else:
            g, loss, disp, *row = fn(st.params[0], k, frame)
        with torch.no_grad():
            if kind == "full":
                self._update_all(st, [g])
            elif kind == "shared":
                self._update_owned(st, k, [g])
            self._control(st, loss, row[0] if row else None)
        return disp

    # ------------------------------------------------------------ width sharding
    def _sharded_step(self, st: _Stream, branch: Branch, frame: Dict[str, torch.Tensor]) -> torch.Tensor:
        """:meth:`_device_step` on the rank's piece of a width-sharded
        frame: the frame is moved from the even cut into the step's layout
        (:mod:`..parallel.spatial`), the step runs under it (the ops fetch
        their halos, the loss and the gradients are summed over the
        ranks), and the disparity goes back to the even cut."""
        if self._layout is None:
            self._layout = spatial.Layout.for_pieces(self._group, frame["left"].shape[2])
        lay = self._layout
        with spatial.sharded(lay):
            inside = {k: lay.enter(v) for k, v in frame.items()}
            disp = self._device_step(st, branch, inside)
            return lay.leave(disp)

    def _stream_step(self, st: _Stream, branch: Branch, frame: Dict[str, torch.Tensor]) -> None:
        """Stream ``st``'s step with the module bound to its arena row, its
        disparity copied into row ``st.index`` of ``_disp_out`` (without
        streams: into ``_disp_out``)."""
        if st.index is not None:
            self.arena.bind(st.index)
            frame = {k: v[st.index] for k, v in frame.items()}
        disp = self._device_step(st, branch, frame)
        if self._disp_out is None:  # the first (eager) step: never under capture
            lead = (self._rows,) if st.index is not None else ()
            self._disp_out = torch.empty(lead + tuple(disp.shape), dtype=disp.dtype, device=self.device)
        (self._disp_out if st.index is None else self._disp_out[st.index]).copy_(disp)

    # ----------------------------------------------------------- frames, graphs
    def _load_frame(self, frame: Dict) -> Dict[str, torch.Tensor]:
        """The frame on the device. On a CUDA device the tensors are the
        session's static buffers (a graph reads fixed addresses), filled
        through one of two pinned staging buffers by an asynchronous
        copy; a frame already on the device is copied there directly.
        Every key is staged on the host before the first copy is enqueued,
        so the device's copies run back to back."""
        keys = [k for k in _FRAME_KEYS if k in frame]
        if self.device.type != "cuda":
            return self.engine._to_device({k: frame[k] for k in keys})
        tr = _TRACER if _TRACER.on else None
        slot = self._host_step % 2
        if self._stage_events[slot] is not None:
            if tr is None:
                self._stage_events[slot].synchronize()  # its last upload has been read
            else:
                with tr.span("fused.stage_wait", self._host_step):
                    self._stage_events[slot].synchronize()
        copies = []
        for k in keys:
            v = frame[k]
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
            buf = self._frame_bufs.get(k)
            if buf is None:
                buf = self._frame_bufs[k] = torch.empty(
                    tuple(t.shape), dtype=torch.float32, device=self.device
                )
            if tuple(t.shape) != tuple(buf.shape):
                raise ValueError(
                    f"frame[{k!r}] has shape {tuple(t.shape)}; this session's graphs "
                    f"were built for {tuple(buf.shape)}"
                )
            if t.device.type != "cuda":
                stage = self._stage[slot].get(k)
                if stage is None:
                    stage = self._stage[slot][k] = torch.empty(
                        tuple(t.shape), dtype=torch.float32, pin_memory=True
                    )
                stage.copy_(t)
                t = stage
                if tr is not None:
                    tr.count("staged_bytes", stage.nbytes)
            copies.append((buf, t))
        if tr is not None:
            tr.mark(self._range, 0)  # MARKS: upload
        for buf, t in copies:
            buf.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._stage_events[slot] = event
        if tr is not None:
            tr.mark(self._range, 1)  # uploaded
        return {k: self._frame_bufs[k] for k in keys}

    def _dispatch(self, key: Tuple, run: Callable[[], Optional[torch.Tensor]]) -> Optional[torch.Tensor]:
        """Run ``run`` (the device work of graph ``key``): eagerly without
        graphs, else as a replay of its graph, captured at first use."""
        tr = _TRACER if _TRACER.on else None
        if not self.use_graphs:
            if tr is not None:
                tr.count("eager_steps")
            return run()
        if key in self._graphs:
            graph, out = self._graphs[key]
            graph.replay()
            for name, n in self.graph_launches[key].items():
                cuda_lib.LAUNCHES[name] += n
            if tr is not None:
                tr.count("replays")
            return out
        if tr is not None:
            tr.count("eager_steps")
        # first use: the frame's real step, eagerly, on the stream the
        # capture will use; then the capture, which runs nothing
        current = torch.cuda.current_stream(self.device)
        side = self._side_stream
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = run()
        current.wait_stream(side)
        if out is not None:
            out.record_stream(current)  # allocated on the side stream, read on this one
        self._capture(key, run)
        return out

    def _capture(self, key: Tuple, run: Callable[[], Optional[torch.Tensor]], raw: bool = False) -> None:
        """Capture ``run`` on the side stream as graph ``key`` (``raw``:
        keeping its ``cudaGraph_t`` for a switch), with its launches."""
        tr = _TRACER if _TRACER.on else None
        with tr.span("fused.capture", self._host_step) if tr is not None else contextlib.nullcontext():
            before = dict(cuda_lib.LAUNCHES)
            graph = torch.cuda.CUDAGraph(keep_graph=True) if raw else torch.cuda.CUDAGraph()
            # A garbage collection during the capture, in this thread or any
            # other, can free the CUDA objects (events, graphs, streams) of dead
            # sessions, and such a call ends the capture
            # (cudaErrorStreamCaptureInvalidated). gc.disable stops collections
            # in every thread of the process until the capture is done.
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self._pool, stream=self._side_stream):
                    graph_out = run()
            finally:
                if collecting:
                    gc.enable()
            launches = {k: v - before[k] for k, v in cuda_lib.LAUNCHES.items() if v != before[k]}
            for name, n in launches.items():
                cuda_lib.LAUNCHES[name] -= n  # a capture launches nothing
            self._graphs[key] = (graph, graph_out)
            self.graph_launches[key] = launches
        if tr is not None:
            tr.count("captures")

    # ------------------------------------------------------------ the switch
    def _state_tensors(self) -> List[torch.Tensor]:
        """Every tensor a step writes: the parameters, the optimizer slots,
        the controller, the metrics ring and the switched disparity."""
        out = list(self._params)
        for k, v in self.opt.items():
            out += [v] if k == "t" else list(v)
        out += [getattr(self, k) for k in _STATE if getattr(self, k) is not None]
        return out + ([self._disp_out] if self._disp_out is not None else [])

    def _snapshot(self) -> List[torch.Tensor]:
        return [t.clone() for t in self._state_tensors()]

    def _restore(self, saved: List[torch.Tensor]) -> None:
        """Copy a :meth:`_snapshot` back (a disparity buffer made after it
        keeps its values: the next launch overwrites it)."""
        with torch.no_grad():
            for t, v in zip(self._state_tensors(), saved):
                t.copy_(v)

    def _switch_key(self, st: _Stream, ks: Tuple[int, ...]) -> Tuple:
        return ("mad", ks) if st.index is None else (st.index, ("mad", ks))

    def _build_switch(self, frame: Dict[str, torch.Tensor]) -> GraphSwitch:
        """The switch over every stream's sampled branches, at the first
        train frame: each branch not captured yet is run eagerly on the
        side stream (cuDNN's first-call set-up, the kernel libraries'
        loading), the state restored from a snapshot, and captured; the
        launches of those runs are taken back out."""
        keys = [[self._switch_key(st, ks) for ks in self._branch_sets] for st in self._streams]
        jobs = [
            (self._switch_key(st, ks), lambda st=st, ks=ks: self._stream_step(st, ("mad", ks), frame))
            for st in self._streams for ks in self._branch_sets if self._switch_key(st, ks) not in self._graphs
        ]
        tr = _TRACER if _TRACER.on else None
        if tr is not None:
            tr.count("eager_steps", len(jobs))
        before = dict(cuda_lib.LAUNCHES)
        current, side = torch.cuda.current_stream(self.device), self._side_stream
        side.wait_stream(current)
        with torch.cuda.stream(side):
            saved = self._snapshot()
            for key, run in jobs:
                run()
                self._restore(saved)
                self._capture(key, run, raw=True)
        current.wait_stream(side)
        cuda_lib.LAUNCHES.update(before)
        switch = GraphSwitch(
            [[self._graphs[key][0].raw_cuda_graph() for key in row] for row in keys],
            [st.cur_blocks for st in self._streams], self.n_actions, self._branch_table,
        )
        self._switch = (switch, keys)
        return switch

    def _switch_step(self, frame: Dict[str, torch.Tensor]) -> None:
        """One launch of the switch: each stream's sampled branch, picked on
        the device, the streams in order."""
        switch = self._switch[0] if self._switch is not None else self._build_switch(frame)
        switch.launch()
        tr = _TRACER if _TRACER.on else None
        if tr is not None:
            tr.count("replays")

    def sync_launches(self) -> None:
        """Add the switched launches' kernel launches to
        ``ops.cuda_lib.LAUNCHES``: each branch's captured launches times
        the times the device took it since the last call. Waits for the
        device (``finalize`` and ``block_until_ready`` call it); raises if
        a switch found sampled ids that name no branch."""
        if self._switch is not None:
            switch, keys = self._switch
            for row, counts in zip(keys, switch.taken().tolist()):
                for key, c in zip(row, counts):
                    for name, n in self.graph_launches[key].items():
                        cuda_lib.LAUNCHES[name] += c * n

    # -------------------------------------------------------------------- api
    def step(self, frame: Dict) -> None:
        """Dispatch one frame; returns at once. The frame's full-resolution
        disparity is kept as ``last_disp``, a device tensor that holds its
        values until the next step (it lives in the graphs' memory pool):
        fetch it with :meth:`fetch_disp`, or clone it, before stepping on.
        With streams the frame's arrays carry a leading ``[N]`` axis, one
        frame of every stream, and ``last_disp`` is ``[N, 1, H, W, 1]``
        (over a mesh, the rank's streams). With a width-sharded mesh the
        frame is the rank's piece of every array, as ``shard_batch(frame,
        width_sharded(mesh))`` cuts it, and so is ``last_disp``.
        Raises if the conv precision in force is no longer the engine's: a
        graph captured under one mode would replay that mode."""
        self.engine.check_precision()
        ns = self._rows
        if ns and any(len(frame[k]) != ns for k in _FRAME_KEYS if k in frame):
            raise ValueError(f"a frame of a {ns}-stream session carries a leading [{ns}] axis")
        tr = _TRACER if _TRACER.on else None
        if tr is None:
            bufs = self._load_frame(frame)
            self._launch(self._pick_branches(self._host_step), bufs)
        else:  # the spans, the count and on the card the device range of the module's docstring
            fid = self._host_step
            with tr.span("fused.step", fid):
                self._range = tr.open_range(fid, self.device)
                with tr.span("fused.load_frame", fid):
                    bufs = self._load_frame(frame)
                with tr.span("fused.pick", fid):
                    branches = self._pick_branches(fid)
                    if self.mode == "MAD" and branches[0][0] != "none":
                        tr.tag(self._range, self.cur_blocks)  # the ids this frame's launch reads
                    tr.mark(self._range, 2)  # picked
                with tr.span("fused.launch", fid):
                    self._launch(branches, bufs)
                    tr.mark(self._range, 3)  # launched
                tr.count("steps")
        if ns:
            self.arena.bind(0)  # between steps the module shows stream 0
        self._host_step += 1

    def _launch(self, branches: List[Branch], bufs: Dict[str, torch.Tensor]) -> None:
        """The frame's device work, each stream's branch: the switch's
        launch, or a replay (an eager run) a graph, and ``last_disp``."""
        ns = self._rows
        if branches[0] == _SWITCH:  # the host counts dilation and sampling alike for all streams
            self._switch_step(bufs)
            self.last_disp = self._disp_out
        elif not ns:
            (branch,) = branches
            st = self._streams[0]
            step = self._sharded_step if self._sharded else self._device_step
            self.last_disp = self._dispatch(branch, lambda: step(st, branch, bufs))
        elif self.stream_impl == "vmap":
            (branch,) = set(branches)  # the host counts dilation and sampling alike for all
            self.last_disp = self._dispatch(branch, lambda: self._vmap_step(branch, bufs))
        elif self.stream_impl == "unroll" and len(set(branches)) == 1:
            def run_all():  # the N streams' steps in one graph
                for st, branch in zip(self._streams, branches):
                    self._stream_step(st, branch, bufs)
            self._dispatch(tuple(branches), run_all)
            self.last_disp = self._disp_out
        else:
            for st, branch in zip(self._streams, branches):
                self._dispatch((st.index, branch), lambda: self._stream_step(st, branch, bufs))
            self.last_disp = self._disp_out

    def fetch_disp(self) -> Callable[[], np.ndarray]:
        """Start the device-to-host copy of ``last_disp`` without blocking
        and return a zero-argument materializer (a numpy array when
        called). The copy goes into one of two pinned buffers, in turn,
        on the step's stream, so it is ordered before the next replay
        overwrites the disparity; the materializer waits on its event.
        Call it right after ``step``; materialize before the second fetch
        after this one reuses the buffer. numpy has no bfloat16: a bf16
        disparity (DispNet under ``bf16_act``) arrives widened to float32,
        losslessly."""
        tr = _TRACER if _TRACER.on else None
        if tr is None:
            return self._fetch_disp()
        fid = self._host_step - 1
        with tr.span("fused.fetch_disp", fid):
            fetch = self._fetch_disp()

        def materialize() -> np.ndarray:
            if not tr.on:
                return fetch()
            with tr.span("fused.materialize", fid):
                return fetch()

        return materialize

    def _fetch_disp(self) -> Callable[[], np.ndarray]:
        d = self.last_disp
        if d is None:
            raise RuntimeError("fetch_disp before the first step")
        if self.device.type != "cuda":
            host = d.detach().clone()
            return lambda: _numpy(host)
        slot = self._fetches % 2
        self._fetches += 1
        host = self._disp_host[slot]
        if host is None or host.shape != d.shape or host.dtype != d.dtype:
            host = self._disp_host[slot] = torch.empty(
                tuple(d.shape), dtype=d.dtype, pin_memory=True
            )
        host.copy_(d, non_blocking=True)
        tr = _TRACER if _TRACER.on else None
        if tr is not None:
            tr.mark(self._range, 4)  # fetched
            tr.count("fetched_bytes", host.nbytes)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))

        def materialize() -> np.ndarray:
            event.synchronize()
            return _numpy(host).copy()

        return materialize

    def step_pipelined(self, frame: Dict) -> Optional[np.ndarray]:
        """Depth-1 pipelined serving step: dispatch this frame and start
        its disparity's copy to the host, then return the PREVIOUS frame's
        disparity as numpy (``None`` on the first call). Frame i's copy
        overlaps frame i+1's execution; the price is one frame of
        staleness. Call :meth:`flush_disp` after the last frame."""
        self.step(frame)
        nxt = self.fetch_disp()
        prev, self._pending_disp = self._pending_disp, nxt
        return prev() if prev is not None else None

    def flush_disp(self) -> Optional[np.ndarray]:
        """Materialize and clear the disparity left in flight by the last
        :meth:`step_pipelined` call (``None`` if nothing is pending)."""
        pending, self._pending_disp = self._pending_disp, None
        return pending() if pending is not None else None

    def serve(self, frames: Iterable[Dict]):
        """Depth-1 pipelined serving loop: yields one numpy disparity per
        input frame, in frame order; frame i's result is yielded while
        frame i+1 executes, and the last is drained after the input ends."""
        pending = None
        for f in frames:
            self.step(f)
            nxt = self.fetch_disp()
            if pending is not None:
                yield pending()
            pending = nxt
        if pending is not None:
            yield pending()

    def step_chunk(self, frames: Dict, unroll: int = 1) -> None:
        """Dispatch K frames from one call: ``frames`` carries a leading
        ``[K]`` axis (``[K, N]`` with streams). The trajectory is that of K
        ``step`` calls (the frames' graphs are replayed in order);
        ``last_disp`` holds the ``[K]`` stacked disparities. ``unroll`` is
        accepted for the JAX signature's sake and has no effect: there is
        no scan to unroll. A mesh session refuses it, as the JAX one does."""
        del unroll
        if self.mesh is not None:
            raise ValueError(
                "step_chunk is a single-chip dispatch optimization; "
                "mesh sessions amortize dispatch differently"
            )
        k = len(frames["left"])
        stacked = None
        for i in range(k):
            self.step({name: v[i] for name, v in frames.items()})
            if stacked is None:
                stacked = torch.empty(
                    (k, *self.last_disp.shape), dtype=self.last_disp.dtype, device=self.device
                )
            stacked[i].copy_(self.last_disp)
        self.last_disp = stacked

    def finalize(self) -> Dict[str, np.ndarray]:
        """Wait for the device and transfer the accumulated statistics
        (the one sync): ``scores``, ``fetch_counter``, ``reset_count``,
        ``steps`` and, with metrics, ``epe``, ``bad3``, ``d1``, ``loss``
        per frame. With streams every array has a leading ``[N]`` axis and
        ``steps`` is the count common to the streams; with streams over a
        mesh, every rank gathers all N. Adds the switched launches' kernel
        launches to the counters (:meth:`sync_launches`)."""
        self.sync_launches()
        nsteps = int(self.step_count.max().item())
        host = {
            "scores": self.scores.cpu().numpy(),
            "fetch_counter": self.fetch_counter.cpu().numpy(),
            "reset_count": self.reset_count.cpu().numpy(),
        }
        if self.compute_metrics:
            m = self.metrics[..., : min(nsteps, self.max_steps), :].cpu().numpy()
            for j, k in enumerate(("epe", "bad3", "d1", "loss")):
                host[k] = m[..., j]
        if self._streams_over_mesh:
            pieces = [None] * self._group.size()
            dist.all_gather_object(pieces, host, group=self._group)
            host = {k: np.concatenate([p[k] for p in pieces]) for k in host}
        host["steps"] = nsteps
        return host

    @property
    def _streams_over_mesh(self) -> bool:
        return bool(self.num_streams) and self.mesh is not None

    def _gather_rows(self, flat: torch.Tensor) -> torch.Tensor:
        """The ``[N, P]`` rows of every rank, from this rank's ``[n, P]``
        (pieces padded to one size for the all-gather, then cut)."""
        size = self._group.size()
        piece = local_slice(self.num_streams, size, 0)
        rows = piece.stop - piece.start
        padded = flat.new_zeros((rows, flat.shape[1]))
        padded[: flat.shape[0]].copy_(flat)
        out = [torch.empty_like(padded) for _ in range(size)]
        dist.all_gather(out, padded, group=self._group)
        cuts = [local_slice(self.num_streams, size, r) for r in range(size)]
        return torch.cat([o[: c.stop - c.start] for o, c in zip(out, cuts)])

    def current_params(self) -> Dict[str, torch.Tensor]:
        """The adapted weights as a ``state_dict``: the module's own live
        tensors (views of the arena when it is on). With streams, views of
        the ``[N, P]`` arena, each with a leading ``[N]`` axis. Clone what
        must outlive the next step. With streams over a mesh every rank
        gathers the N streams' weights (copies, not views)."""
        if self.num_streams:
            at = {name: (shape, off, size) for name, shape, off, size in self.spec.entries}
            flat = self._gather_rows(self.arena.flat) if self._streams_over_mesh else self.arena.flat
            return {
                name: flat[:, at[name][1] : at[name][1] + at[name][2]].view(len(flat), *at[name][0])
                for name in self._names
            }
        return self.engine.model.state_dict()

    def snapshot_params(self) -> Callable[[], Dict[str, np.ndarray]]:
        """Non-blocking weight snapshot of a live stream: copies the
        weights on the device first (the live ones are updated in place by
        the next step), starts the copy to the host without waiting, and
        returns a zero-argument callable that gives ``{name: numpy array}``
        when called (with streams, each with a leading ``[N]`` axis). With
        the arena it is one contiguous transfer, and the unravel happens on
        the host."""
        cuda = self.device.type == "cuda"

        def to_host(t: torch.Tensor) -> torch.Tensor:
            if not cuda:
                return t.detach().clone()
            host = torch.empty(tuple(t.shape), dtype=t.dtype, pin_memory=True)
            host.copy_(t.detach().clone(), non_blocking=True)
            return host

        copies = [to_host(p) for p in self._params]
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))

        def materialize() -> Dict[str, np.ndarray]:
            if event is not None:
                event.synchronize()
            if self.spec is not None:
                return self.spec.unravel_host(copies[0].numpy())
            return {name: c.numpy() for name, c in zip(self._names, copies)}

        return materialize

    def block_until_ready(self) -> None:
        """Wait until every dispatched step has run, and add the switched
        launches' kernel launches to the counters (:meth:`sync_launches`)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.sync_launches()
