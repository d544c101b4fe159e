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
and the shared-forward step. PyTorch has no device-side switch node, so
the host picks the graph. It can do so without reading the device:
``step % dilation`` and ``step % sample_frequency`` it counts itself,
and with the FIXED and SEQUENTIAL samplers it knows the block too, so
the steady state has no host sync at all. With ARGMAX, RANDOM and
PROBABILITY the block depends on the scores, hence on the previous
frame's loss: the sample is drawn on the device and the session reads
the ``[num_blocks]`` ids, one small read per resample. That is the one
sync a frame this design allows itself; ``shared_forward=True`` needs
none (its graph selects the block loss by a device index).

Graphs are captured lazily. The first frame that takes a branch runs it
eagerly on a side stream (that is the frame's real step; it carries
cuDNN's first-call set-up of that branch's backward, and it builds and
loads whatever kernel library the branch launches); the branch is then
captured, without running, and every later frame of that branch is one
``replay``. So the first frame of each branch costs an eager step plus a
capture, and a MAD session is steady after its first round. All graphs
of a session share one memory pool, since one replays at a time: the
disparity a step returns (``last_disp``) lives in that pool and holds
its values until the next step only. ``fetch_disp`` therefore enqueues
the copy to a pinned host buffer on the same stream right away.

The kernel wrappers count their launches in ``ops.cuda_lib.LAUNCHES``
when Python calls them, which under capture is once, with nothing
launched. The session takes a capture's counts back out, keeps them with
the graph, and adds them at every replay, so the counters go on meaning
launches.

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
graph a frame); a frame whose streams take different branches (PROBABILITY,
RANDOM, ARGMAX) replays map's graphs. A graph per tuple of branches would
be up to ``n_actions ** N`` captures, each an eager step and a capture;
this way a branch has at most N + 1 graphs. The graphs read their
stream's row of the arena: the module is
bound to that row (:meth:`.arena.Arena.bind`) while its step runs eagerly
and while it is captured. Each stream's disparity is copied, inside its
graph, into one ``[N, ...]`` buffer, which is ``last_disp``.
"""

from __future__ import annotations

import gc
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from real_time_self_adaptive_deep_stereo_torch.adapt.arena import build_arena
from real_time_self_adaptive_deep_stereo_torch.adapt.engine import (
    AdaptationEngine,
    d1_metric,
    disparity_metrics,
)
from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib
from real_time_self_adaptive_deep_stereo_torch.utils import optim

__all__ = ["FusedOnlineSession"]

Branch = Tuple  # ("none",) | ("full",) | ("shared",) | ("mad", (k, ...))
_FRAME_KEYS = ("left", "right", "target", "proxy")
_NOT_PORTED = "is not ported: ROADMAP.md, queue 1, `parallel/` (`vmap` and `mesh`)"


class _Stream:
    """One stream's state: views of the session's tensors (row ``index``
    of each where the session has a stream axis), its generator, and the
    blocks its next train step takes, as the host knows them."""

    def __init__(self, index: Optional[int], **tensors):
        self.index = index
        self.host_blocks: Tuple[int, ...] = ()
        for k, v in tensors.items():
            setattr(self, k, v)


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
    seeds, and ``stream_impl`` is ``"map"`` (``"auto"``) or ``"unroll"``.

    Not ported, each raising ``NotImplementedError``: ``mesh`` (width
    sharding, the stream axis over a mesh) and ``stream_impl="vmap"``; see
    ``ROADMAP.md``, queue 1, ``parallel/``. ``spatial_axis`` names the mesh
    axis and is kept for the signature only.
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
        if mesh is not None:
            raise NotImplementedError(
                f"mesh (width sharding, the stream axis over a mesh) {_NOT_PORTED}"
            )
        if stream_impl == "vmap":
            raise NotImplementedError(f'stream_impl="vmap" {_NOT_PORTED}')
        if stream_impl not in ("auto", "map", "unroll"):
            raise ValueError(f"unknown stream_impl {stream_impl!r}")
        self.num_streams = int(num_streams)
        self.stream_impl = "map" if stream_impl == "auto" else stream_impl
        if self.num_streams < 0:
            raise ValueError(f"num_streams must be >= 0, got {num_streams}")
        if self.num_streams and not arena:
            raise ValueError("num_streams requires arena=True")
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
        self.use_graphs = on_cuda if use_graphs is None else bool(use_graphs)
        if self.use_graphs and not on_cuda:
            raise ValueError("use_graphs=True needs a CUDA device")

        if params is not None:
            engine.model.load_state_dict(params)
        self._names = list(engine._named_params)
        self._all_params = list(engine._named_params.values())
        self._index = {name: i for i, name in enumerate(self._names)}
        self.arena = build_arena(engine.model, engine.blocks, self.num_streams) if arena else None
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
        self.graph_launches: Dict[Tuple, Dict[str, int]] = {}
        self._disp_out: Optional[torch.Tensor] = None  # [N, ...]: the streams' disparities
        if on_cuda:
            self._side_stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle() if self.use_graphs else None
        self._frame_bufs: Dict[str, torch.Tensor] = {}
        self._stage: List[Dict[str, torch.Tensor]] = [{}, {}]
        self._stage_events: List[Optional[torch.cuda.Event]] = [None, None]
        self._disp_host: List[Optional[torch.Tensor]] = [None, None]
        self._fetches = 0

    # ------------------------------------------------------------------ state
    def _init_state(self, seed) -> None:
        """The state tensors, with a leading ``[num_streams]`` axis where
        the session has streams, and one :class:`_Stream` of views per
        stream (one in all without streams)."""
        eng, dev, n = self.engine, self.device, self.n_actions
        ns = self.num_streams
        lead = (ns,) if ns else ()
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        seeds = list(seed) if isinstance(seed, (list, tuple)) else [int(seed) + s for s in range(max(ns, 1))]
        if len(seeds) != max(ns, 1):
            raise ValueError(f"need {max(ns, 1)} seeds, got {len(seeds)}")
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
                **{k: row(getattr(self, k), s) for k in (
                    "scores", "loss_t1", "loss_t2", "last_mask", "step_count", "reset_count",
                    "fetch_counter", "cur_blocks", "metrics")},
                generator=torch.Generator(device=dev).manual_seed(int(seeds[s])),
            )
            for s in range(max(ns, 1))
        ]
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
        where the host must pick a graph by them, into each stream's
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
        if not self.shared_forward:
            # the one host read of a frame: the [num_blocks] ids of every
            # stream, which depend on the scores and so on the previous
            # frame's loss
            ids = self.cur_blocks.tolist()
            for st, row in zip(self._streams, ids if self.num_streams else [ids]):
                st.host_blocks = tuple(sorted(set(row)))

    @property
    def _host_blocks(self) -> Tuple[int, ...]:
        """The blocks the next train step of the (first) stream takes."""
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
        return [("shared",) if self.shared_forward else ("mad", st.host_blocks) for st in self._streams]

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
            return [g]
        grads = torch.autograd.grad(loss, params, retain_graph=retain, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]

    @torch.no_grad()
    def _apply(self, st: _Stream, block: Optional[int], grads: List[torch.Tensor], t) -> None:
        eng = self.engine
        params, slots = self._views(st, block)
        if eng.optimizer == "momentum":
            optim.momentum_update(params, slots["acc"], grads, eng.lr, eng.momentum)
        else:
            optim.adam_update(params, slots["m"], slots["v"], grads, eng.lr, t)

    def _train_full(self, st: _Stream, frame):
        eng = self.engine
        eng._set_trainable()
        out = eng.model(frame["left"], frame["right"])
        loss = eng._full_loss_fn(out["disparities"], frame)
        grads = self._grads(loss, None, retain=False)
        t = st.opt["t"] + 1 if "t" in st.opt else None
        self._apply(st, None, grads, t)
        if t is not None:
            st.opt["t"].copy_(t)
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
            for p, acc, g, bid in zip(st.params, st.opt["acc"], grads, self._block_ids):
                own = k == bid
                acc.copy_(torch.where(own, eng.momentum * acc + g, acc))
                p.copy_(torch.where(own, p - eng.lr * acc, p))
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
            step = st.step_count
            if self.mode == "MAD":
                # reward bookkeeping (Stereo_Online_Adaptation.py:211-224),
                # every frame: only the train ops are dilation-gated
                first = step == 0
                loss_t1 = torch.where(first, new_loss, st.loss_t1)
                loss_t2 = torch.where(first, new_loss, st.loss_t2)
                gain = (2.0 * loss_t1 - loss_t2) - new_loss
                st.scores.copy_(self.decay * st.scores + self.uf * gain * st.last_mask)
                cur_mask = (st.cur_blocks[:, None] == self._arange_n[None, :]).sum(0)
                if self.sample_frequency == 1:
                    st.fetch_counter.add_(cur_mask.to(torch.int32))
                else:
                    resample = (step % self.sample_frequency) == 0
                    st.fetch_counter.add_(
                        torch.where(resample, cur_mask, torch.zeros_like(cur_mask)).to(torch.int32)
                    )
                st.loss_t2.copy_(loss_t1)
                st.loss_t1.copy_(new_loss)
                st.last_mask.copy_(cur_mask.to(torch.float32))
            if self.mode != "NONE":
                # reset safeguard (Stereo_Online_Adaptation.py:241-244):
                # model weights only, the optimizer state stays
                do_reset = new_loss > self.ssim_th
                for p, p0 in zip(st.params, self._params0):
                    p.copy_(torch.where(do_reset, p0, p))
                st.reset_count.add_(do_reset.to(torch.int32))
            if self.compute_metrics:
                epe, bad3 = disparity_metrics(disp, frame["target"])
                _, d1 = d1_metric(disp, frame["target"])
                row = torch.stack([epe, bad3, d1, new_loss]).view(1, 4)
                at = torch.clamp(step, max=self.max_steps - 1).view(1).long()
                st.metrics.index_copy_(0, at, row)
            st.step_count.add_(1)
            if self.disp_dtype is not None:
                disp = disp.to(self.disp_dtype)
        return disp

    def _stream_step(self, st: _Stream, branch: Branch, frame: Dict[str, torch.Tensor]) -> None:
        """Stream ``st``'s step with the module bound to its arena row, its
        disparity copied into row ``st.index`` of ``_disp_out``."""
        self.arena.bind(st.index)
        disp = self._device_step(st, branch, {k: v[st.index] for k, v in frame.items()})
        if self._disp_out is None:  # the first (eager) step: never under capture
            self._disp_out = torch.empty(
                (self.num_streams, *disp.shape), dtype=disp.dtype, device=self.device
            )
        self._disp_out[st.index].copy_(disp)

    # ----------------------------------------------------------- frames, graphs
    def _load_frame(self, frame: Dict) -> Dict[str, torch.Tensor]:
        """The frame on the device. On a CUDA device the tensors are the
        session's static buffers (a graph reads fixed addresses), filled
        through one of two pinned staging buffers by an asynchronous
        copy; a frame already on the device is copied there directly."""
        keys = [k for k in _FRAME_KEYS if k in frame]
        if self.device.type != "cuda":
            return self.engine._to_device({k: frame[k] for k in keys})
        slot = self._host_step % 2
        if self._stage_events[slot] is not None:
            self._stage_events[slot].synchronize()  # its last upload has been read
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
            if t.device.type == "cuda":
                buf.copy_(t)
                continue
            stage = self._stage[slot].get(k)
            if stage is None:
                stage = self._stage[slot][k] = torch.empty(
                    tuple(t.shape), dtype=torch.float32, pin_memory=True
                )
            stage.copy_(t)
            buf.copy_(stage, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._stage_events[slot] = event
        return {k: self._frame_bufs[k] for k in keys}

    def _dispatch(self, key: Tuple, run: Callable[[], Optional[torch.Tensor]]) -> Optional[torch.Tensor]:
        """Run ``run`` (the device work of graph ``key``): eagerly without
        graphs, else as a replay of its graph, captured at first use."""
        if not self.use_graphs:
            return run()
        if key in self._graphs:
            graph, out = self._graphs[key]
            graph.replay()
            for name, n in self.graph_launches[key].items():
                cuda_lib.LAUNCHES[name] += n
            return out
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
        before = dict(cuda_lib.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        # A garbage collection during the capture, in this thread or any
        # other, can free the CUDA objects (events, graphs, streams) of dead
        # sessions, and such a call ends the capture
        # (cudaErrorStreamCaptureInvalidated). gc.disable stops collections
        # in every thread of the process until the capture is done.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=side):
                graph_out = run()
        finally:
            if collecting:
                gc.enable()
        launches = {k: v - before[k] for k, v in cuda_lib.LAUNCHES.items() if v != before[k]}
        for name, n in launches.items():
            cuda_lib.LAUNCHES[name] -= n  # a capture launches nothing
        self._graphs[key] = (graph, graph_out)
        self.graph_launches[key] = launches
        return out

    # -------------------------------------------------------------------- api
    def step(self, frame: Dict) -> None:
        """Dispatch one frame; returns at once. The frame's full-resolution
        disparity is kept as ``last_disp``, a device tensor that holds its
        values until the next step (it lives in the graphs' memory pool):
        fetch it with :meth:`fetch_disp`, or clone it, before stepping on.
        With streams the frame's arrays carry a leading ``[N]`` axis, one
        frame of every stream, and ``last_disp`` is ``[N, 1, H, W, 1]``.
        Raises if the conv precision in force is no longer the engine's: a
        graph captured under one mode would replay that mode."""
        self.engine.check_precision()
        ns = self.num_streams
        if ns and any(len(frame[k]) != ns for k in _FRAME_KEYS if k in frame):
            raise ValueError(f"a frame of a {ns}-stream session carries a leading [{ns}] axis")
        bufs = self._load_frame(frame)
        branches = self._pick_branches(self._host_step)
        if not ns:
            (branch,) = branches
            st = self._streams[0]
            self.last_disp = self._dispatch(branch, lambda: self._device_step(st, branch, bufs))
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
        if ns:
            self.arena.bind(0)  # between steps the module shows stream 0
        self._host_step += 1

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
        no scan to unroll."""
        del unroll
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
        ``steps`` is the count common to the streams."""
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
        host["steps"] = nsteps
        return host

    def current_params(self) -> Dict[str, torch.Tensor]:
        """The adapted weights as a ``state_dict``: the module's own live
        tensors (views of the arena when it is on). With streams, views of
        the ``[N, P]`` arena, each with a leading ``[N]`` axis. Clone what
        must outlive the next step."""
        if self.num_streams:
            at = {name: (shape, off, size) for name, shape, off, size in self.spec.entries}
            flat = self.arena.flat
            return {
                name: flat[:, at[name][1] : at[name][1] + at[name][2]].view(self.num_streams, *at[name][0])
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
        """Wait until every dispatched step has run."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
