"""Width sharding: one frame cut along its width over the ranks of a
process group, every op of the step on its rank's piece.

The JAX package shards the frame with ``P(None, None, axis)`` and lets
GSPMD partition each op: a halo exchange at every convolution, an
all-gather where an op needs the whole width. Here every rank is a
process holding its piece, so the step says its exchanges itself, with
one differentiable primitive, :meth:`Layout.fetch`: the global columns
``[lo, hi)`` of a width-sharded tensor, taken from whichever ranks own
them by point-to-point exchange, columns outside ``[0, W)`` as zeros (a
convolution's SAME zero pad). Its backward sends each fetched column's
gradient back to its owner, which adds it.

**The layout.** Every width-sharded tensor of the step is cut on the grid
of the coarsest level: the pyramids of both models, MADNet and
DispNet-Corr1D, halve the width six times from the frame REFLECT-padded
to a multiple of 64, so the padded width is ``64 * n`` and a rank holds columns
``[a, b)`` of the ``n`` coarse ones (``local_slice``'s cut), that is
``[a * 2**(6-l), b * 2**(6-l))`` at level l. A stride-2 SAME convolution
then maps a rank's piece onto its piece of the next level (TF SAME pads
``(0, 1)`` at an even width: a right halo of one column), a transposed
convolution of stride 2 onto its piece of the finer level (DispNet's 4x4
ones read one column on each side), a resize by two onto its piece of
the other level, and every global width follows
from the local one, with no collective. The frame's own width ``W0`` (the
padded width less the centred REFLECT pad) is cut likewise, each rank
holding its padded piece less the pad; the pad itself falls to the edge
ranks, which reflect their own columns.

The frame arrives cut evenly (``shard_batch(frame, width_sharded(mesh))``,
``torch.chunk``'s pieces); :meth:`Layout.enter` moves it into the layout
and :meth:`Layout.leave` moves a result back, with the same primitive.

**The context.** :func:`sharded` makes a layout the active one; the
port's width-reading ops consult :func:`active` and :func:`width` (both
of :mod:`..ops.shard_context`, which the ops own) and, where it is set,
run on the rank's piece: ``ops.conv`` (the halo from k, stride, rate and
the SAME split; for a transposed convolution the input columns that
reach the rank's outputs), ``ops.correlation`` (a halo of the radius on the right
features, the result cropped), the warps of ``ops.warp_kernels`` (the
source fetched whole, as GSPMD all-gathers it, the offset placed at the
rank's columns of the full width, the result sliced), ``ops.resize``
(the input columns that the rank's rows of the TF1 matrix touch; the
pad and crop at the edge ranks), the losses' SSIM (a halo of one column,
then sums over the global count) and L1 mean (its valid count summed
over the ranks), and every global width the model and the losses read.
Off the width-sharded path no layout is active and nothing changes.

**Collectives.** NCCL takes CUDA tensors as they are. gloo's point to
point takes host tensors only, so under gloo a CUDA tensor is staged
through host memory (a device synchronisation each exchange): the
width-sharded step then runs eagerly, never in a CUDA graph.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from real_time_self_adaptive_deep_stereo_torch.ops.shard_context import active, sharded, width  # noqa: F401
from real_time_self_adaptive_deep_stereo_torch.parallel.sharding import local_slice

__all__ = ["COARSE", "Layout", "active", "sharded", "width", "check_model"]

COARSE = 64  # the coarsest level of MADNet and of DispNet is 1/64 of the padded width
Span = Tuple[int, int]


def check_model(model) -> None:
    """Raise unless ``model`` runs width-sharded: every op of its forward
    has a sharded form (``width_sharding``, which MADNet and DispNet set)."""
    if not getattr(model, "width_sharding", False):
        raise NotImplementedError(
            f"{getattr(model, 'name', type(model).__name__)} has no width-sharded form: "
            "a model says that every op of its forward runs on a rank's columns with "
            "width_sharding = True"
        )


class _Fetch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, dim, owned, spans):
        ctx.layout, ctx.dim, ctx.owned, ctx.spans = layout, dim, owned, spans
        ctx.local = tuple(x.shape)
        return layout._move(x, dim, owned, spans)

    @staticmethod
    def backward(ctx, g):
        return ctx.layout._move_back(g, ctx.dim, ctx.owned, ctx.spans, ctx.local), None, None, None, None


class Layout:
    """The cut of one frame's width over the ranks of ``group``.

    ``width`` is the frame's own width W0. ``ranges(W)`` gives every rank's ``(lo, hi)`` at the
    global width W of one level (or W0), ``range(W)`` this rank's;
    ``global_width(w)`` the global width of a local one. ``audit`` counts
    the fetches by ``(tag, W, extra left, extra right, whole)``: the
    columns fetched beyond the rank's own and whether every rank fetched
    the whole width."""

    def __init__(self, group, width: int):
        self.group = group
        self.rank, self.world = dist.get_rank(group), dist.get_world_size(group)
        self.peers = [dist.get_global_rank(group, s) for s in range(self.world)]
        self.backend = dist.get_backend(group)
        self.width = int(width)
        self.padded = -(-self.width // COARSE) * COARSE
        self.offset = (self.padded - self.width) // 2  # the reflect pad before column 0
        self._ranges = self.cut(self.width, self.world)
        self.even = [
            (c.start, c.stop) for c in (local_slice(self.width, self.world, s) for s in range(self.world))
        ]
        # A rank whose piece of the frame is as wide as its piece of the
        # padded frame (a middle rank; the first where the pad before the
        # frame is 0) reads that width as the frame's, which the models,
        # the losses and the engine read; the ops that hold the padded
        # frame say so (``global_width(local, pyramid=True)``). No other
        # two widths share a piece width: a piece of the frame is its
        # padded piece less at most 32 columns, and wider than half of it.
        shared: Dict[int, set] = {}
        for w, rs in self._ranges.items():
            shared.setdefault(rs[self.rank][1] - rs[self.rank][0], set()).add(w)
        self._global: Dict[int, Optional[int]] = {}
        for local, ws in shared.items():
            one = next(iter(ws)) if len(ws) == 1 else self.width if ws == {self.width, self.padded} else None
            self._global[local] = one  # None: ambiguous
        lo, hi = self.range(self.padded)
        self._padded_local = hi - lo
        self.audit: Counter = Counter()

    @staticmethod
    def cut(width: int, world: int) -> Dict[int, List[Span]]:
        """Every rank's ``(lo, hi)`` at the global width of each level and
        at the frame's own width, for a frame ``width`` wide over ``world``
        ranks: the ranges of the layout (no process group needed)."""
        padded = -(-width // COARSE) * COARSE
        n = padded // COARSE
        if n < world:
            raise ValueError(f"a width of {width} has {n} columns at 1/{COARSE}: too few for {world} ranks")
        cuts = [local_slice(n, world, s) for s in range(world)]
        if cuts[-1].start == cuts[-1].stop:  # the chunks of ceil(n / world) run out first
            raise ValueError(f"a width of {width} leaves the last of {world} ranks no column at 1/{COARSE}")
        ranges: Dict[int, List[Span]] = {}
        f = COARSE
        while f >= 1:
            ranges[n * f] = [(c.start * f, c.stop * f) for c in cuts]
            f //= 2
        if width != padded:
            offset = (padded - width) // 2
            clip = lambda v: min(max(v - offset, 0), width)  # noqa: E731
            ranges[width] = [(clip(lo), clip(hi)) for lo, hi in ranges[padded]]
            first, last = ranges[width][0], ranges[width][-1]
            if first[1] - first[0] <= offset or last[1] - last[0] <= padded - width - offset:
                raise NotImplementedError(f"an edge rank's piece of width {width} is narrower than the reflect pad")
        return ranges

    @classmethod
    def for_pieces(cls, group, local_width: int) -> "Layout":
        """The layout of a frame cut evenly over ``group``, from this
        rank's piece width (one all-gather of the widths)."""
        widths = [None] * dist.get_world_size(group)
        dist.all_gather_object(widths, int(local_width), group=group)
        total = sum(widths)
        world = len(widths)
        want = [len(range(total)[local_slice(total, world, s)]) for s in range(world)]
        if widths != want:
            raise ValueError(f"the ranks' pieces {widths} are not the even cut of {total} ({want})")
        return cls(group, total)

    # ---------------------------------------------------------------- widths
    def ranges(self, w: int) -> List[Span]:
        if w not in self._ranges:
            raise ValueError(f"width {w} is no level of the layout of {self.width} ({sorted(self._ranges)})")
        return self._ranges[w]

    def range(self, w: int) -> Span:
        return self.ranges(w)[self.rank]

    def global_width(self, local: int, pyramid: bool = False) -> int:
        """The global width of a rank's local one; with ``pyramid``, of a
        tensor of the padded frame's pyramid, never of the frame (the
        rank's padded piece then reads as the padded width)."""
        if pyramid and local == self._padded_local:
            return self.padded
        w = self._global.get(local)
        if w is None:
            raise ValueError(
                f"a local width of {local} is {'ambiguous' if local in self._global else 'no piece'} "
                f"in the layout of {self.width} over {self.world} ranks"
            )
        return w

    # ------------------------------------------------------------ the fetches
    def fetch(self, x: torch.Tensor, dim: int, owned: Sequence[Span], spans: Sequence[Span], tag: str):
        """The global columns ``spans[rank]`` of axis ``dim`` of the tensor
        whose pieces the ranks hold (``owned[s]`` rank s's columns, ``x``
        this rank's), zeros outside ``[0, W)``; differentiable. Every rank
        calls it at the same point with the same ``owned`` and ``spans``."""
        w = max(hi for _, hi in owned)
        (olo, ohi), (slo, shi) = owned[self.rank], spans[self.rank]
        whole = all(span == (0, w) for span in spans)
        self.audit[(tag, w, olo - slo, shi - ohi, whole)] += 1
        return _Fetch.apply(x, self, dim % x.dim(), tuple(owned), tuple(spans))

    def halo(self, x: torch.Tensor, dim: int, left: int, right: int, tag: str) -> torch.Tensor:
        """The rank's piece of axis ``dim`` with ``left`` and ``right``
        columns of its neighbours on either side (zeros beyond the frame)."""
        owned = self.ranges(self.global_width(x.shape[dim]))
        return self.fetch(x, dim, owned, [(lo - left, hi + right) for lo, hi in owned], tag)

    def gather(self, x: torch.Tensor, dim: int, tag: str) -> torch.Tensor:
        """The whole width of axis ``dim`` on every rank."""
        w = self.global_width(x.shape[dim])
        return self.fetch(x, dim, self.ranges(w), [(0, w)] * self.world, tag)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of ``t`` summed over the ranks (not differentiated: a
        count, a normaliser)."""
        t = t.detach().clone()
        dist.all_reduce(t, group=self.group)
        return t

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """An NHWC array of the frame from the even cut into the layout."""
        t = torch.as_tensor(t)
        return self.fetch(t, 2, self.even, self.ranges(self.width), "enter")

    def leave(self, t: torch.Tensor) -> torch.Tensor:
        """An NHWC result at the frame's width from the layout back to the
        even cut."""
        return self.fetch(t, 2, self.ranges(self.width), self.even, "leave")

    # ------------------------------------------------------------- exchanges
    def _exchange(self, sends: Dict[int, torch.Tensor], recvs: Dict[int, Tuple], like: torch.Tensor):
        """Send ``sends[s]`` to rank s and receive a tensor of shape
        ``recvs[s]`` from rank s, for every s, in one batch of point to
        point operations. gloo takes host tensors only: a CUDA tensor is
        staged through host memory."""
        stage = like.is_cuda and self.backend == "gloo"
        ops, bufs = [], {}
        for s in range(self.world):
            if s in sends:
                t = sends[s].contiguous()
                ops.append(dist.P2POp(dist.isend, t.cpu() if stage else t, self.peers[s], self.group))
            if s in recvs:
                bufs[s] = torch.empty(recvs[s], dtype=like.dtype, device="cpu" if stage else like.device)
                ops.append(dist.P2POp(dist.irecv, bufs[s], self.peers[s], self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return {s: b.to(like.device) for s, b in bufs.items()} if stage else bufs

    @staticmethod
    def _shape(like: torch.Tensor, dim: int, n: int) -> Tuple[int, ...]:
        shape = list(like.shape)
        shape[dim] = n
        return tuple(shape)

    def _move(self, x, dim, owned, spans):
        me = self.rank
        (olo, ohi), (slo, shi) = owned[me], spans[me]
        out = x.new_zeros(self._shape(x, dim, shi - slo))
        sends, recvs = {}, {}
        for s in range(self.world):
            a, b = max(spans[s][0], olo), min(spans[s][1], ohi)
            if b > a:
                piece = x.narrow(dim, a - olo, b - a)
                if s == me:
                    out.narrow(dim, a - slo, b - a).copy_(piece)
                else:
                    sends[s] = piece
            a, b = max(slo, owned[s][0]), min(shi, owned[s][1])
            if s != me and b > a:
                recvs[s] = (a, b)
        got = self._exchange(sends, {s: self._shape(x, dim, b - a) for s, (a, b) in recvs.items()}, x)
        for s, (a, b) in recvs.items():
            out.narrow(dim, a - slo, b - a).copy_(got[s])
        return out

    def _move_back(self, g, dim, owned, spans, local):
        me = self.rank
        (olo, ohi), (slo, shi) = owned[me], spans[me]
        grad = g.new_zeros(local)
        sends, recvs = {}, {}
        for s in range(self.world):
            a, b = max(slo, owned[s][0]), min(shi, owned[s][1])
            if b > a:
                piece = g.narrow(dim, a - slo, b - a)
                if s == me:
                    grad.narrow(dim, a - olo, b - a).add_(piece)
                else:
                    sends[s] = piece
            a, b = max(spans[s][0], olo), min(spans[s][1], ohi)
            if s != me and b > a:
                recvs[s] = (a, b)
        got = self._exchange(sends, {s: self._shape(g, dim, b - a) for s, (a, b) in recvs.items()}, g)
        for s, (a, b) in recvs.items():
            grad.narrow(dim, a - olo, b - a).add_(got[s])
        return grad

    # ----------------------------------------------------------------- helpers
    def full_width(self, fn, src: torch.Tensor, off: torch.Tensor, tag: str) -> torch.Tensor:
        """A warp of NCHW ``src`` by the ``[B,1,H,w]`` offset ``off``, on
        the rank's columns: the source fetched whole, the offset placed at
        the rank's columns of the full width (zeros elsewhere), ``fn`` run
        unsharded at the full width and its result sliced."""
        w = self.global_width(src.shape[3])
        lo, hi = self.range(w)
        full = self.gather(src, 3, tag)
        off_full = torch.nn.functional.pad(off, (lo, w - hi))
        with sharded(None):
            out = fn(full, off_full)
        return out[..., lo:hi]
