"""The fused session's block switch: the sampled blocks' branch picked on
the device, inside one CUDA graph.

The JAX fused session trains the sampled block by ``jax.lax.switch(
blocks_now[0], branches, ...)`` inside its one compiled program
(``real_time_self_adaptive_deep_stereo_tpu/adapt/fused.py:495-509``).
The port captures one CUDA graph per branch, the step that trains one
sorted set of ``m`` of the ``n`` blocks (``branch_sets``: ``C(n, m)`` of
them, since a draw's ids are distinct), and :class:`GraphSwitch` runs
them as the bodies of a conditional node of a parent graph, whose switch
kernel (``csrc/graph_switch.cu``) reads the sampled ids on the device and
sets the node's value. A frame is then one launch, and the host never
reads the ids.

The kernel's function is the lookup :func:`switch_index_torch`, its plain
version: the bitmask of the ids, then ``branch_table``'s entry for it, -1
where the ids name no branch (an id out of range or repeated). On a CPU
device there is no graph: the session reads the ids and picks the branch
on the host through that plain lookup, and a :class:`GraphSwitch` refuses
any device but CUDA.
"""

from __future__ import annotations

import ctypes
import itertools
from typing import List, Sequence, Tuple

import torch

from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

__all__ = ["MAX_BLOCKS", "GraphSwitch", "branch_sets", "branch_table", "switch_index_torch"]

MAX_BLOCKS = 16  # the table has 2**n entries


def branch_sets(n: int, m: int) -> List[Tuple[int, ...]]:
    """The branches of ``m`` sampled blocks out of ``n``: the sorted
    ``m``-subsets, in lexicographic order; branch k is the k-th."""
    return list(itertools.combinations(range(n), m))


def branch_table(n: int, m: int, device=None) -> torch.Tensor:
    """int32 ``[2**n]``: the index of the branch whose blocks are the set
    bits of each mask, -1 for a mask of another number of bits."""
    if not 1 <= m <= n <= MAX_BLOCKS:
        raise ValueError(f"a switch takes 1 <= num_blocks <= blocks <= {MAX_BLOCKS}, got {m} of {n}")
    table = torch.full((1 << n,), -1, dtype=torch.int32)
    for k, ks in enumerate(branch_sets(n, m)):
        table[sum(1 << b for b in ks)] = k
    return table.to(device)


def switch_index_torch(blocks: torch.Tensor, table: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of the switch kernel's lookup: ``blocks`` ``[..., m]``
    int ids to the int32 branch index ``[...]`` (-1: no branch)."""
    ids = blocks.long()
    bits = torch.arange(n, device=ids.device)
    valid = ((ids >= 0) & (ids < n)).all(-1)
    hit = (ids.unsqueeze(-1) == bits).any(-2)  # [..., n]: the OR of the ids' bits
    mask = (hit.long() << bits).sum(-1)
    # index_select: a 0-d index tensor would be read on the host
    branch = table.long().index_select(0, mask.reshape(-1)).reshape(mask.shape)
    return torch.where(valid, branch, -1).to(torch.int32)


class GraphSwitch:
    """A parent CUDA graph of slots run in order, slot ``s`` a switch
    kernel that reads ``blocks[s]`` (int32 ``[m]`` ids on the device) and
    then a conditional node whose body ``k`` is ``bodies[s][k]`` (the raw
    ``cudaGraph_t`` of a graph captured with ``keep_graph=True``, as an
    int). The caller keeps the captured graphs, ``blocks`` and ``table``
    alive while the switch lives: the parent addresses their memory. The
    conditional is a SWITCH node, which needs CUDA 12.8 or later.

    ``launch`` counts one ``graph_switch`` launch a slot. The branches'
    own launches happen on the device; :meth:`taken` reads how often each
    ran since its last call (a host sync) and raises if a launch found ids
    with no branch, where it ran none."""

    def __init__(self, bodies: Sequence[Sequence[int]], blocks: Sequence[torch.Tensor], n: int,
                 table: torch.Tensor):
        self._handle = None
        self.device = table.device
        if self.device.type != "cuda":
            raise ValueError("a graph switch runs on a CUDA device")
        self.n_slots, self.n_branches = len(bodies), len(bodies[0])
        m = blocks[0].numel()
        ids_ok = all(
            t.dtype == torch.int32 and t.device == self.device and t.numel() == m and t.is_contiguous()
            for t in blocks
        )
        if not (ids_ok and len(blocks) == self.n_slots and all(len(b) == self.n_branches for b in bodies)
                and table.dtype == torch.int32 and table.numel() == 1 << n):
            raise ValueError("graph switch: bodies [slots][branches], int32 [m] blocks a slot and a [2**n] "
                             "table, all on the device")
        lib = cuda_lib.library("graph_switch")
        # the branches taken, slot-major, then the count of ids with no branch
        self.status = torch.zeros(self.n_slots * self.n_branches + 1, dtype=torch.int32, device=self.device)
        self._synced = torch.zeros((self.n_slots, self.n_branches), dtype=torch.int64)
        flat = [int(b) for row in bodies for b in row]
        handle, info = ctypes.c_void_p(), (ctypes.c_int * 2)()
        with torch.cuda.device(self.device):
            err = lib.graph_switch_build(
                (ctypes.c_void_p * len(flat))(*flat), self.n_slots, self.n_branches,
                (ctypes.c_void_p * self.n_slots)(*[t.data_ptr() for t in blocks]), m, n, table.data_ptr(),
                self.status.data_ptr(), self.status[-1:].data_ptr(), ctypes.byref(handle), info,
            )
        if err:
            raise RuntimeError(
                f"graph_switch_build: CUDA error {err} "
                f"({lib.kernel_error_string(err).decode()}); cudaGraphInstantiateResult {info[0]}, "
                f"refused node type {info[1]} (-1: none named)"
            )
        self._handle = handle
        self._lib = lib
        self._keep = (list(blocks), table)

    def launch(self) -> None:
        """One launch of the parent on the current stream."""
        err = self._lib.graph_switch(self._handle, cuda_lib.stream_ptr(self.device))
        cuda_lib.check(self._lib, err, "graph_switch")
        cuda_lib.LAUNCHES["graph_switch"] += self.n_slots

    def taken(self) -> torch.Tensor:
        """``[slots, branches]`` int64: the launches of each branch since
        the last call. Waits for the device."""
        host = self.status.cpu()
        if int(host[-1]):
            raise RuntimeError(
                f"graph switch: {int(host[-1])} switch(es) found sampled ids that name no branch "
                "and ran no step"
            )
        counts = host[:-1].view(self.n_slots, self.n_branches).long()
        new, self._synced = counts - self._synced, counts
        return new

    def close(self) -> None:
        if self._handle is not None:
            self._lib.graph_switch_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
