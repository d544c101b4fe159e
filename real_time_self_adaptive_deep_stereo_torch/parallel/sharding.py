"""Device meshes and placements over a ``torch.distributed`` process group.

Port of ``real_time_self_adaptive_deep_stereo_tpu/parallel/sharding.py``.
The JAX package builds a ``Mesh`` over the chips of one program and lets
GSPMD place arrays by ``NamedSharding``. Here every rank is a process of
its own, holding only its piece of an array: a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over an initialized process
group, a sharding is the mesh with one DTensor placement per mesh axis
(:class:`NamedSharding`), and :func:`shard_batch` cuts this rank's piece
out of a global batch, where the JAX function device-puts the whole
batch with a sharding.

The frames are NHWC, the JAX layout: the batch is axis 0 and the width
axis 2.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Placement, Replicate, Shard

__all__ = [
    "NamedSharding",
    "make_mesh",
    "replicated",
    "batch_sharded",
    "width_sharded",
    "local_slice",
    "shard_batch",
]


class NamedSharding(NamedTuple):
    """A mesh and one placement per mesh axis, in the mesh's axis order."""

    mesh: DeviceMesh
    placements: Tuple[Placement, ...]


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data",),
    mesh_shape: Optional[Sequence[int]] = None,
    device_type: str = "cuda",
) -> DeviceMesh:
    """A mesh over the ranks of the initialized default process group,
    each rank one device of ``device_type`` (``cuda`` or ``cpu``).

    With one axis the mesh is 1-D over all ranks; ``n_devices``, where
    given, must be the group's size (a rank holds one device and no rank
    stays out). For several axes pass ``mesh_shape``, whose product is the
    number of ranks. Raises where no group is initialized: a caller starts
    one first (``torchrun`` and ``init_process_group``, or a ``gloo`` group
    of its own processes)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialized process group: call "
            "torch.distributed.init_process_group first (torchrun sets its environment)"
        )
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"n_devices={n_devices}, but the process group has {world} ranks")
    if mesh_shape is None:
        if len(axis_names) != 1:
            raise ValueError("mesh_shape required for multi-axis meshes")
        mesh_shape = (world,)
    if int(np.prod(mesh_shape)) != world:
        raise ValueError(f"mesh_shape {tuple(mesh_shape)} does not cover the {world} ranks")
    return init_device_mesh(device_type, tuple(int(n) for n in mesh_shape), mesh_dim_names=tuple(axis_names))


def _on_axis(mesh: DeviceMesh, axis: str, placement: Placement) -> NamedSharding:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r} (axes {names})")
    return NamedSharding(
        mesh, tuple(placement if name == axis else Replicate() for name in names)
    )


def replicated(mesh: DeviceMesh) -> NamedSharding:
    """Every rank holds the whole array."""
    return NamedSharding(mesh, tuple(Replicate() for _ in range(mesh.ndim)))


def batch_sharded(mesh: DeviceMesh, axis: str = "data") -> NamedSharding:
    """NHWC batch axis sharded over the mesh axis ``axis``."""
    return _on_axis(mesh, axis, Shard(0))


def width_sharded(mesh: DeviceMesh, axis: str = "data") -> NamedSharding:
    """NHWC width axis sharded over the mesh axis ``axis`` (spatial
    parallelism)."""
    return _on_axis(mesh, axis, Shard(2))


def local_slice(length: int, parts: int, index: int) -> slice:
    """Piece ``index`` of ``parts`` of an axis of ``length``, as
    ``torch.chunk`` and DTensor's ``Shard`` cut it: contiguous pieces of
    ``ceil(length / parts)``, the last ones shorter or empty."""
    size = -(-length // parts)
    start = min(index * size, length)
    return slice(start, min(start + size, length))


def _local(x, sharding: NamedSharding):
    mesh = sharding.mesh
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    for dim, placement in enumerate(sharding.placements):
        if isinstance(placement, Shard):
            ax = placement.dim
            cut = local_slice(x.shape[ax], mesh.size(dim), coord[dim])
            x = x[(slice(None),) * ax + (cut,)]
    return x


def shard_batch(batch, sharding: NamedSharding):
    """This rank's piece of every array leaf (numpy or torch, at least one
    axis) of ``batch``, a dict or list of them nested at will; pieces are
    views, on the device of the leaf. Scalars and non-arrays pass
    through."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, sharding) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, sharding) for v in batch)
    if isinstance(batch, (np.ndarray, torch.Tensor)) and batch.ndim >= 1:
        return _local(batch, sharding)
    return batch
