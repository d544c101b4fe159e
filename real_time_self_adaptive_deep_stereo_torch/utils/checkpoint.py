"""npz checkpoints and the JAX <-> PyTorch weight converter.

``flatten_params``, ``unflatten_params``, ``save_params``,
``load_params``, ``latest_checkpoint``, ``save_step_checkpoint`` and
``restore_or_init`` are ports of
``real_time_self_adaptive_deep_stereo_tpu/utils/checkpoint.py``: a flat
``.npz`` of ``path/to/leaf`` -> array in the JAX layout, so a file saved
by either package loads in the other. ``tf1_checkpoint_to_params``
ports the JAX package's TF1 importer, and ``restore_or_init`` reads a
reference TF1 checkpoint where the JAX one does. The JAX function reads it
through TensorFlow, which the GPU's machine lacks; here
:func:`read_tf1_checkpoint` parses TensorFlow's V2 tensor bundle with
numpy alone (see its docstring for the format).

The JAX package keeps conv weights as HWIO under leaf ``w`` and biases
under ``b``; a PyTorch ``state_dict`` keeps OIHW ``weight`` and ``bias``
under dotted keys. :func:`params_from_jax` maps the first to the second
and :func:`params_to_jax` back.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "flatten_params",
    "unflatten_params",
    "save_params",
    "load_params",
    "latest_checkpoint",
    "save_step_checkpoint",
    "restore_or_init",
    "read_tf1_checkpoint",
    "tf1_checkpoint_to_params",
    "params_from_jax",
    "params_to_jax",
]

Tree = Any


def flatten_params(tree: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_params(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_params(flat: Dict[str, np.ndarray]) -> Tree:
    root: Dict = {}
    for key, val in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def save_params(path: str, params: Tree) -> None:
    flat = flatten_params(params)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)


def load_params(path: str, dtype=None) -> Tree:
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        flat = {k: (data[k].astype(dtype) if dtype else data[k]) for k in data.files}
    return unflatten_params(flat)


_CKPT_RE = re.compile(r"weights-(\d+)\.npz$")


def latest_checkpoint(logdir: str) -> Optional[Tuple[str, int]]:
    """Find the newest step-numbered checkpoint in ``logdir``."""
    if not os.path.isdir(logdir):
        return None
    best = None
    for f in os.listdir(logdir):
        m = _CKPT_RE.search(f)
        if m:
            step = int(m.group(1))
            if best is None or step > best[1]:
                best = (os.path.join(logdir, f), step)
    return best


def save_step_checkpoint(
    logdir: str, state_dict: Dict[str, torch.Tensor], step: int, keep: int = 2
) -> str:
    """Save the port's ``state_dict`` as ``weights-{step}.npz`` in the JAX
    layout (:func:`params_to_jax`), keeping only the ``keep`` newest
    (reference keeps max_to_keep=2, Train.py:114)."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"weights-{step}.npz")
    save_params(path, params_to_jax(state_dict))
    ckpts = sorted(
        (
            (int(_CKPT_RE.search(f).group(1)), f)
            for f in os.listdir(logdir)
            if _CKPT_RE.search(f)
        )
    )
    for _, f in ckpts[:-keep]:
        os.remove(os.path.join(logdir, f))
    return path


def restore_or_init(
    logdir: str,
    params: Tree,
    initial_weights: Optional[str] = None,
    model=None,
) -> Tuple[Tree, bool, int]:
    """Resume-from-logdir if a checkpoint exists, else load
    ``initial_weights`` (native .npz, or a TF1 checkpoint read into
    ``params`` by :func:`tf1_checkpoint_to_params` through ``model``'s
    ``tf_name_map()``), else keep ``params``. Returns (params, restored?,
    step) like weights_utils.py:41-75; restored parameters are a JAX-layout
    tree (:func:`params_from_jax` makes a ``state_dict`` of it)."""
    found = latest_checkpoint(logdir)
    if found:
        path, step = found
        return load_params(path), True, step
    if initial_weights:
        if initial_weights.endswith(".npz") or os.path.exists(initial_weights + ".npz"):
            return load_params(initial_weights), True, 0
        if model is not None:
            restored, n = tf1_checkpoint_to_params(initial_weights, model, params)
            return restored, n > 0, 0
    return params, False, 0


# ------------------------------------------------------------- TF1 import
#
# TensorFlow's V2 checkpoint ("tensor bundle", tensorflow/core/util/
# tensor_bundle/) is ``<prefix>.index``, an SSTable in LevelDB's table
# format, and ``<prefix>.data-0000k-of-0000n``, the tensors' raw bytes.
# The SSTable ends in a 48-byte footer: two block handles (varint offset,
# varint size: the metaindex block's, then the index block's), zero
# padding, and the 8-byte magic below. The index block maps keys to the
# handles of data blocks; every block holds prefix-compressed entries
# (varint shared, non_shared and value lengths, the key's new bytes, the
# value), then an array of uint32 restart offsets and their uint32 count,
# and is followed by a 5-byte trailer: a compression byte and a CRC. In a
# data block, key "" holds the BundleHeaderProto and every other key is a
# variable's name, whose value is a BundleEntryProto (tensor_bundle.proto).

_TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER_BYTES = 48
# DataType (tensorflow/core/framework/types.proto) -> numpy; bfloat16 has
# no numpy type and is widened from its 16 bits
_TF_DTYPES = {1: np.dtype("<f4"), 3: np.dtype("<i4"), 9: np.dtype("<i8"), 14: "bfloat16",
              19: np.dtype("<f2")}
_TF_DTYPE_NAMES = {1: "float32", 3: "int32", 9: "int64", 14: "bfloat16", 19: "float16"}


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _proto_fields(buf: bytes) -> Iterator[Tuple[int, Any]]:
    """(field number, value) of each field of a serialized protobuf
    message: an int for varint and fixed-width fields, bytes for
    length-delimited ones."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _varint(buf, pos)
        elif wire == 1:
            val, pos = int.from_bytes(buf[pos : pos + 8], "little"), pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            val, pos = bytes(buf[pos : pos + n]), pos + n
        elif wire == 5:
            val, pos = int.from_bytes(buf[pos : pos + 4], "little"), pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, val


def _block_handle(buf: bytes, pos: int = 0) -> Tuple[Tuple[int, int], int]:
    offset, pos = _varint(buf, pos)
    size, pos = _varint(buf, pos)
    return (offset, size), pos


def _table_block(table: bytes, handle: Tuple[int, int], path: str) -> bytes:
    offset, size = handle
    if offset + size + 5 > len(table):
        raise ValueError(f"{path}: block handle {handle} beyond the file's {len(table)} bytes")
    if table[offset + size] != 0:
        raise ValueError(
            f"{path}: block at {offset} has compression type {table[offset + size]}; "
            "only uncompressed tables (type 0) are read"
        )
    return table[offset : offset + size]


def _block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    n_restarts = int.from_bytes(block[-4:], "little")
    end = len(block) - 4 * (n_restarts + 1)
    pos, key = 0, b""
    while pos < end:
        shared, pos = _varint(block, pos)
        non_shared, pos = _varint(block, pos)
        n_value, pos = _varint(block, pos)
        key = key[:shared] + bytes(block[pos : pos + non_shared])
        pos += non_shared
        yield key, bytes(block[pos : pos + n_value])
        pos += n_value


def _checkpoint_prefix(path: str) -> str:
    """The bundle prefix of ``path``: the path itself, or for a directory
    the ``model_checkpoint_path`` of its ``checkpoint`` file, as
    ``tf.train.load_checkpoint`` resolves it."""
    if os.path.isdir(path):
        state = os.path.join(path, "checkpoint")
        if not os.path.exists(state):
            raise FileNotFoundError(f"{path}: a directory without a 'checkpoint' file")
        with open(state) as f:
            m = re.search(r'^model_checkpoint_path:\s*"(.*)"', f.read(), re.M)
        if not m:
            raise ValueError(f"{state}: no model_checkpoint_path")
        path = m.group(1) if os.path.isabs(m.group(1)) else os.path.join(path, m.group(1))
    if not os.path.exists(path + ".index"):
        if os.path.isfile(path):
            raise ValueError(f"{path}: a V1 checkpoint (no .index); only V2 tensor bundles are read")
        raise FileNotFoundError(f"no TF checkpoint at {path} ({path}.index is missing)")
    return path


def read_tf1_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """{variable name: array} of the TensorFlow V2 checkpoint at ``path``
    (the prefix ``tf.compat.v1.train.Saver`` returns, or a directory with a
    ``checkpoint`` file), read with numpy alone: no TensorFlow. Reads
    uncompressed, little-endian bundles of unsliced float32, float16,
    bfloat16 (widened to float32), int32 and int64 tensors, each entry's
    ``size`` checked against its shape and dtype; raises on anything else
    (a compressed block, a V1 checkpoint, sliced entries, another dtype)."""
    prefix = _checkpoint_prefix(path)
    index_path = prefix + ".index"
    with open(index_path, "rb") as f:
        table = f.read()
    if len(table) < _FOOTER_BYTES or int.from_bytes(table[-8:], "little") != _TABLE_MAGIC:
        raise ValueError(f"{index_path}: not an SSTable (bad footer magic)")
    footer = table[-_FOOTER_BYTES:]
    _, pos = _block_handle(footer)  # the metaindex block: empty in a bundle
    index_handle, _ = _block_handle(footer, pos)
    entries: Dict[str, bytes] = {}
    for _, handle in _block_entries(_table_block(table, index_handle, index_path)):
        block = _table_block(table, _block_handle(handle)[0], index_path)
        entries.update((key.decode(), value) for key, value in _block_entries(block))
    if "" not in entries:
        raise ValueError(f"{index_path}: no bundle header")
    header = dict(_proto_fields(entries.pop("")))
    num_shards = header.get(1, 1)
    if header.get(2, 0) != 0:
        raise ValueError(f"{index_path}: a big-endian bundle")
    shards: Dict[int, bytes] = {}
    out: Dict[str, np.ndarray] = {}
    for name, value in sorted(entries.items()):
        dtype_code, dims, shard, offset, size = 1, [], 0, 0, 0
        for field, val in _proto_fields(value):
            if field == 1:
                dtype_code = val
            elif field == 2:  # TensorShapeProto: dim (2) -> size (1)
                dims = [dict(_proto_fields(d)).get(1, 0) for f2, d in _proto_fields(val) if f2 == 2]
            elif field == 3:
                shard = val
            elif field == 4:
                offset = val
            elif field == 5:
                size = val
            elif field == 7:
                raise ValueError(f"{index_path}: {name} is stored in slices, which are not read")
        if dtype_code not in _TF_DTYPES:
            raise ValueError(
                f"{index_path}: {name} has TF dtype {dtype_code}; only "
                f"{sorted(_TF_DTYPE_NAMES.values())} are read"
            )
        dtype = _TF_DTYPES[dtype_code]
        itemsize = 2 if dtype == "bfloat16" else dtype.itemsize
        count = int(np.prod(dims, dtype=np.int64))
        if size != count * itemsize:
            raise ValueError(
                f"{index_path}: {name} holds {size} bytes, but shape {dims} of "
                f"{_TF_DTYPE_NAMES[dtype_code]} needs {count * itemsize}"
            )
        if shard not in shards:
            with open(f"{prefix}.data-{shard:05d}-of-{num_shards:05d}", "rb") as f:
                shards[shard] = f.read()
        raw = shards[shard][offset : offset + size]
        if len(raw) != size:
            raise ValueError(f"{index_path}: {name} runs past the end of shard {shard}")
        if dtype == "bfloat16":
            arr = (np.frombuffer(raw, "<u2").astype(np.uint32) << 16).view(np.float32)
        else:
            arr = np.frombuffer(raw, dtype).astype(dtype.newbyteorder("="))
        out[name] = arr.reshape(dims)
    return out


def tf1_checkpoint_to_params(
    ckpt_path: str,
    model,
    base_params: Tree,
    mask: Iterable[str] = (),
    prefix: str = "",
    ignore_list: Iterable[str] = (),
) -> Tuple[Tree, int]:
    """Load a reference TF1 checkpoint into a JAX-layout param tree (port
    of the JAX package's ``tf1_checkpoint_to_params``, reading the file
    with :func:`read_tf1_checkpoint`).

    ``mask`` skips graph-side names containing any substring; ``prefix``
    is prepended to checkpoint names before matching; ``ignore_list``
    substrings are stripped from checkpoint names — the exact renaming
    hooks of weights_utils.get_var_to_restore_list. Names are matched by
    ``model.tf_name_map()``. Returns (new_params, number_of_restored_leaves).
    """
    tensors = read_tf1_checkpoint(ckpt_path)
    name_map = {
        name: path for name, path in model.tf_name_map().items() if not any(m in name for m in mask)
    }
    flat = flatten_params(base_params)
    restored = 0
    for ckpt_name, value in tensors.items():
        t_key = ckpt_name
        for ig in ignore_list:
            t_key = t_key.replace(ig, "")
        target = prefix + t_key
        if target in name_map:
            path = "/".join(name_map[target])
            if path in flat:
                if tuple(value.shape) != tuple(flat[path].shape):
                    raise ValueError(
                        f"shape mismatch for {ckpt_name}: ckpt {value.shape} vs model {flat[path].shape}"
                    )
                flat[path] = value.astype(flat[path].dtype)
                restored += 1
    return unflatten_params(flat), restored


_LEAF_TO_TORCH = {"w": "weight", "b": "bias"}
_LEAF_TO_JAX = {v: k for k, v in _LEAF_TO_TORCH.items()}


def params_from_jax(params: Tree) -> Dict[str, torch.Tensor]:
    """JAX parameters (a nested pytree of arrays, or its flat
    ``a/b/w`` form) -> a ``state_dict``: HWIO weights become OIHW, biases
    are copied as they are."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in flatten_params(params).items():  # a flat dict flattens to itself
        *path, leaf = key.split("/")
        if leaf not in _LEAF_TO_TORCH:
            raise KeyError(f"unexpected parameter leaf {key!r} (want .../w or .../b)")
        arr = np.asarray(val, dtype=np.float32)
        if leaf == "w":
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        out[".".join([*path, _LEAF_TO_TORCH[leaf]])] = torch.tensor(np.ascontiguousarray(arr))
    return out


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Tree:
    """Inverse of :func:`params_from_jax`: a nested tree of numpy arrays
    in the JAX layout, ready for :func:`save_params`."""
    flat = {}
    for key, val in state_dict.items():
        *path, leaf = key.split(".")
        arr = val.detach().cpu().numpy()
        if leaf == "weight":
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        flat["/".join([*path, _LEAF_TO_JAX[leaf]])] = np.ascontiguousarray(arr)
    return unflatten_params(flat)
