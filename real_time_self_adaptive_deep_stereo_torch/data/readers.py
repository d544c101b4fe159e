"""Host-side data pipeline: dataset lists, image/PFM decoding, crops,
batching and device prefetch.

Port of ``real_time_self_adaptive_deep_stereo_tpu/data/readers.py``, in
its order:

* CSV lists ``left,right[,gt[,proxy]]`` with ``,``/``;`` separators and
  ``#`` comments;
* PFM ground truth, and 8/16-bit PNG ground truth with the ``/256`` of
  16-bit (KITTI's encoding), width-cropped to the image;
* training: aligned random crop and the photometric ``augment``; eval:
  centred crop-or-pad;
* epoch repeat, shuffling, fixed-size batches, the eval remainder kept;
* a device prefetcher that keeps batches on the card ahead of use.

In the Python backend images are decoded by :mod:`.png` (numpy and
``zlib``), where the JAX package calls ``cv2``; so it takes PNG images and
PNG or PFM ground truth. ``backend="native"`` decodes in the C++ loader of
:mod:`..runtime.native` (threads, in-order delivery; PNG, JPEG where
libjpeg is there, PFM, PGM/PPM), as the JAX package does wherever that
loader builds. ``augment``'s hue shift runs matplotlib's RGB/HSV
conversions, copied here in numpy (the GPU's machine may have no
matplotlib).
"""

from __future__ import annotations

import os
import queue
import re
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from real_time_self_adaptive_deep_stereo_torch.data.png import png_size, read_pngs

__all__ = [
    "read_pfm",
    "read_list_file",
    "load_image",
    "load_gt",
    "random_crop",
    "center_crop_or_pad",
    "resize_image_np",
    "augment",
    "StereoDataset",
    "prefetch_to_device",
]


# ----------------------------------------------------------------- decoding


def read_pfm(path: str) -> np.ndarray:
    """Decode a PFM file to a float32 array [H, W, C] (C = 1 or 3)."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file")
        dims = f.readline().split()
        width, height = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f4")
    img = data.reshape(height, width, channels)
    return np.flipud(img).astype(np.float32)


def read_list_file(path_file: str) -> Tuple[List[str], List[str], List[str], List[str]]:
    """Parse a dataset list: one sample per line, fields separated by
    ',' or ';', '#' starts a comment line. Returns (left, right, gt, extra)."""
    with open(path_file) as f:
        lines = [l.strip() for l in f.readlines()]
    lines = [l for l in lines if l and not l.startswith("#")]
    cols: List[List[str]] = [[], [], [], []]
    for line in lines:
        fields = re.split("[,;]", line)
        for i in range(4):
            if i < len(fields):
                cols[i].append(fields[i].strip())
    return cols[0], cols[1], cols[2], cols[3]


def _as_image(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    return img[..., :3].astype(np.float32)


def _as_gt(raw: np.ndarray) -> np.ndarray:
    if raw.ndim == 3:
        raw = raw[..., 0]
    d = raw.astype(np.float32)[..., None]
    if raw.dtype == np.uint16:
        d = d / 256.0
    return d


def load_image(path: str) -> np.ndarray:
    """RGB image as float32 [H, W, 3] in 0..255."""
    return _as_image(read_pngs([path])[0])


def load_gt(path: str) -> np.ndarray:
    """Ground-truth / proxy disparity as float32 [H, W, 1].

    PFM read natively; 16-bit PNGs are divided by 256 (KITTI encoding),
    8-bit used raw."""
    if path.lower().endswith(".pfm"):
        return read_pfm(path)[..., :1]
    return _as_gt(read_pngs([path])[0])


# -------------------------------------------------------------------- crops


def random_crop(
    crop_shape: Sequence[int], tensors: List[np.ndarray], rng: np.random.Generator
) -> List[np.ndarray]:
    """Aligned random crop (preprocessing.py:31-56)."""
    ch, cw = crop_shape
    r0, c0 = _crop_origin(crop_shape, *tensors[0].shape[:2], rng)
    return [t[r0 : r0 + ch, c0 : c0 + cw] for t in tensors]


def _crop_origin(crop_shape: Sequence[int], h: int, w: int, rng: np.random.Generator) -> Tuple[int, int]:
    """The top-left corner of :func:`random_crop`'s crop of an ``h x w``
    image: its two draws from ``rng``."""
    ch, cw = crop_shape
    max_row = max(h - ch - 1, 1)
    max_col = max(w - cw - 1, 1)
    return int(rng.integers(0, max_row)), int(rng.integers(0, max_col))


def center_crop_or_pad(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    """Centered crop/zero-pad to (th, tw), numpy version of
    tf.image.resize_image_with_crop_or_pad."""
    h, w = img.shape[:2]
    if h > th:
        off = (h - th) // 2
        img = img[off : off + th]
    if w > tw:
        off = (w - tw) // 2
        img = img[:, off : off + tw]
    h, w = img.shape[:2]
    if h < th or w < tw:
        ph, pw = th - h, tw - w
        img = np.pad(
            img, ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2), (0, 0))
        )
    return img


def resize_image_np(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Host-side bilinear resize with TF1-legacy semantics ([H,W,C]), on
    the interpolation matrices of ``ops.resize``. An integer image comes
    back as float32, unrounded, as the network is fed."""
    from real_time_self_adaptive_deep_stereo_torch.ops.resize import _interp_matrix

    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img
    x = img.astype(np.float32)
    if h != out_h:
        x = np.einsum("oh,hwc->owc", _interp_matrix(h, out_h), x)
    if w != out_w:
        x = np.einsum("ow,hwc->hoc", _interp_matrix(w, out_w), x)
    if np.issubdtype(img.dtype, np.integer):
        return x
    return x.astype(img.dtype)


# ------------------------------------------------------------- augmentation
# _rgb_to_hsv and _hsv_to_rgb are matplotlib's (matplotlib/colors.py,
# rgb_to_hsv and hsv_to_rgb), step for step, in the input's float dtype
# (at least float32), without its range checks.


def _rgb_to_hsv(arr: np.ndarray) -> np.ndarray:
    """[..., 3] RGB in [0, 1] -> HSV in [0, 1]."""
    arr = np.asarray(arr)
    in_shape = arr.shape
    arr = np.array(arr, dtype=np.promote_types(arr.dtype, np.float32), ndmin=2)
    out = np.zeros_like(arr)
    arr_max = arr.max(-1)
    ipos = arr_max > 0
    delta = np.ptp(arr, -1)
    s = np.zeros_like(delta)
    s[ipos] = delta[ipos] / arr_max[ipos]
    ipos = delta > 0
    idx = (arr[..., 0] == arr_max) & ipos  # red is max
    out[idx, 0] = (arr[idx, 1] - arr[idx, 2]) / delta[idx]
    idx = (arr[..., 1] == arr_max) & ipos  # green is max
    out[idx, 0] = 2.0 + (arr[idx, 2] - arr[idx, 0]) / delta[idx]
    idx = (arr[..., 2] == arr_max) & ipos  # blue is max
    out[idx, 0] = 4.0 + (arr[idx, 0] - arr[idx, 1]) / delta[idx]
    out[..., 0] = (out[..., 0] / 6.0) % 1.0
    out[..., 1] = s
    out[..., 2] = arr_max
    return out.reshape(in_shape)


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """[..., 3] HSV in [0, 1] -> RGB in [0, 1]."""
    hsv = np.asarray(hsv)
    in_shape = hsv.shape
    hsv = np.array(hsv, dtype=np.promote_types(hsv.dtype, np.float32), ndmin=2)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    r, g, b = np.empty_like(h), np.empty_like(h), np.empty_like(h)
    i = (h * 6.0).astype(int)
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    # (sector, (r, g, b)) in matplotlib's order; s == 0 (grey) last
    for idx, (rr, gg, bb) in (
        (i % 6 == 0, (v, t, p)),
        (i == 1, (q, v, p)),
        (i == 2, (p, v, t)),
        (i == 3, (p, q, v)),
        (i == 4, (t, p, v)),
        (i == 5, (v, p, q)),
        (s == 0, (v, v, v)),
    ):
        r[idx], g[idx], b[idx] = rr[idx], gg[idx], bb[idx]
    return np.stack([r, g, b], axis=-1).reshape(in_shape)


def _augment_draws(rng: np.random.Generator):
    """:func:`augment`'s draws from ``rng``: the brightness delta, the
    contrast factor and the hue shift, each None where its op is off."""
    active = rng.random(4)
    brightness = rng.uniform(-0.05, 0.05) if active[1] <= 0.5 else None
    factor = rng.uniform(0.8, 1.2) if active[2] <= 0.5 else None
    delta = rng.uniform(0.8, 1.2) if active[3] <= 0.5 else None
    return brightness, factor, delta


def augment(
    left: np.ndarray, right: np.ndarray, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """Photometric augmentation with the reference's exact distributions
    and gating (preprocessing.py:61-89: each op applies when its uniform
    'active' draw is <= 0.5; brightness delta +-0.05, contrast 0.8..1.2,
    hue 0.8..1.2, taken mod 1 as the reference's shift is). The draws from
    ``rng`` come in the JAX package's order."""
    brightness, factor, delta = _augment_draws(rng)
    left = left.astype(np.float32)
    right = right.astype(np.float32)

    if brightness is not None:
        left = left + brightness
        right = right + brightness
    if factor is not None:

        def contrast(x):
            mean = x.mean(axis=(0, 1), keepdims=True)
            return (x - mean) * factor + mean

        left, right = contrast(left), contrast(right)
    if delta is not None:

        def hue(x):
            hsv = _rgb_to_hsv(np.clip(x / 255.0, 0, 1))
            hsv[..., 0] = (hsv[..., 0] + delta) % 1.0
            return _hsv_to_rgb(hsv) * 255.0

        left, right = hue(left), hue(right)

    return np.clip(left, 0, 255), np.clip(right, 0, 255)


# ------------------------------------------------------------------ dataset


class StereoDataset:
    """Iterable stereo dataset with the reference's epoch/shuffle/batch
    semantics. Yields dict batches of float32 numpy arrays:
    ``left``/``right`` [B,H,W,3], ``target`` [B,H,W,1] and, when a 4th
    CSV column exists and ``load_proxy``, ``proxy`` [B,H,W,1] plus
    ``real_width`` [B]. ``backend``: ``native``, the C++ loader with
    ``num_workers`` threads (at least 2) and 8 samples ahead, whose
    training crops draw from per-sample seeds ``(seed << 20) + n``;
    ``python``, one background thread, which draws the shuffle, then each
    frame's crop and ``augment`` from one ``rng``; ``auto``, ``native``
    where the loader builds and ``augment`` is off (augmentation is
    Python's), else ``python``. Either way in the JAX package's order.
    ``backend`` keeps the one taken.

    ``shard=(index, parts)`` (training only) yields piece ``index`` of
    ``parts`` of every batch of ``batch_size``, the piece rank ``index``
    of a data-parallel run trains on (``parallel.local_slice``'s cut): it
    draws the same shuffle, crops and augmentation as the whole batch but
    decodes only its own frames, so the pieces of all ranks make up the
    batches of one process."""

    def __init__(
        self,
        path_file: str,
        batch_size: int = 4,
        crop_shape: Sequence[int] = (320, 1216),
        num_epochs: Optional[int] = None,
        augment: bool = False,
        is_training: bool = True,
        shuffle: bool = True,
        load_proxy: bool = False,
        seed: Optional[int] = None,
        num_workers: int = 2,
        backend: str = "auto",
        shard: Optional[Tuple[int, int]] = None,
    ):
        if backend not in ("auto", "python", "native"):
            raise ValueError(f"unknown backend {backend!r}")
        self.keep = range(batch_size)  # the positions of a batch this dataset decodes
        if shard is not None:
            index, parts = shard
            if not is_training:
                raise ValueError("shard cuts training batches; an eval set is read whole")
            if batch_size % parts:
                raise ValueError(f"a batch of {batch_size} does not split evenly over {parts} ranks")
            size = batch_size // parts
            self.keep = range(index * size, (index + 1) * size)
        if backend == "native" and augment:
            raise ValueError("augment runs in Python: take backend 'python' or 'auto' with it")
        if not os.path.exists(path_file):
            raise FileNotFoundError(f"dataset list not found: {path_file}")
        left, right, gt, extra = read_list_file(path_file)
        self.samples = list(zip(left, right, gt))
        self.proxies = extra if (load_proxy and extra) else None
        self.batch_size = batch_size
        self.crop_shape = tuple(crop_shape)
        self.num_epochs = num_epochs
        self.is_training = is_training
        self.augment = augment
        self.shuffle = shuffle
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.num_workers = max(1, num_workers)
        self.backend = backend
        if backend == "auto":
            from real_time_self_adaptive_deep_stereo_torch.runtime import native

            self.backend = "native" if (native.available() and not augment) else "python"

    def __len__(self) -> int:
        return len(self.samples)

    def decoding(self) -> str:
        """How the frames are decoded, for a CLI to print once."""
        if self.backend == "native":
            from real_time_self_adaptive_deep_stereo_torch.runtime import native

            return f"the native loader, {max(2, self.num_workers)} threads ({native.route()})"
        return "Python, one thread (data/png.py)"

    def get_max_steps(self) -> int:
        epochs = self.num_epochs if self.num_epochs else 1
        return (len(self) * epochs) // self.batch_size

    def get_couples(self):
        return [list(s) for s in self.samples]

    # ---------------------------------------------------------- item loading
    def _load_one(self, idx: int) -> Dict[str, np.ndarray]:
        lp, rp, gp = self.samples[idx]
        pngs = [lp, rp] + ([gp] if gp and not gp.lower().endswith(".pfm") else [])
        decoded = read_pngs(pngs)  # the frame's PNGs in one sweep
        left, right = _as_image(decoded[0]), _as_image(decoded[1])
        if not gp:
            gt = np.zeros((*left.shape[:2], 1), np.float32)
        else:
            gt = _as_gt(decoded[2]) if len(decoded) == 3 else load_gt(gp)
        gt = gt[:, : left.shape[1]]  # width-align (data_reader.py:145)
        tensors = [left, right, gt]
        real_width = left.shape[1]
        if self.proxies is not None:
            tensors.append(load_gt(self.proxies[idx]))
        if self.is_training:
            tensors = random_crop(self.crop_shape, tensors, self.rng)
        else:
            tensors = [center_crop_or_pad(t, *self.crop_shape) for t in tensors]
        if self.augment:
            tensors[0], tensors[1] = augment(tensors[0], tensors[1], self.rng)
        out = {"left": tensors[0], "right": tensors[1], "target": tensors[2]}
        if self.proxies is not None:
            out["proxy"] = tensors[3]
            out["real_width"] = np.int32(real_width)
        return out

    def _skip_one(self, idx: int) -> None:
        """Draw from ``rng`` what :meth:`_load_one` draws for sample
        ``idx``, without decoding it (another rank's frame)."""
        if self.is_training:
            _crop_origin(self.crop_shape, *png_size(self.samples[idx][0]), self.rng)
        if self.augment:
            _augment_draws(self.rng)

    # ------------------------------------------------------------- iteration
    def _index_stream(self) -> Iterator[int]:
        epoch = 0
        while self.num_epochs is None or epoch < self.num_epochs:
            order = np.arange(len(self.samples))
            if self.shuffle:
                self.rng.shuffle(order)
            yield from order
            epoch += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Yield batches, decoded by the C++ loader or in a Python
        background thread. A decode error is raised here, in the consumer."""
        if self.backend == "native":
            yield from self._iter_native()
            return
        q: queue.Queue = queue.Queue(maxsize=8)
        stop = threading.Event()
        failure: List[BaseException] = []

        def producer():
            batch: List[Dict[str, np.ndarray]] = []
            try:
                for n, idx in enumerate(self._index_stream()):
                    if stop.is_set():
                        return
                    pos = n % self.batch_size
                    if pos in self.keep:
                        batch.append(self._load_one(int(idx)))
                    else:
                        self._skip_one(int(idx))
                    if pos == self.batch_size - 1:
                        q.put(self._stack(batch))
                        batch = []
                if batch and not self.is_training:
                    # eval keeps the remainder (continual_data_reader.py:189)
                    q.put(self._stack(batch))
            except BaseException as e:  # handed to the consumer
                failure.append(e)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    if failure:
                        raise failure[0]
                    return
                yield item
        finally:
            stop.set()

    def _iter_native(self) -> Iterator[Dict[str, np.ndarray]]:
        from real_time_self_adaptive_deep_stereo_torch.runtime.native import NativeStereoLoader

        loader = NativeStereoLoader(workers=max(2, self.num_workers), crop_shape=self.crop_shape)
        base_seed = self.seed if self.seed is not None else 0
        # the index stream is read as it is needed: with num_epochs None it
        # has no end (the JAX package's loader lists it first, and hangs)
        indices = self._index_stream()
        try:
            n = 0  # frames of the index stream read, this dataset's or not
            submitted = 0
            delivered = 0
            ends: List[int] = []  # the submitted count at each batch's end, not yet yielded
            batch: List[Dict[str, np.ndarray]] = []
            ahead = 8
            while True:
                while submitted - delivered < ahead:
                    idx = next(indices, None)
                    if idx is None:
                        break
                    pos = n % self.batch_size
                    if pos in self.keep:
                        lp, rp, gp = self.samples[int(idx)]
                        pp = self.proxies[int(idx)] if self.proxies is not None else ""
                        loader.submit(
                            lp, rp, gp or "", pp,
                            train=self.is_training,
                            seed=(base_seed << 20) + n,
                        )
                        submitted += 1
                    if pos == self.batch_size - 1:
                        ends.append(submitted)
                    n += 1
                if delivered == submitted:
                    break
                sample = loader.next()
                delivered += 1
                if self.proxies is None:
                    sample.pop("proxy", None)
                    sample.pop("real_width", None)
                batch.append(sample)
                if ends and delivered == ends[0]:
                    ends.pop(0)
                    yield self._stack(batch)
                    batch = []
            if batch and not self.is_training:
                yield self._stack(batch)
        finally:
            loader.close()

    @staticmethod
    def _stack(batch: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        keys = batch[0].keys()
        return {k: np.stack([b[k] for b in batch]) for k in keys}


def prefetch_to_device(
    iterator: Iterator[Dict[str, np.ndarray]],
    size: int = 2,
    device: Optional[Union[str, torch.device]] = None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Keep ``size`` batches on the device ahead of use. Runs on ``cuda``
    unless ``device='cpu'``. On the card each array goes into a pinned
    host tensor of its own and is copied with ``non_blocking=True``; the
    pinned allocator keeps that buffer from reuse until its copy has run."""
    import collections

    from real_time_self_adaptive_deep_stereo_torch.utils.device import resolve_device

    dev = resolve_device(device)
    buf = collections.deque()
    it = iter(iterator)

    def put(batch):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.asarray(v))
            if dev.type == "cuda":
                t = t.pin_memory().to(dev, non_blocking=True)
            out[k] = t
        return out

    try:
        for _ in range(size):
            buf.append(put(next(it)))
    except StopIteration:
        pass
    while buf:
        out = buf.popleft()
        try:
            buf.append(put(next(it)))
        except StopIteration:
            pass
        yield out
