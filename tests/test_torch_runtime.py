"""The port's native C++ stereo loader (``runtime/``) against the JAX
package's and against the port's Python backend, on the CPU: eval crops
bit for bit on the synthetic list of ``tests/test_data.py`` (PNG images,
16-bit PNG ground truth, PFM proxies) and on the real-frame fixture;
training crops (``seed=1``) equal to the JAX loader's; in-order delivery
from several threads; a decode error raised as ``IOError`` naming the file.
The loader's own PNG decoder, built with ``-DSL_FORCE_OWN_PNG`` on zlib and
with ``-DSL_FORCE_OWN_INFLATE`` on its own inflate, against libpng's route
on the 24 fixture PNGs and on cv2-written files of every filter. Also
``StepTimer`` against the JAX one on a fake clock, and ``FolderGrabber``'s
backpressure and order."""

import glob
import os
import queue
import time

import cv2
import numpy as np
import pytest

from real_time_self_adaptive_deep_stereo_torch.data import readers as tr
from real_time_self_adaptive_deep_stereo_torch.data.png import read_png, write_png
from real_time_self_adaptive_deep_stereo_torch.runtime import native as tnative
from real_time_self_adaptive_deep_stereo_tpu.data import readers as jr
from real_time_self_adaptive_deep_stereo_tpu.runtime import native as jnative

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "realworld")
FIXTURE_PNGS = sorted(glob.glob(os.path.join(FIXTURE, "*.png")))
FILTERS = {
    "none": cv2.IMWRITE_PNG_FILTER_NONE,
    "sub": cv2.IMWRITE_PNG_FILTER_SUB,
    "up": cv2.IMWRITE_PNG_FILTER_UP,
    "avg": cv2.IMWRITE_PNG_FILTER_AVG,
    "paeth": cv2.IMWRITE_PNG_FILTER_PAETH,
    "all": cv2.IMWRITE_PNG_ALL_FILTERS,
}
# the source's own PNG decoder, on zlib and on its own inflate; the second
# build also drops libjpeg, to see a JPEG refused by name
OWN_ROUTES = {
    "own_png_zlib": ("-DSL_FORCE_OWN_PNG",),
    "own_png_inflate": ("-DSL_FORCE_OWN_PNG", "-DSL_FORCE_OWN_INFLATE", "-DSL_FORCE_NO_JPEG"),
}


@pytest.fixture(scope="module", autouse=True)
def loaders_build():
    """Both loaders build here (g++, libpng, libjpeg). The JAX package's
    writes its library next to its source in place, so a test process can
    load one that another is still writing: its load is tried again."""
    for _ in range(5):
        if jnative.available():
            break
        time.sleep(2.0)
        jnative._lib, jnative._build_error = None, None
    for name, native in (("port", tnative), ("JAX", jnative)):
        if not native.available():
            pytest.fail(f"the {name} native loader does not build here: {native.build_error()}")


def _write_pfm(path, data):
    h, w, c = data.shape
    with open(path, "wb") as f:
        f.write(b"PF\n" if c == 3 else b"Pf\n")
        f.write(f"{w} {h}\n-1.0\n".encode())
        np.flipud(data).astype("<f4").tofile(f)


@pytest.fixture(scope="module")
def synthetic_list(tmp_path_factory):
    """tests/test_data.py's four pairs: PNG images, 16-bit PNG GT, PFM proxy."""
    tmp = tmp_path_factory.mktemp("synthetic")
    rng = np.random.default_rng(0)
    lines = []
    for i in range(4):
        left = (rng.random((40, 60, 3)) * 255).astype(np.uint8)
        right = (rng.random((40, 60, 3)) * 255).astype(np.uint8)
        gt = (rng.random((40, 60)) * 50).astype(np.float32)
        lp, rp, gp, pp = (str(tmp / f"{k}{i}.{'pfm' if k == 'p' else 'png'}") for k in "lrgp")
        cv2.imwrite(lp, left[..., ::-1])
        cv2.imwrite(rp, right[..., ::-1])
        cv2.imwrite(gp, (gt * 256).astype(np.uint16))
        _write_pfm(pp, gt[..., None] + 1.0)
        lines.append(f"{lp},{rp},{gp},{pp}")
    path = tmp / "list.csv"
    path.write_text("# comment line\n" + "\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def realworld_list(tmp_path_factory):
    """The real-frame fixture: 320x1216 photographs, 16-bit KITTI ground truth."""
    lines = []
    for lp in sorted(glob.glob(os.path.join(FIXTURE, "*_left.png"))):
        base = lp[: -len("_left.png")]
        lines.append(f"{lp},{base}_right.png,{base}_gt.png")
    path = tmp_path_factory.mktemp("realworld") / "list.csv"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ------------------------------------------------------------ the dataset


@pytest.mark.parametrize("which", ["synthetic", "realworld"])
def test_native_eval_matches_jax_and_python(which, synthetic_list, realworld_list):
    """Eval crops (one a centred crop, one a zero pad) bit for bit: the
    port's loader, the JAX loader and the port's Python backend."""
    path, kw = {
        "synthetic": (synthetic_list, dict(crop_shape=(32, 72), load_proxy=True)),
        "realworld": (realworld_list, dict(crop_shape=(320, 1216))),
    }[which]
    kw.update(batch_size=3, num_epochs=1, is_training=False, shuffle=False)
    got = tr.StereoDataset(path, backend="native", **kw)
    assert got.backend == "native" and "native loader" in got.decoding()
    got = list(got)
    assert_batches_equal(got, list(jr.StereoDataset(path, backend="native", **kw)))
    assert_batches_equal(got, list(tr.StereoDataset(path, backend="python", **kw)))
    assert got[-1]["left"].shape[0] == (1 if which == "synthetic" else 2)  # the eval remainder


def test_native_training_crops_match_jax(synthetic_list):
    """Two shuffled epochs of random crops, seed 1: the same shuffle and the
    same per-sample seeds ``(seed << 20) + n`` as the JAX loader."""
    kw = dict(batch_size=2, crop_shape=(16, 24), num_epochs=2, is_training=True, shuffle=True, seed=1)
    got = list(tr.StereoDataset(synthetic_list, backend="native", **kw))
    assert len(got) == 4 and all(b["left"].shape == (2, 16, 24, 3) for b in got)
    assert_batches_equal(got, list(jr.StereoDataset(synthetic_list, backend="native", **kw)))
    # the crops differ from frame to frame: the seeds are the sample's
    assert len({b["left"][i, 0, 0, 0] for b in got for i in range(2)}) > 1


def test_native_streams_endless_epochs(synthetic_list):
    """``num_epochs=None`` (``cli/train.py``'s validation set) repeats the
    list without end; the loader reads the indices as it needs them. (The
    JAX package's loader lists them all first, and never returns.)"""
    import itertools

    kw = dict(batch_size=3, crop_shape=(16, 24), num_epochs=None, is_training=False, shuffle=False)
    got = list(itertools.islice(iter(tr.StereoDataset(synthetic_list, backend="native", **kw)), 5))
    want = list(itertools.islice(iter(tr.StereoDataset(synthetic_list, backend="python", **kw)), 5))
    assert_batches_equal(got, want)


def test_auto_takes_native_unless_augment(synthetic_list):
    kw = dict(batch_size=1, crop_shape=(16, 24), num_epochs=1)
    assert tr.StereoDataset(synthetic_list, **kw).backend == "native"
    assert tr.StereoDataset(synthetic_list, augment=True, **kw).backend == "python"
    assert tr.StereoDataset(synthetic_list, backend="python", **kw).decoding().startswith("Python")
    with pytest.raises(ValueError, match="augment runs in Python"):
        tr.StereoDataset(synthetic_list, backend="native", augment=True, **kw)
    assert tr.StereoDataset(synthetic_list, **kw).num_workers == 2


def test_native_delivers_in_order_and_raises_a_decode_error(tmp_path):
    """Twelve frames of twelve widths from four threads come back in the
    order they were submitted; a file that is no image fails its own sample
    with an IOError that names it, and the next sample still arrives."""
    rng = np.random.default_rng(5)
    loader = tnative.NativeStereoLoader(workers=4, crop_shape=(8, 40), capacity=14)
    want = []
    try:
        for i in range(12):
            img = (rng.random((8, 20 + i, 3)) * 255).astype(np.uint8)
            p = str(tmp_path / f"f{i}.png")
            write_png(p, img)
            want.append((20 + i, img))
        bad = tmp_path / "bad.png"
        bad.write_bytes(b"not an image at all")
        for i, (w, _) in enumerate(want):
            loader.submit(str(tmp_path / f"f{i}.png"), str(tmp_path / f"f{i}.png"))
        for w, img in want:
            out = loader.next()
            assert int(out["real_width"]) == w
            np.testing.assert_array_equal(out["left"], tr.center_crop_or_pad(img.astype(np.float32), 8, 40))
        loader.submit(str(bad), str(bad))
        loader.submit(str(tmp_path / "f0.png"), str(tmp_path / "f0.png"))
        with pytest.raises(IOError, match="bad.png: not a PNG, JPEG, PFM"):
            loader.next()
        assert int(loader.next()["real_width"]) == 20
    finally:
        loader.close()
    path = tmp_path / "list.csv"
    path.write_text(f"{tmp_path / 'f0.png'},{bad},\n")
    with pytest.raises(IOError, match="bad.png"):
        list(tr.StereoDataset(str(path), batch_size=1, crop_shape=(8, 16), num_epochs=1, is_training=False,
                              backend="native"))


def test_native_aligns_a_wider_ground_truth(tmp_path):
    """A ground truth wider than its image is cut to the image's width, as
    the Python backend cuts it. (The JAX package's loader lowers the width
    alone, and reads such a map with the wrong row stride.)"""
    rng = np.random.default_rng(9)
    write_png(str(tmp_path / "l.png"), (rng.random((12, 20, 3)) * 255).astype(np.uint8))
    write_png(str(tmp_path / "g.png"), (rng.random((12, 27)) * 9000).astype(np.uint16))
    path = tmp_path / "list.csv"
    path.write_text(f"{tmp_path / 'l.png'},{tmp_path / 'l.png'},{tmp_path / 'g.png'}\n")
    kw = dict(batch_size=1, crop_shape=(10, 24), num_epochs=1, is_training=False, shuffle=False)
    assert_batches_equal(list(tr.StereoDataset(str(path), backend="native", **kw)),
                         list(tr.StereoDataset(str(path), backend="python", **kw)))


# ------------------------------------------- the loader's own PNG decoder


def _decode(paths, crop, defines=()):
    """Each file through the loader as left image (RGB, grey replicated,
    alpha dropped) and as ground truth (channel 0, 16-bit / 256), centred
    at ``crop``."""
    loader = tnative.NativeStereoLoader(workers=3, crop_shape=crop, capacity=len(paths), defines=defines)
    try:
        for p in paths:
            loader.submit(p, p, p)
        return [loader.next() for _ in paths]
    finally:
        loader.close()


def _python_decode(path):
    raw = read_png(path)
    grey = raw if raw.ndim == 2 else raw[..., 0]
    gt = grey.astype(np.float32)[..., None] / (256.0 if raw.dtype == np.uint16 else 1.0)
    img = np.repeat(raw[..., None], 3, -1) if raw.ndim == 2 else raw[..., :3]
    img = img.astype(np.float32) / (256.0 if raw.dtype == np.uint16 else 1.0)
    return img, gt


def _synthetic(kind, rng, h=23, w=37):
    ys, xs = np.mgrid[0:h, 0:w]
    if kind == "grey16":
        return (ys * 1500 + xs * 700 + rng.integers(0, 3000, (h, w))).astype(np.uint16)
    c = {"grey8": 1, "rgb8": 3, "rgba8": 4}[kind]
    img = ((ys * 5 + xs * 3)[..., None] + rng.integers(0, 90, (h, w, c))) % 256
    return img.astype(np.uint8)[..., 0] if c == 1 else img.astype(np.uint8)


@pytest.fixture(scope="module")
def filter_files(tmp_path_factory):
    """cv2-written PNGs of each kind under each filter, and stored (level 0)
    and one-IDAT-per-64-bytes variants."""
    tmp = tmp_path_factory.mktemp("filters")
    paths = []
    for kind in ("grey8", "rgb8", "rgba8", "grey16"):
        for filt, code in FILTERS.items():
            img = _synthetic(kind, np.random.default_rng(len(paths)))
            p = str(tmp / f"{kind}_{filt}.png")
            assert cv2.imwrite(p, img, [cv2.IMWRITE_PNG_FILTER, code])
            paths.append(p)
        for extra, flags in (("stored", [cv2.IMWRITE_PNG_COMPRESSION, 0]),
                             ("split", [cv2.IMWRITE_PNG_ZLIBBUFFER_SIZE, 64])):
            p = str(tmp / f"{kind}_{extra}.png")
            assert cv2.imwrite(p, _synthetic(kind, np.random.default_rng(len(paths))), flags)
            paths.append(p)
    return paths


@pytest.mark.parametrize("route", list(OWN_ROUTES))
def test_own_png_decoder_matches_libpng(route, filter_files):
    """Every fixture PNG and every cv2-written filter file: the own route
    bit for bit equal to libpng's, and to the port's numpy codec."""
    assert len(FIXTURE_PNGS) == 24
    for paths, crop in ((FIXTURE_PNGS, (320, 1216)), (filter_files, (23, 37))):
        want = _decode(paths, crop)
        got = _decode(paths, crop, OWN_ROUTES[route])
        for p, g, w in zip(paths, got, want):
            for k in ("left", "target"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{os.path.basename(p)} {k}")
            img, gt = _python_decode(p)
            np.testing.assert_array_equal(g["left"], img, err_msg=os.path.basename(p))
            np.testing.assert_array_equal(g["target"], gt, err_msg=os.path.basename(p))


def test_own_routes_name_themselves_and_refuse_what_they_do_not_take(tmp_path):
    assert tnative.route() == "PNG by libpng, JPEG by libjpeg"  # this machine has both libraries
    assert tnative.build_error() is None
    palette = str(tmp_path / "palette.png")
    from PIL import Image

    Image.fromarray(np.arange(48, dtype=np.uint8).reshape(6, 8)).convert("P").save(palette)
    jpeg = str(tmp_path / "x.jpg")
    cv2.imwrite(jpeg, np.zeros((6, 8, 3), np.uint8))
    for route, defines in OWN_ROUTES.items():
        for path, why in ((palette, "colour type 3 is not supported"),
                          (jpeg, None if route == "own_png_zlib" else "JPEG needs jpeglib.h")):
            loader = tnative.NativeStereoLoader(workers=1, crop_shape=(6, 8), defines=defines)
            try:
                loader.submit(path, path)
                if why is None:
                    assert loader.next()["left"].shape == (6, 8, 3)
                else:
                    with pytest.raises(IOError, match=why):
                        loader.next()
            finally:
                loader.close()


# ------------------------------------------------- StepTimer, the grabber


def test_step_timer_matches_jax(monkeypatch):
    from real_time_self_adaptive_deep_stereo_torch.utils.profiling import StepTimer as TTimer
    from real_time_self_adaptive_deep_stereo_tpu.utils.profiling import StepTimer as JTimer

    ticks = np.cumsum(np.random.default_rng(4).random(9) * 0.05).tolist()
    timers = (TTimer(window=4), JTimer(window=4))
    assert all(t.avg_ms == 0.0 and t.fps == 0.0 for t in timers)
    for now in ticks:
        monkeypatch.setattr(time, "perf_counter", lambda now=now: now)
        for t in timers:
            t.tick()
    (got, want) = timers
    assert got.steps == want.steps == 8
    assert (got.avg_ms, got.fps, got.total) == (want.avg_ms, want.fps, want.total)
    np.testing.assert_allclose(got.avg_ms, 1000 * np.mean(np.diff(ticks)[-4:]), rtol=1e-12)


def test_folder_grabber_keeps_every_frame_in_order(tmp_path):
    """File replay blocks on the bounded queue when the consumer lags, so
    every frame arrives, in order; with an fps cap it drops as a live
    camera does. Cameras register where their packages import."""
    from real_time_self_adaptive_deep_stereo_torch.data import grabber

    rng = np.random.default_rng(0)
    lines, frames = [], []
    for i in range(6):
        arr = (rng.random((8, 12, 3)) * 255).astype(np.uint8)
        pair = (arr, (arr + i) % 255)
        for side, img in zip("lr", pair):
            write_png(str(tmp_path / f"{side}{i}.png"), img)
        lines.append(f"{tmp_path / f'l{i}.png'},{tmp_path / f'r{i}.png'}")
        frames.append(pair)
    lst = tmp_path / "pairs.csv"
    lst.write_text("\n".join(lines) + "\n")

    q = queue.Queue(maxsize=1)
    g = grabber.get_camera("folder", q, list_file=str(lst))
    assert g.drop_when_full is False
    g.start()
    got = []
    while True:
        time.sleep(0.05)  # a slow consumer: the queue stays full
        item = q.get(timeout=10.0)
        if item is None:
            break
        got.append(item)
    g.join(timeout=10.0)
    assert not g.is_alive() and len(got) == 6
    for item, (left, right) in zip(got, frames):
        assert item.shape == (2, 8, 12, 3) and item.dtype == np.float32
        np.testing.assert_array_equal(item[0], left)
        np.testing.assert_array_equal(item[1], right)
    assert grabber.get_camera("folder", queue.Queue(1), list_file=str(lst), fps_cap=30.0).drop_when_full
    assert "opencv" in grabber.CAMERA_FACTORY  # cv2 imports here
    with pytest.raises(KeyError, match="unknown camera"):
        grabber.get_camera("nope", q)
