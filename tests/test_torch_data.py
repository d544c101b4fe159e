"""The port's data pipeline against ``cv2`` and the JAX package, bit for
bit, on the CPU: the numpy PNG codec (``data/png.py``), the readers and
``StereoDataset`` (``data/readers.py``), the step checkpoints
(``utils/checkpoint.py``) and ``save_disparity_png`` (``utils/visual.py``)."""

import glob
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch.data import png as tpng
from real_time_self_adaptive_deep_stereo_torch.data import readers as tr
from real_time_self_adaptive_deep_stereo_torch.utils import checkpoint as tck
from real_time_self_adaptive_deep_stereo_torch.utils import visual as tvis
from real_time_self_adaptive_deep_stereo_tpu.data import readers as jr
from real_time_self_adaptive_deep_stereo_tpu.utils import checkpoint as jck
from real_time_self_adaptive_deep_stereo_tpu.utils import visual as jvis

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "realworld")
FIXTURE_PNGS = sorted(glob.glob(os.path.join(FIXTURE, "*.png")))
FILTERS = {
    "none": cv2.IMWRITE_PNG_FILTER_NONE,
    "sub": cv2.IMWRITE_PNG_FILTER_SUB,
    "up": cv2.IMWRITE_PNG_FILTER_UP,
    "avg": cv2.IMWRITE_PNG_FILTER_AVG,
    "paeth": cv2.IMWRITE_PNG_FILTER_PAETH,
    "all": cv2.IMWRITE_PNG_ALL_FILTERS,  # libpng picks a filter per row
}
FILTER_CODE = {"none": 0, "sub": 1, "up": 2, "avg": 3, "paeth": 4}


def cv2_read(path):
    """What the JAX reader's ``_imread`` returns: cv2 with BGR(A) -> RGB(A)."""
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][: img.shape[2]]]
    return img


def chunks(path):
    data = open(path, "rb").read()
    pos, out = 8, []
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        out.append((kind, data[pos + 8 : pos + 8 + length]))
        pos += 12 + length
    return out


def write_chunks(path, parts):
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        for kind, body in parts:
            f.write(struct.pack(">I", len(body)) + kind + body)
            f.write(struct.pack(">I", zlib.crc32(kind + body)))


# ---------------------------------------------------------------------- png


def test_fixture_pngs_are_all_there():
    assert len(FIXTURE_PNGS) == 24


@pytest.mark.parametrize("path", FIXTURE_PNGS, ids=os.path.basename)
def test_read_png_matches_cv2_on_fixtures(path):
    got, want = tpng.read_png(path), cv2_read(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def synthetic(kind, rng, h=23, w=37):
    """Smooth ramps plus noise, so that every filter has work to do."""
    ys, xs = np.mgrid[0:h, 0:w]
    if kind == "grey16":
        return (ys * 1500 + xs * 700 + rng.integers(0, 3000, (h, w))).astype(np.uint16)
    base = ys * 5 + xs * 3
    c = {"grey8": 1, "rgb8": 3, "rgba8": 4}[kind]
    img = base[..., None] + rng.integers(0, 90, (h, w, c))
    img = (img % 256).astype(np.uint8)
    return img[..., 0] if c == 1 else img


@pytest.mark.parametrize("kind", ["grey8", "rgb8", "rgba8", "grey16"])
@pytest.mark.parametrize("filt", list(FILTERS))
def test_read_png_matches_cv2_on_every_filter(tmp_path, kind, filt):
    rng = np.random.default_rng(hash((kind, filt)) % 2**32)
    img = synthetic(kind, rng)
    path = str(tmp_path / f"{kind}_{filt}.png")
    assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, FILTERS[filt]])
    _, filters, _ = tpng._parse(path)
    if filt in FILTER_CODE:
        assert set(filters.tolist()) == {FILTER_CODE[filt]}
    else:
        assert len(set(filters.tolist())) > 1
    np.testing.assert_array_equal(tpng.read_png(path), cv2_read(path))


def test_read_png_takes_idat_split_over_chunks(tmp_path):
    img = synthetic("rgb8", np.random.default_rng(3), 40, 50)
    path = str(tmp_path / "split.png")
    cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_FILTER_PAETH,
                            cv2.IMWRITE_PNG_ZLIBBUFFER_SIZE, 64])
    assert sum(kind == b"IDAT" for kind, _ in chunks(path)) > 1
    np.testing.assert_array_equal(tpng.read_png(path), cv2_read(path))
    # and a single IDAT cut into pieces of 7 bytes, with an ancillary chunk between
    parts = chunks(path)
    data = b"".join(body for kind, body in parts if kind == b"IDAT")
    pieces = [(b"IDAT", data[i : i + 7]) for i in range(0, len(data), 7)]
    resplit = str(tmp_path / "resplit.png")
    write_chunks(resplit, [parts[0], (b"tEXt", b"k\x00v")] + pieces + [(b"IEND", b"")])
    np.testing.assert_array_equal(tpng.read_png(resplit), cv2_read(path))


def test_read_pngs_sweeps_a_frame_together():
    paths = [os.path.join(FIXTURE, f"scene2_{k}.png") for k in ("left", "right", "gt")]
    for got, path in zip(tpng.read_pngs(paths), paths):
        np.testing.assert_array_equal(got, cv2_read(path))


def test_read_png_refuses_what_it_does_not_take(tmp_path):
    img = synthetic("rgb8", np.random.default_rng(4))
    path = str(tmp_path / "ok.png")
    cv2.imwrite(path, img)
    parts = chunks(path)
    w, h, depth, color, comp, filt, _ = struct.unpack(">IIBBBBB", parts[0][1])

    def variant(name, **hdr):
        fields = dict(w=w, h=h, depth=depth, color=color, interlace=0)
        fields.update(hdr)
        ihdr = struct.pack(">IIBBBBB", fields["w"], fields["h"], fields["depth"], fields["color"],
                           comp, filt, fields["interlace"])
        out = str(tmp_path / f"{name}.png")
        write_chunks(out, [(b"IHDR", ihdr)] + parts[1:])
        return out

    with pytest.raises(ValueError, match="interlaced"):
        tpng.read_png(variant("interlaced", interlace=1))
    with pytest.raises(ValueError, match="colour type 3"):
        tpng.read_png(variant("palette", color=3))
    with pytest.raises(ValueError, match="16-bit PNG of colour type 2"):
        tpng.read_png(variant("rgb16", depth=16))
    rgb16 = str(tmp_path / "rgb16_cv2.png")
    cv2.imwrite(rgb16, np.zeros((4, 5, 3), np.uint16))
    with pytest.raises(ValueError, match="16-bit"):
        tpng.read_png(rgb16)
    not_png = tmp_path / "x.png"
    not_png.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        tpng.read_png(str(not_png))


@pytest.mark.parametrize("kind", ["grey16", "grey8", "rgb8"])
def test_write_png_round_trip_through_cv2(tmp_path, kind):
    img = synthetic(kind, np.random.default_rng(5), 31, 17)
    path = str(tmp_path / f"{kind}.png")
    tpng.write_png(path, img)
    np.testing.assert_array_equal(cv2_read(path), img)
    np.testing.assert_array_equal(tpng.read_png(path), img)
    with pytest.raises(ValueError, match="write_png takes"):
        tpng.write_png(path, img.astype(np.float32))


# ------------------------------------------------------------------ readers


@pytest.mark.parametrize("name", ["scene2_left.png", "asym3_right.png"])
def test_load_image_matches_jax(name):
    path = os.path.join(FIXTURE, name)
    got, want = tr.load_image(path), jr.load_image(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == (320, 1216, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["fixture16", "grey8", "rgb8"])
def test_load_gt_matches_jax(tmp_path, kind):
    if kind == "fixture16":
        path = os.path.join(FIXTURE, "scene3_gt.png")
    else:
        path = str(tmp_path / f"{kind}.png")
        tpng.write_png(path, synthetic(kind, np.random.default_rng(6)))
    got, want = tr.load_gt(path), jr.load_gt(path)
    assert got.dtype == want.dtype and got.shape == want.shape and got.shape[-1] == 1
    np.testing.assert_array_equal(got, want)


def write_pfm(path, arr, little_endian):
    h, w = arr.shape[:2]
    c = 1 if arr.ndim == 2 or arr.shape[2] == 1 else 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if c == 3 else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n" if little_endian else b"1.0\n")
        f.write(np.flipud(arr).astype("<f4" if little_endian else ">f4").tobytes())


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("little_endian", [True, False])
def test_read_pfm_and_load_gt_match_jax(tmp_path, channels, little_endian):
    arr = np.random.default_rng(8).random((9, 11, channels)).astype(np.float32) * 90
    path = str(tmp_path / "d.pfm")
    write_pfm(path, arr, little_endian)
    np.testing.assert_array_equal(tr.read_pfm(path), jr.read_pfm(path))
    np.testing.assert_array_equal(tr.read_pfm(path), arr)
    np.testing.assert_array_equal(tr.load_gt(path), jr.load_gt(path))


def test_read_list_file_matches_jax(tmp_path):
    path = tmp_path / "l.csv"
    path.write_text("# a comment\na.png,b.png,c.png\n\nd.png; e.png ;f.png;g.pfm\nh.png,i.png\n")
    got = tr.read_list_file(str(path))
    assert got == jr.read_list_file(str(path))
    assert got[0] == ["a.png", "d.png", "h.png"] and got[3] == ["g.pfm"]


def test_crops_match_jax():
    rng = np.random.default_rng(9)
    tensors = [rng.random((50, 70, 3)).astype(np.float32), rng.random((50, 70, 1)).astype(np.float32)]
    for seed in range(5):
        got = tr.random_crop((20, 30), tensors, np.random.default_rng(seed))
        want = jr.random_crop((20, 30), tensors, np.random.default_rng(seed))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for th, tw in ((20, 30), (64, 96), (40, 90), (51, 33)):
        np.testing.assert_array_equal(
            tr.center_crop_or_pad(tensors[0], th, tw), jr.center_crop_or_pad(tensors[0], th, tw)
        )


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("out_hw", [(24, 40), (50, 30), (17, 17)])
def test_resize_image_np_matches_jax(dtype, out_hw):
    img = (np.random.default_rng(10).random((17, 23, 3)) * 255).astype(dtype)
    got, want = tr.resize_image_np(img, *out_hw), jr.resize_image_np(img, *out_hw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ dataset


@pytest.fixture(scope="module")
def tiny_list(tmp_path_factory):
    """Three frames of different sizes' worth of content at 30x44, the
    last without ground truth, and a fourth column of proxies."""
    tmp = tmp_path_factory.mktemp("ds")
    rng = np.random.default_rng(11)
    lines = []
    for i in range(3):
        left = (rng.random((30, 44, 3)) * 255).astype(np.uint8)
        right = np.roll(left, -2, axis=1)
        gt = (rng.random((30, 44)) * 20 * 256).astype(np.uint16)
        paths = [str(tmp / f"{k}{i}.png") for k in ("l", "r", "g")]
        for p, a in zip(paths, (left, right, gt)):
            cv2.imwrite(p, a[..., ::-1] if a.ndim == 3 else a,
                        [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS])
        lines.append(",".join(paths[:2] + [paths[2] if i < 2 else ""] + [paths[2]]))
    path = tmp / "list.csv"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize(
    "kw",
    [
        dict(batch_size=2, crop_shape=(32, 48), num_epochs=1, is_training=False, shuffle=False),
        dict(batch_size=2, crop_shape=(20, 32), num_epochs=2, is_training=True, shuffle=True, seed=3),
        dict(batch_size=2, crop_shape=(30, 44), num_epochs=1, is_training=False, shuffle=False,
             load_proxy=True),
    ],
    ids=["eval", "train", "proxy"],
)
def test_stereo_dataset_matches_jax(tiny_list, kw):
    """The Python backends (the native loaders: tests/test_torch_runtime.py)."""
    got = list(tr.StereoDataset(tiny_list, backend="python", **kw))
    want = list(jr.StereoDataset(tiny_list, backend="python", **kw))
    assert len(got) == len(want) == (2 if not kw["is_training"] else 3)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    if not kw["is_training"]:
        assert got[-1]["left"].shape[0] == 1  # the eval remainder is kept


def test_stereo_dataset_refuses_what_is_not_ported(tiny_list):
    """Every backend is ported now (the native one: tests/test_torch_runtime.py);
    an unknown one is refused, and "auto" decodes as "python" does."""
    assert tr.StereoDataset(tiny_list, augment=True).augment  # ported: tests/test_torch_train.py
    assert tr.StereoDataset(tiny_list, backend="native").backend == "native"
    with pytest.raises(ValueError, match="unknown backend"):
        tr.StereoDataset(tiny_list, backend="cv2")
    kw = dict(batch_size=2, crop_shape=(32, 48), num_epochs=1, is_training=False, shuffle=False)
    auto = list(tr.StereoDataset(tiny_list, **kw))  # the native loader, where it builds
    python = list(tr.StereoDataset(tiny_list, backend="python", **kw))
    for a, p in zip(auto, python):
        np.testing.assert_array_equal(a["left"], p["left"])


def test_stereo_dataset_raises_a_decode_error(tmp_path):
    path = tmp_path / "bad.csv"
    (tmp_path / "x.png").write_bytes(b"not a png")
    path.write_text(f"{tmp_path / 'x.png'},{tmp_path / 'x.png'},\n")
    ds = tr.StereoDataset(str(path), batch_size=1, num_epochs=1, is_training=False, crop_shape=(4, 4),
                          backend="python")  # the native loader's error: tests/test_torch_runtime.py
    assert len(ds) == 1
    with pytest.raises(ValueError, match="not a PNG"):
        list(ds)


def test_prefetch_to_device(tiny_list):
    kw = dict(batch_size=2, crop_shape=(32, 48), num_epochs=1, is_training=False, shuffle=False)
    want = list(tr.StereoDataset(tiny_list, **kw))
    got = list(tr.prefetch_to_device(iter(tr.StereoDataset(tiny_list, **kw)), size=2, device="cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(tr.prefetch_to_device(iter(want)))


# -------------------------------------------------------------- checkpoints


def madnet_state():
    from real_time_self_adaptive_deep_stereo_torch.models import MADNet

    return MADNet(device="cpu", seed=5).state_dict()


def assert_trees_equal(a, b):
    fa, fb = tck.flatten_params(a), tck.flatten_params(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k])


def test_step_checkpoints_keep_and_resume_like_jax(tmp_path):
    state = madnet_state()
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    tree = tck.params_to_jax(state)
    for step in (3, 10, 7):
        tck.save_step_checkpoint(port_dir, state, step, keep=2)
        jck.save_step_checkpoint(jax_dir, tree, step, keep=2)
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == ["weights-10.npz", "weights-7.npz"]
    for d in (port_dir, jax_dir):
        assert tck.latest_checkpoint(d) == jck.latest_checkpoint(d) == (
            os.path.join(d, "weights-10.npz"), 10)
    # a file saved by each package loads in the other
    got, restored, step = tck.restore_or_init(jax_dir, None, "ignored.npz")
    assert restored and step == 10
    assert_trees_equal(got, tree)
    want, restored, step = jck.restore_or_init(port_dir, None, "ignored.npz")
    assert restored and step == 10
    assert_trees_equal(want, tree)
    back = tck.params_from_jax(got)
    for k, v in state.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_restore_or_init_matches_jax(tmp_path):
    tree = tck.params_to_jax(madnet_state())
    weights = str(tmp_path / "w.npz")
    jck.save_params(weights, tree)
    empty = str(tmp_path / "empty")
    for initial in (weights, weights[: -len(".npz")]):  # with and without the suffix
        got, want = tck.restore_or_init(empty, None, initial), jck.restore_or_init(empty, None, initial)
        assert got[1:] == want[1:] == (True, 0)
        assert_trees_equal(got[0], want[0])
    sentinel = {"kept": np.zeros(1)}
    assert tck.restore_or_init(empty, sentinel, None) == (sentinel, False, 0)
    assert jck.restore_or_init(empty, sentinel, None) == (sentinel, False, 0)
    assert tck.restore_or_init(empty, sentinel, str(tmp_path / "tf1_ckpt")) == (sentinel, False, 0)
    # with a model, a path that is no .npz goes to the TF1 importer
    # (tests/test_torch_checkpoint.py), which finds no checkpoint here
    with pytest.raises(FileNotFoundError, match="no TF checkpoint"):
        tck.restore_or_init(empty, sentinel, str(tmp_path / "tf1_ckpt"), model=object())


# ------------------------------------------------------------------- visual


@pytest.mark.parametrize("shape", [(13, 21), (13, 21, 1)])
def test_save_disparity_png_matches_jax(tmp_path, shape):
    d = np.random.default_rng(12).random(shape).astype(np.float32) * 300 - 20
    flat = d.reshape(-1)
    flat[:4] = [np.nan, np.inf, -np.inf, 255.999]
    got, want = str(tmp_path / "port" / "d.png"), str(tmp_path / "jax" / "d.png")
    tvis.save_disparity_png(got, d, 256)
    jvis.save_disparity_png(want, d, 256)
    a, b = cv2.imread(got, cv2.IMREAD_UNCHANGED), cv2.imread(want, cv2.IMREAD_UNCHANGED)
    assert a.dtype == b.dtype == np.uint16
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tpng.read_png(got), b)
    # NaN and -inf encode as 0 (invalid); 255.999 px as 65535
    assert a.reshape(-1)[[0, 2, 3]].tolist() == [0, 0, 65535]
