"""The port's TF1 importer (``utils/checkpoint.py``: ``read_tf1_checkpoint``,
``tf1_checkpoint_to_params`` and the TF1 branch of ``restore_or_init``)
against checkpoints that TensorFlow writes here and against the JAX
package's importer, which reads them through TensorFlow: every leaf of
MADNet and DispNet bit for bit, ``mask`` / ``prefix`` / ``ignore_list`` as in
``tests/test_checkpoint.py``, the errors on what the reader does not read,
and the reader, ``augment`` and ``colorize_disparity`` in a process where
TensorFlow, matplotlib and JAX cannot be imported."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net as t_net
from real_time_self_adaptive_deep_stereo_torch.utils import checkpoint as tck
from real_time_self_adaptive_deep_stereo_tpu.models import get_stereo_net as j_net
from real_time_self_adaptive_deep_stereo_tpu.utils import checkpoint as jck

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's runs: at these sizes more threads
    only contend with the other test workers' (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "tf1_madnet_tiny")


def write_tf1(path, values):
    """A V2 checkpoint of ``values`` ({name: array}) written by TF1's Saver."""
    tf = pytest.importorskip("tensorflow")
    tf1 = tf.compat.v1
    g = tf1.Graph()
    with g.as_default():
        for name, value in values.items():
            tf1.get_variable(name, initializer=value)
        saver = tf1.train.Saver()
        with tf1.Session(graph=g) as sess:
            sess.run(tf1.global_variables_initializer())
            return saver.save(sess, str(path / "model.ckpt"), write_meta_graph=False)


def port_tree(model):
    return tck.params_to_jax(model.state_dict())


def leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.mark.parametrize("name", ["MADNet", "Dispnet"])
def test_every_leaf_is_restored_bit_for_bit(tmp_path, name):
    """Every variable of the reference's graph, seeded values, through the
    port's importer: the count and each leaf exact; the state_dict it makes
    loads into the model."""
    model = t_net(name, device="cpu")
    base = port_tree(model)
    name_map = model.tf_name_map()
    flat = tck.flatten_params(base)
    rng = np.random.default_rng(3)
    values = {n: rng.standard_normal(flat["/".join(p)].shape).astype(np.float32) for n, p in name_map.items()}
    ckpt = write_tf1(tmp_path, values)

    restored, n = tck.tf1_checkpoint_to_params(ckpt, model, base)
    assert n == len(name_map) == len(flat)
    for tf_name, path in name_map.items():
        got = leaf(restored, path)
        assert got.dtype == np.float32 and np.array_equal(got, values[tf_name]), tf_name
    model.load_state_dict(tck.params_from_jax(restored))


def test_mask_prefix_and_ignore_list(tmp_path):
    """As tests/test_checkpoint.py holds the JAX importer: ignore_list
    strips a scope, mask skips graph names, prefix is prepended."""
    model = t_net("MADNet", device="cpu")
    base = port_tree(model)
    zeros = np.zeros((3, 3, 3, 16), np.float32)
    ckpt = write_tf1(tmp_path, {"prefix/model/gc-read-pyramid/conv1/weights": zeros,
                                "gc-read-pyramid/conv2/biases": np.ones_like(base["pyramid"]["conv2"]["b"])})
    new, n = tck.tf1_checkpoint_to_params(ckpt, model, base, ignore_list=["prefix/"])
    assert n == 1
    np.testing.assert_array_equal(new["pyramid"]["conv1"]["w"], 0.0)
    _, n2 = tck.tf1_checkpoint_to_params(ckpt, model, base, mask=["conv1"], ignore_list=["prefix/"])
    assert n2 == 0
    new, n3 = tck.tf1_checkpoint_to_params(ckpt, model, base, prefix="model/")
    assert n3 == 1
    np.testing.assert_array_equal(new["pyramid"]["conv2"]["b"], 1.0)
    np.testing.assert_array_equal(new["pyramid"]["conv1"]["w"], base["pyramid"]["conv1"]["w"])
    # the same three calls through the JAX importer count alike
    jm = j_net("MADNet")
    for kw, want in (({"ignore_list": ["prefix/"]}, 1), ({"mask": ["conv1"], "ignore_list": ["prefix/"]}, 0),
                     ({"prefix": "model/"}, 1)):
        assert jck.tf1_checkpoint_to_params(ckpt, jm, base, **kw)[1] == want


def test_shape_mismatch_raises(tmp_path):
    model = t_net("MADNet", device="cpu")
    ckpt = write_tf1(tmp_path, {"model/gc-read-pyramid/conv1/weights": np.zeros((3, 3, 3, 8), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch for model/gc-read-pyramid/conv1/weights"):
        tck.tf1_checkpoint_to_params(ckpt, model, port_tree(model))


def test_restore_or_init_equals_jax(tmp_path):
    """The TF1 branch of restore_or_init: a checkpoint of part of MADNet's
    variables into the same base tree, through both packages."""
    import jax

    jm = j_net("MADNet")
    base = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    name_map = jm.tf_name_map()
    rng = np.random.default_rng(4)
    flat = jck.flatten_params(base)
    values = {n: rng.standard_normal(flat["/".join(p)].shape).astype(np.float32)
              for n, p in list(name_map.items())[::3]}
    ckpt = write_tf1(tmp_path, values)
    logdir = str(tmp_path / "empty")
    got, got_ok, got_step = tck.restore_or_init(logdir, base, ckpt, t_net("MADNet", device="cpu"))
    want, want_ok, want_step = jck.restore_or_init(logdir, base, ckpt, jm)
    assert (got_ok, got_step) == (want_ok, want_step) == (True, 0)
    got_flat, want_flat = tck.flatten_params(got), jck.flatten_params(want)
    assert set(got_flat) == set(want_flat)
    for k in want_flat:
        np.testing.assert_array_equal(got_flat[k], np.asarray(want_flat[k]), err_msg=k)
    # nothing restorable: restored? is False, as in JAX
    other = write_tf1(tmp_path / "other", {"unrelated/variable": np.zeros(3, np.float32)})
    assert tck.restore_or_init(logdir, base, other, t_net("MADNet", device="cpu"))[1] is False


def test_reader_dtypes_and_directory(tmp_path):
    """float16, int32 and int64 as TF stores them, bfloat16 widened to
    float32; a directory resolves through its checkpoint file."""
    tf = pytest.importorskip("tensorflow")
    tf1 = tf.compat.v1
    g = tf1.Graph()
    with g.as_default():
        tf1.get_variable("a/half", initializer=np.array([1.5, -2.0, 65504.0], np.float16))
        tf1.get_variable("a/int", initializer=np.arange(6, dtype=np.int32).reshape(2, 3))
        tf1.get_variable("a/long", initializer=np.array([2**40, -3], np.int64))
        tf1.get_variable("a/bf", initializer=tf.constant([1.5, -2.25, 3.0e38], dtype=tf.bfloat16))
        tf1.get_variable("a/scalar", initializer=np.float32(7.0))
        saver = tf1.train.Saver()
        with tf1.Session(graph=g) as sess:
            sess.run(tf1.global_variables_initializer())
            saver.save(sess, str(tmp_path / "m.ckpt"))
    got = tck.read_tf1_checkpoint(str(tmp_path))
    want = tf.train.load_checkpoint(str(tmp_path / "m.ckpt"))
    assert set(got) == set(want.get_variable_to_shape_map())
    for name, value in got.items():
        ref = np.asarray(want.get_tensor(name))
        if name == "a/bf":
            assert value.dtype == np.float32
            ref = ref.astype(np.float32)
        else:
            assert value.dtype == ref.dtype, name
        np.testing.assert_array_equal(value, ref, err_msg=name)
        assert value.shape == ref.shape


def test_reader_refuses_what_it_does_not_read(tmp_path):
    ckpt = write_tf1(tmp_path, {"x": np.zeros(4, np.float64)})
    with pytest.raises(ValueError, match="TF dtype 2"):
        tck.read_tf1_checkpoint(ckpt)

    fixture = os.path.join(FIXTURE, "model.ckpt")
    index = open(fixture + ".index", "rb").read()
    data = open(fixture + ".data-00000-of-00001", "rb").read()

    def copy(name, new_index):
        prefix = str(tmp_path / name)
        open(prefix + ".index", "wb").write(new_index)
        open(prefix + ".data-00000-of-00001", "wb").write(data)
        return prefix

    # the index block's first handle is the first data block's; the
    # compression byte of its trailer follows it
    footer = index[-48:]
    _, pos = tck._block_handle(footer)
    (idx_off, idx_size), _ = tck._block_handle(footer, pos)
    _, handle = next(tck._block_entries(index[idx_off: idx_off + idx_size]))
    (off, size), _ = tck._block_handle(handle)
    snappy = bytearray(index)
    snappy[off + size] = 1
    with pytest.raises(ValueError, match="compression type 1"):
        tck.read_tf1_checkpoint(copy("snappy", bytes(snappy)))
    with pytest.raises(ValueError, match="bad footer magic"):
        tck.read_tf1_checkpoint(copy("magic", index[:-1] + b"\x00"))
    v1 = tmp_path / "v1.ckpt"
    v1.write_bytes(b"not a bundle")
    with pytest.raises(ValueError, match="V1 checkpoint"):
        tck.read_tf1_checkpoint(str(v1))
    with pytest.raises(FileNotFoundError):
        tck.read_tf1_checkpoint(str(tmp_path / "missing"))


def test_fixture_matches_its_values():
    """tests/fixtures/tf1_madnet_tiny (tools/torch_tf1_fixture.py) read
    without TensorFlow, and loaded into MADNet through restore_or_init."""
    got = tck.read_tf1_checkpoint(FIXTURE)
    with np.load(os.path.join(FIXTURE, "values.npz")) as v:
        want = {k: v[k] for k in v.files}
    assert set(got) == set(want) and len(want) == 6
    for k in want:
        assert np.array_equal(got[k], want[k]) and got[k].dtype == want[k].dtype, k
    model = t_net("MADNet", device="cpu")
    params, restored, step = tck.restore_or_init("", port_tree(model), os.path.join(FIXTURE, "model.ckpt"),
                                                 model)
    assert restored and step == 0
    np.testing.assert_array_equal(params["pyramid"]["conv1"]["w"],
                                  want["model/gc-read-pyramid/conv1/weights"])
    np.testing.assert_array_equal(params["estimator_2"]["disp6"]["b"],
                                  want["model/G2/fgc-volume-filtering-2/disp-6/biases"])
    np.testing.assert_array_equal(params["context"]["context7"]["w"], want["model/context-7/weights"])


_NO_TF = """
import sys
for name in ("tensorflow", "matplotlib", "jax"):
    sys.modules[name] = None  # any import of them raises ImportError
import numpy as np
from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import read_tf1_checkpoint
from real_time_self_adaptive_deep_stereo_torch.data.readers import augment
from real_time_self_adaptive_deep_stereo_torch.utils.visual import colorize_disparity
got = read_tf1_checkpoint(sys.argv[1])
want = np.load(sys.argv[1] + "/values.npz")
assert all(np.array_equal(got[k], want[k]) for k in want.files)
img = np.random.default_rng(0).random((8, 8, 3)).astype(np.float32) * 255
l, r = augment(img, img, np.random.default_rng(0))  # seed 0 runs every op, the hue shift too
assert l.shape == (8, 8, 3) and colorize_disparity(img[..., 0]).shape == (8, 8, 3)
print("ok", len(got))
"""


def test_reader_augment_and_colours_need_no_tensorflow():
    """A process where tensorflow, matplotlib and jax cannot be imported
    reads the fixture, augments and colours."""
    out = subprocess.run([sys.executable, "-c", _NO_TF, FIXTURE], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok 6"
