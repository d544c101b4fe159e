"""The port's multi-stream fused session (``num_streams``, ``stream_impl``
"map", "unroll" and "vmap") in the precision modes ``bf16`` and
``bf16_act`` on the CPU, against the port's single session in the same
mode and, for the first frame, against the JAX package's two-stream
session in the mode.

Two streams at 64x128 on smooth frames made with numpy from seeds
(``tests/test_torch_streams.py``), MADNet with the tamed weights of
``tests/test_torch_precision.py``; MAD (SEQUENTIAL; under "vmap" the
shared-forward step, held to a shared-forward single session) and NONE
over 3 frames, FULL over 2.

* Each stream against the single session with its seed on its frames:
  loss and EPE within ``tests/test_torch_vmap.py``'s ``RERUN`` (measured 0
  to 3.6e-7 relative), the fetch counters equal, the weights within
  ``RERUN``.
* The first frame (no step has run) against the JAX package's two-stream
  session in the mode: each stream's loss within 1e-3 relative, the bound
  of ``tests/test_torch_precision.py`` for one bf16_act step of MADNet.
* The disparities keep the reference's dtype under bf16_act, streams or
  not: fp32 for MADNet (``models/madnet.py:173-176`` of the JAX package),
  bf16 for DispNet-Corr1D (``models/dispnet.py:170-177``), whose vmap and
  map streams equal its single session's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch import ops as tops
from real_time_self_adaptive_deep_stereo_torch.adapt import AdaptationEngine as TorchEngine
from real_time_self_adaptive_deep_stereo_torch.adapt import FusedOnlineSession as TorchFused
from real_time_self_adaptive_deep_stereo_torch.adapt import blocks as tblocks
from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net as torch_net
from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import params_from_jax
from real_time_self_adaptive_deep_stereo_tpu.adapt import AdaptationEngine as JaxEngine
from real_time_self_adaptive_deep_stereo_tpu.adapt import blocks as jblocks
from real_time_self_adaptive_deep_stereo_tpu.adapt.fused import FusedOnlineSession as JaxFused
from real_time_self_adaptive_deep_stereo_tpu.models import get_stereo_net as jax_net
from tests.test_torch_dispnet import _jax_params
from tests.test_torch_precision import _jax_precision, _madnet_params
from tests.test_torch_streams import H, W, _frames, _stack

BLOCK_CONFIG = "block_config/MadNet_full.json"
PRECISIONS = ["bf16", "bf16_act"]
N = 2
LR = 1e-4
RERUN = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_vmap.py
FIRST_LOSS_RTOL = 1e-3  # tests/test_torch_precision.py: one bf16_act MAD step of MADNet
SESSIONS = {"MAD": (dict(mode="MAD", sample_mode="SEQUENTIAL"), 3), "NONE": (dict(mode="NONE"), 3),
            "FULL": (dict(mode="FULL"), 2)}
IMPLS = ("map", "unroll", "vmap")
KW = dict(max_steps=8, ssim_th=1e9)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    params = _madnet_params(1)
    return params, params_from_jax(params)


@pytest.fixture(scope="module")
def per_stream():
    return [_frames(95, 3), _frames(96, 3)]


def _engine(state):
    model = torch_net("MADNet", device="cpu")
    model.load_state_dict(state)
    return TorchEngine(model, tblocks.make_blocks(tblocks.load_block_config(BLOCK_CONFIG), model), lr=LR, device="cpu")


def _run(sess, frames):
    for f in frames:
        sess.step(f)
    return sess.finalize()


@pytest.fixture(scope="module")
def jax_first(weights, per_stream):
    """Per mode: each stream's loss on its first frame in the JAX
    package's two-stream session in that mode."""
    params, _ = weights
    first = _stack(per_stream)[0]
    out = {}
    for precision in PRECISIONS:
        with _jax_precision(precision):
            net = jax_net("MADNet", corr_mode="jnp")
            blocks = jblocks.make_blocks(jblocks.load_block_config(BLOCK_CONFIG), net.layer_to_path)
            sess = JaxFused(JaxEngine(net, blocks, lr=LR), jax.tree_util.tree_map(lambda x: x.copy(), params),
                            mode="NONE", seed=0, num_streams=N, stream_impl="map", **KW)
            sess.step({k: jnp.asarray(v) for k, v in first.items()})
            stats = sess.finalize()
        out[precision] = np.asarray(stats["loss"])[:, 0]
    return out


@pytest.mark.parametrize("precision", PRECISIONS)
def test_streams_in_the_mode_follow_single_sessions(weights, per_stream, jax_first, precision):
    _, state = weights
    frames = _stack(per_stream)
    with tops.conv_precision(precision):
        for name, (kw, n) in SESSIONS.items():
            singles = {}
            for shared in (False, True) if name == "MAD" else (False,):
                singles[shared] = []
                for s in range(N):
                    single = TorchFused(_engine(state), seed=0, shared_forward=shared, **kw, **KW)
                    singles[shared].append((_run(single, per_stream[s][:n]), single.arena.flat.clone()))
            for impl in IMPLS:
                what = f"{precision} {name} {impl}"
                sess = TorchFused(_engine(state), seed=[0] * N, num_streams=N, stream_impl=impl, **kw, **KW)
                got = _run(sess, frames[:n])
                assert sess.engine.precision == precision and sess.last_disp.dtype == torch.float32, what
                for s, (ref, flat) in enumerate(singles[impl == "vmap" and name == "MAD"]):
                    for k in ("loss", "epe"):
                        np.testing.assert_allclose(got[k][s], ref[k], **RERUN, err_msg=f"{what} stream {s} {k}")
                    np.testing.assert_allclose(got["loss"][s][0], jax_first[precision][s], rtol=FIRST_LOSS_RTOL,
                                               err_msg=f"{what} stream {s}: the first frame's loss against JAX")
                    np.testing.assert_array_equal(got["fetch_counter"][s], ref["fetch_counter"], err_msg=what)
                    torch.testing.assert_close(sess.arena.flat[s], flat, **RERUN, msg=what)
                if name != "NONE":  # the streams saw different frames, so their weights went apart
                    assert not torch.equal(sess.arena.flat[0], sess.arena.flat[1]), what


def test_stream_disparities_keep_the_references_dtype_under_bf16_act():
    """MADNet's streams fp32, DispNet's bf16, as the JAX models' outputs
    under the mode (their abstract evaluation); DispNet's vmap and map
    streams equal its single session's disparities."""
    frames = _frames(97, 1)
    both = [{k: np.stack([v, v]) for k, v in f.items()} for f in frames]
    dn_state = params_from_jax(_jax_params(True, 1))
    with _jax_precision("bf16_act"):
        for name, params in (("MADNet", _madnet_params(1)), ("Dispnet", _jax_params(True, 1))):
            out = jax.eval_shape(jax_net(name, corr_mode="jnp").forward, params, jnp.zeros((1, H, W, 3)),
                                 jnp.zeros((1, H, W, 3)))
            want = {"MADNet": jnp.float32, "Dispnet": jnp.bfloat16}[name]
            assert out["full_res_disp"].dtype == want, name
    with tops.conv_precision("bf16_act"):
        sess = TorchFused(_engine(params_from_jax(_madnet_params(1))), mode="NONE", num_streams=N,
                          stream_impl="vmap", **KW)
        _run(sess, both)
        assert sess.last_disp.dtype == torch.float32 and tuple(sess.last_disp.shape) == (N, 1, H, W, 1)

        def dn_session(**kw):
            model = torch_net("Dispnet", device="cpu")
            model.load_state_dict(dn_state)
            return TorchFused(TorchEngine(model, lr=LR, device="cpu"), mode="NONE", **kw, **KW)

        single = dn_session()
        _run(single, frames)
        assert single.last_disp.dtype == torch.bfloat16
        for impl in ("vmap", "map"):
            sess = dn_session(num_streams=N, stream_impl=impl)
            _run(sess, both)
            assert sess.last_disp.dtype == torch.bfloat16, impl
            for s in range(N):
                torch.testing.assert_close(sess.last_disp[s], single.last_disp, rtol=0, atol=0, msg=impl)
