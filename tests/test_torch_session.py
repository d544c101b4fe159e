"""The PyTorch port's reprojection loss, metrics, engine and NONE-mode
online session against the JAX package on the CPU (FULL and MAD:
``test_torch_adapt.py``).

Frames and disparities are made with numpy from a seed and handed to
both packages (NHWC at the boundary, as in JAX)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch.adapt import AdaptationEngine as TorchEngine
from real_time_self_adaptive_deep_stereo_torch.adapt import OnlineAdaptationSession as TorchSession
from real_time_self_adaptive_deep_stereo_torch.adapt import d1_metric as t_d1
from real_time_self_adaptive_deep_stereo_torch.adapt import disparity_metrics as t_metrics
from real_time_self_adaptive_deep_stereo_torch.adapt import get_sampler as t_sampler
from real_time_self_adaptive_deep_stereo_torch.adapt import softmax as t_softmax
from real_time_self_adaptive_deep_stereo_torch.losses import factory as tloss
from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net as torch_net
from real_time_self_adaptive_deep_stereo_torch.utils.checkpoint import params_from_jax
from real_time_self_adaptive_deep_stereo_tpu.adapt import AdaptationEngine as JaxEngine
from real_time_self_adaptive_deep_stereo_tpu.adapt import OnlineAdaptationSession as JaxSession
from real_time_self_adaptive_deep_stereo_tpu.adapt import d1_metric as j_d1
from real_time_self_adaptive_deep_stereo_tpu.adapt import disparity_metrics as j_metrics
from real_time_self_adaptive_deep_stereo_tpu.adapt import get_sampler as j_sampler
from real_time_self_adaptive_deep_stereo_tpu.losses import factory as jloss
from real_time_self_adaptive_deep_stereo_tpu.models import get_stereo_net as jax_net

H, W = 60, 120
N_FRAMES = 3


def _frames(seed, n=N_FRAMES):
    """Textured left image, right = left shifted by a known disparity,
    target = that disparity (plus a band of invalid, zero gt)."""
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        d = 4 + 3 * i
        base = r.random((1, H, W + d, 3)) * 255
        left = base[:, :, :W].astype(np.float32)
        right = base[:, :, d : W + d].astype(np.float32)
        target = np.full((1, H, W, 1), float(d), np.float32)
        target[:, :, :d] = 0.0
        out.append({"left": left, "right": right, "target": target})
    return out


def _disparities(seed):
    """Coarse-to-fine predictions at several resolutions, some beyond the
    clamp window (max_disp 192 at full width) and some negative."""
    r = np.random.default_rng(seed)
    shapes = [(15, 30), (30, 60), (60, 120)]
    ds = [(r.random((1, h, w, 1)) * 260 - 20).astype(np.float32) * w / W for h, w in shapes]
    assert ds[-1].max() > 192 and ds[-1].min() < 0
    return ds


# ----------------------------------------------------------------------- loss


@pytest.mark.parametrize(
    "port_mode,jax_mode", [("gather", "gather"), ("clamped", "shift"), ("cuda", "shift")]
)
@pytest.mark.parametrize("multiscale", [False, True])
def test_reprojection_loss_matches_jax(port_mode, jax_mode, multiscale):
    frame = _frames(1, 1)[0]
    ds = _disparities(2)
    want = jloss.get_reprojection_loss("mean_SSIM_l1", multiScale=multiscale, warp_mode=jax_mode)(
        [jnp.asarray(d) for d in ds], {k: jnp.asarray(v) for k, v in frame.items()}
    )
    got = tloss.get_reprojection_loss("mean_SSIM_l1", multiScale=multiscale, warp_mode=port_mode)(
        [torch.from_numpy(d) for d in ds], {k: torch.from_numpy(v) for k, v in frame.items()}
    )
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_ssim_and_l1_primitives_match_jax():
    r = np.random.default_rng(3)
    x = r.random((2, 12, 17, 3)).astype(np.float32)
    y = r.random((2, 12, 17, 3)).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    np.testing.assert_allclose(tloss.SSIM(tx, ty).numpy(), np.asarray(jloss.SSIM(jx, jy)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tloss.l1(tx, ty).numpy(), np.asarray(jloss.l1(jx, jy)), rtol=1e-6)
    np.testing.assert_allclose(
        float(tloss.mean_SSIM_L1(tx, ty)), float(jloss.mean_SSIM_L1(jx, jy)), rtol=1e-5
    )
    assert tloss.SSIM_ALPHA == jloss.SSIM_ALPHA
    with pytest.raises(KeyError, match="Unknown loss"):
        tloss.get_reprojection_loss("no_such_loss")


# -------------------------------------------------------------------- metrics


def test_metrics_match_jax():
    r = np.random.default_rng(4)
    disp = (r.random((1, H, W, 1)) * 40).astype(np.float32)
    gt = (r.random((1, H, W, 1)) * 40).astype(np.float32)
    gt[:, :, :10] = 0.0
    for tf, jf in ((t_metrics, j_metrics), (t_d1, j_d1)):
        got = [float(v) for v in tf(torch.from_numpy(disp), torch.from_numpy(gt))]
        want = [float(v) for v in jf(jnp.asarray(disp), jnp.asarray(gt))]
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_samplers_copy_matches_jax():
    dist = t_softmax(np.array([0.1, 2.0, 0.3, 0.1, 0.5]))
    for name in ("FIXED", "ARGMAX", "SEQUENTIAL", "RANDOM", "PROBABILITY"):
        a, b = t_sampler(name, 2, fixed_id=[1, 3], seed=0), j_sampler(name, 2, fixed_id=[1, 3], seed=0)
        for _ in range(3):
            assert [int(i) for i in a.sample(dist)] == [int(i) for i in b.sample(dist)], name


# -------------------------------------------------------------------- session


@pytest.fixture(scope="module")
def session_runs():
    """NONE-mode sessions of both packages over the same frames and
    weights; each warp mode is 'auto', which is 'gather' on the CPU in
    both packages."""
    net = jax_net("MADNet", corr_mode="jnp")
    params = net.init(jax.random.PRNGKey(1))
    frames = _frames(5)
    jsess = JaxSession(JaxEngine(net), params, mode="NONE")
    jout = [jsess.step({k: jnp.asarray(v) for k, v in f.items()}) for f in frames]

    model = torch_net("MADNet", device="cpu")
    model.load_state_dict(params_from_jax(params))
    tsess = TorchSession(TorchEngine(model, device="cpu"), mode="NONE")
    tout = [tsess.step(f) for f in frames]
    return jsess, jout, tsess, tout


def test_none_session_matches_jax(session_runs):
    jsess, jout, tsess, tout = session_runs
    assert tsess.stats.steps == jsess.stats.steps == N_FRAMES
    one_pixel = 1.0 / (H * W)
    for i, (j, t) in enumerate(zip(jout, tout)):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5, err_msg=f"frame {i}")
        np.testing.assert_allclose(t["epe"], j["epe"], rtol=1e-4, err_msg=f"frame {i}")
        # count metrics: a pixel at the threshold may flip under 1e-6 noise
        np.testing.assert_allclose(t["bad3"], j["bad3"], atol=1.01 * one_pixel, err_msg=f"frame {i}")
        np.testing.assert_allclose(t["d1"], j["d1"], atol=101 * one_pixel, err_msg=f"frame {i}")
        disp_j, disp_t = np.asarray(j["disp"]), t["disp"].numpy()
        assert disp_t.shape == disp_j.shape == (1, H, W, 1)
        np.testing.assert_allclose(disp_t, disp_j, rtol=1e-4, atol=1e-4 * np.abs(disp_j).max())
    assert tsess.stats.loss == [t["loss"] for t in tout]
    assert tsess.stats.fps > 0


def test_session_modes_of_later_slices_raise():
    """FULL and MAD sessions now construct (``test_torch_adapt.py`` holds
    them against JAX); what still raises is an unknown mode, MAD without
    blocks, and a model that is not ported yet."""
    eng = TorchEngine(torch_net("MADNet", device="cpu"), device="cpu")
    assert TorchSession(eng, mode="FULL").mode == "FULL"
    with pytest.raises(ValueError, match="unknown adaptation mode"):
        TorchSession(eng, mode="SOME")
    with pytest.raises(ValueError, match="blocks"):
        TorchSession(eng, mode="MAD")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_net("Dispnet", device="cpu")
