"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips elsewhere: a CUDA kernel has
no CPU mode, and the CPU tests cover the plain versions against JAX. This
file imports neither JAX nor the JAX package, so on a machine without JAX
it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: the correlation kernel sums over C in another order than
``torch.mean`` (1e-5 relative and absolute); the warp kernels round every
product and sum as the plain version does and agree to 1e-6 absolute.
"""

import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch import ops as tops
from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _normal(shape, seed, dev, scale=1.0, shift=0.0):
    r = np.random.default_rng(seed)
    return torch.from_numpy((r.standard_normal(shape) * scale + shift).astype(np.float32)).to(dev)


def _uniform(shape, seed, dev, lo, hi):
    r = np.random.default_rng(seed)
    return torch.from_numpy((r.random(shape) * (hi - lo) + lo).astype(np.float32)).to(dev)


@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(2, 7, 5, 37), (1, 192, 5, 19), (1, 32, 80, 304)])
def test_corr_kernel_matches_plain(dev, shape, radius):
    x, y = _normal(shape, 1, dev), _normal(shape, 2, dev)
    before = cuda_lib.LAUNCHES["corr_fwd"]
    got = tops.correlation(x, y, radius)  # 'auto' on CUDA at stride 1: the kernel
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["corr_fwd"] == before + 1
    want = tops.correlation_torch(x, y, radius)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,max_disp", [((2, 3, 9, 150), 40), ((1, 3, 320, 1216), 192)])
def test_warp_image_kernel_matches_plain(dev, shape, max_disp):
    img = _normal(shape, 3, dev)
    disp = _uniform((shape[0], 1, *shape[2:]), 4, dev, -20.0, max_disp + 40.0)
    got = tops.warp_image_cuda(img, disp, max_disp)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tops.warp_image_clamped(img, disp, max_disp), rtol=0, atol=1e-6)


@pytest.mark.parametrize(
    "shape,max_neg", [((2, 6, 4, 140), 20), ((1, 128, 10, 38), 6), ((1, 32, 80, 304), 48)]
)
def test_warp_features_kernel_matches_plain(dev, shape, max_neg):
    feats = _normal(shape, 5, dev)
    dx = _uniform((shape[0], 1, *shape[2:]), 6, dev, -max_neg - 10.0, 10.0)
    got = tops.warp_features_cuda(feats, dx, max_neg, 4)
    torch.cuda.synchronize()
    want = tops.warp_features_clamped(feats, dx, max_neg, 4)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = _normal((1, 4, 3, 8), 7, dev)
    with pytest.raises(ValueError, match="contiguous"):
        tops.correlation_cuda(x.transpose(2, 3), x.transpose(2, 3), 2)
    with pytest.raises(ValueError, match="max_disp"):
        tops.correlation_cuda(x, x, 9)
    with pytest.raises(ValueError):
        tops.warp_image_cuda(x, torch.zeros(1, 2, 3, 8, device=dev), 8)
    with pytest.raises(ValueError):
        tops.warp_features_cuda(x, torch.zeros(1, 1, 3, 8), 8, 4)  # offset on the CPU


def test_kernels_refuse_backward(dev):
    x = _normal((1, 4, 3, 8), 8, dev).requires_grad_()
    out = tops.correlation_cuda(x, x.detach(), 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        out.sum().backward()


def test_madnet_kernels_match_plain_modes(dev):
    """The whole forward, kernels against plain modes on the card, at a
    size that is not a multiple of 64 (1e-4 of the largest disparity)."""
    r = np.random.default_rng(9)
    left = torch.from_numpy((r.random((1, 60, 120, 3)) * 255).astype(np.float32)).to(dev)
    right = torch.from_numpy((r.random((1, 60, 120, 3)) * 255).astype(np.float32)).to(dev)
    fast = get_stereo_net("MADNet", seed=3)
    plain = get_stereo_net("MADNet", seed=3, corr_mode="torch", warp_mode="clamped")
    cuda_lib.reset_launches()
    with torch.no_grad():
        a, b = fast(left, right), plain(left, right)
    assert cuda_lib.LAUNCHES == {"corr_fwd": 5, "warp_image_fwd": 0, "warp_features_fwd": 4}
    for da, db in zip(a["disparities"], b["disparities"]):
        scale = max(float(db.abs().max()), 1e-6)
        torch.testing.assert_close(da, db, rtol=1e-4, atol=1e-4 * scale)
