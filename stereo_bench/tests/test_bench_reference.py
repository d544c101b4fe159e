"""The plain reference against the port on the CPU at a small size: the
parameter shapes, both models' forwards, the loss, and a MAD and a FULL
step."""

import pytest
import torch

from stereo_bench import video, weights
from stereo_bench.reference import loss as L
from stereo_bench.reference import models as M
from stereo_bench.reference.session import PlainStream
from stereo_bench.spec import Cell

H, W = 64, 128
CONFIGS = {"MADNet": "madnet-mad-stream", "Dispnet": "dispnet-full-stream"}


def _port_model(name, bulkhead=False):
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net

    kw = {"warp_mode": "clamped", "bulkhead": bulkhead} if name == "MADNet" else {}
    return get_stereo_net(name, device="cpu", corr_mode="torch", **kw)


def _setup(name, seed=5, bulkhead=False):
    cfg = Cell(CONFIGS[name]).config
    w0 = weights.make_weights(M.MODELS[name][2](), cfg["weights"], seed, "cpu")
    model = _port_model(name, bulkhead)
    model.load_state_dict(w0)
    left, right = video.make_video(seed, 0, 2, H, W, "cpu", max_disp=12.0)
    return cfg, w0, model, left[:1], right[:1]


@pytest.mark.parametrize("name", ["MADNet", "Dispnet"])
def test_shapes_are_the_ports(name):
    model = _port_model(name)
    assert dict(M.MODELS[name][2]()) == {k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name", ["MADNet", "Dispnet"])
def test_forward_matches_the_port(name):
    _, w0, model, left, right = _setup(name)
    with torch.no_grad():
        ours = M.MODELS[name][0](w0, left, right)
        theirs = model(left, right)["disparities"]
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    assert 5.0 < float(ours[-1].mean()) < 60.0  # the tamed outputs predict tens of pixels


def test_loss_matches_the_port():
    from real_time_self_adaptive_deep_stereo_torch.losses import get_reprojection_loss

    _, w0, _, left, right = _setup("MADNet")
    with torch.no_grad():
        disp = M.madnet(w0, left, right)[-1]
    theirs = get_reprojection_loss("mean_SSIM_l1", warp_mode="clamped")([disp], {"left": left, "right": right})
    ours = L.reprojection_loss(disp, left, right)
    # both agree to 1e-13 in float64; in float32 the variances of the 3x3
    # windows (E[x^2] - E[x]^2) cancel, and the port's pooling order reads
    # about 2e-5 of the loss off the float64 value here
    assert abs(float(ours) - float(theirs)) <= 1e-4 * float(theirs)
    assert 0.05 < float(ours) < 0.5  # below the reset threshold


@pytest.mark.parametrize("name,mode", [("MADNet", "MAD"), ("Dispnet", "FULL")])
def test_step_matches_the_engine(name, mode):
    from real_time_self_adaptive_deep_stereo_torch.adapt import AdaptationEngine, make_blocks

    cfg, w0, model, left, right = _setup(name, bulkhead=mode == "MAD")
    engine = AdaptationEngine(model, make_blocks(cfg["blocks"], model), lr=1e-4, device="cpu", warp_mode="clamped")
    blocks = M.block_names(name, cfg["blocks"], list(w0))
    plain = PlainStream(name, blocks, w0, w0, mode, 1e-4, 0.9, 0.5, mode == "MAD", None)
    frame = {"left": left, "right": right, "target": torch.zeros(1, H, W, 1)}  # the metrics' ground truth
    if mode == "MAD":
        k = 2
        plain.draw = lambda: k
        engine.adapt_block(k, frame)
    else:
        engine.adapt_full(frame)
    plain.step(left, right)
    # the first step's momentum is its gradient: each leaf's against the
    # reference's, relative to the larger of that leaf's norm and the median
    # leaf's (an update of lr * g is under the weights' own rounding)
    acc = engine.opt["acc"]
    trained = blocks[k] if mode == "MAD" else list(w0)
    norms = sorted(float(plain.acc[n].norm()) for n in trained)
    median = norms[len(norms) // 2]
    for n in w0:
        gap = float((acc[n] - plain.acc[n]).norm()) / max(float(plain.acc[n].norm()), median)
        assert gap <= 1e-3, (n, gap)
        assert (float(plain.acc[n].abs().max()) > 0) == (n in trained), n
