"""One rank of a two-process ``gloo`` group on the CPU, for
``tests/test_torch_parallel.py``. It imports the port only, never JAX.

    python -m tests.torch_parallel_ranks MODE RANK WORLD WORKDIR [PRECISION]

joins the group through the file ``WORKDIR/pg`` and writes its results to
``WORKDIR/rank<RANK>.*``. ``PRECISION`` is the convolution precision, set
by each rank before it builds a model, since the mode and the TF32 flags
belong to the process; given, the ranks run the paths of the precision
checks alone (below), without it the whole mode at ``highest``.

* ``step``: the sharding helpers on test arrays, then one
  ``make_dp_train_step`` step of MADNet from the weights in
  ``WORKDIR/weights.npz`` (rank 0 loads them; the other ranks start from
  other seeds, so that the broadcast shows) on this rank's piece of
  ``WORKDIR/batch.npz``: the loss, the gradient the step took and the
  weights; then one step of each other loss with a data-parallel form
  (``parallel.train.GLOBAL_FORM``) from the same weights: its loss and
  gradient.
* ``cli``: ``cli/train.py``'s ``main`` on the argv in ``WORKDIR/argv.json``,
  first without ``--dataParallel`` (which must raise), then with it.
* ``spatial``: from the weights in ``WORKDIR/weights.npz`` (rank 0's; the
  other ranks start elsewhere), on this rank's width piece of the frames in
  ``WORKDIR/frames.npz`` (``frame<i>/<key>``): one ``make_spatial_adapt_step``
  step of MADNet on frame 0 (its loss, its weights and gradient, the fetches it made);
  then the width-sharded fused MAD session with the bulkhead, SEQUENTIAL,
  over frames 0-2 (its statistics, its arena, the disparity pieces, the
  fetches of its last frame); then ``step_chunk``, which a mesh session
  refuses; then the same session adapting to the proxy labels of frames
  0-2 (``frame<i>/proxy``; no reset: the random network's loss is above
  the threshold; its statistics and arena); then a vmap session of ``N_STREAMS`` streams (PROBABILITY,
  seeds 0..N-1) sharded over the ranks on the stream axis of
  ``WORKDIR/streams.npz``: the gathered statistics and weights, and this
  rank's own rows.
* ``dispnet``: DispNet-Corr1D under width sharding, from the weights in
  ``WORKDIR/weights.npz`` on this rank's piece of the frames in
  ``WORKDIR/frames.npz`` (as in ``spatial``): ``conv2d_transpose`` alone
  on this rank's columns of the inputs in ``WORKDIR/deconv.npz`` for each
  ``DECONV_CASES`` entry (its output, and the gradients of the product
  with ``g`` with respect to its input, weight and bias); the lookups and
  the forward at the width of ``WORKDIR/wide.npz``, where rank 0's pieces
  of the frame and of the padded frame are equally wide; one ``make_spatial_adapt_step`` step on frame 0;
  the width-sharded fused MAD session over ``dispnet_full_6.json``,
  SEQUENTIAL, frames 0-2, and FULL over frames 0-1, with the reprojection
  loss; MAD over frames 0-2 with the proxy labels; a vmap session of
  ``DN_STREAMS`` streams (PROBABILITY) over the ranks on the frames of
  ``WORKDIR/streams.npz``. The fetch audits of the step and of the MAD
  session's last frame go to ``WORKDIR/rank<RANK>.json``.

With a precision: ``step`` runs the ``mean_l1`` step alone; ``spatial``
runs the step on frame 0 (its gradient too) and the MAD sessions over
frames 0-2 with the reprojection loss and with the proxy labels,
``dispnet`` the FULL session over frames 0-1 (``PRECISION_RUNS``); both
record every
exchange of the layout (``exchanges``: each fetch's tag and dtype, and a
digest of every piece sent and received, in order) and a halo of a bf16
tensor known to both ranks (``probe/*``), so that the test can hold what
arrived to what the neighbour sent, bit for bit.
"""

import hashlib
import json
import sys
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def _sharding_report(out):
    from torch.distributed.tensor import Replicate, Shard

    from real_time_self_adaptive_deep_stereo_torch.parallel import (
        batch_sharded,
        make_mesh,
        replicated,
        shard_batch,
        width_sharded,
    )

    mesh = make_mesh(device_type="cpu")
    assert replicated(mesh).placements == (Replicate(),)
    assert batch_sharded(mesh).placements == (Shard(0),)
    assert width_sharded(mesh).placements == (Shard(2),)
    even = np.arange(4 * 8 * 10 * 3, dtype=np.float32).reshape(4, 8, 10, 3)
    odd = np.arange(3 * 2 * 5 * 1, dtype=np.float32).reshape(3, 2, 5, 1)
    for name, sharding in (("batch", batch_sharded(mesh)), ("width", width_sharded(mesh)),
                           ("replicated", replicated(mesh))):
        piece = shard_batch({"x": even, "t": torch.from_numpy(odd), "n": 7, "s": np.float32(2.0),
                             "nested": [odd]}, sharding)
        assert piece["n"] == 7 and piece["s"] == np.float32(2.0)
        assert isinstance(piece["t"], torch.Tensor) and isinstance(piece["x"], np.ndarray)
        out[f"{name}_even"] = piece["x"]
        out[f"{name}_odd"] = piece["t"].numpy()
        np.testing.assert_array_equal(piece["nested"][0], piece["t"].numpy())
    return mesh


def run_step(rank, workdir, out, precision=None):
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.parallel import batch_sharded, make_dp_train_step, shard_batch
    from real_time_self_adaptive_deep_stereo_torch.parallel.train import GLOBAL_FORM

    mesh = _sharding_report(out)
    with np.load(workdir / "batch.npz") as b:
        piece = shard_batch({k: torch.from_numpy(b[k]) for k in b.files}, batch_sharded(mesh))

    def stepped(loss_name):
        model = get_stereo_net("MADNet", device="cpu", seed=100 + rank)
        if rank == 0:  # the other rank starts elsewhere: the broadcast must bring it over
            with np.load(workdir / "weights.npz") as w:
                model.load_state_dict({k: torch.from_numpy(w[k]) for k in w.files})
        step = make_dp_train_step(model, mesh, lr=1e-4, loss_name=loss_name)
        loss = step(piece)
        return model, np.float32(loss), dict(zip([n for n, _ in model.named_parameters()], step.grads))

    model, out["loss"], grads = stepped("mean_l1")
    for name, g in grads.items():
        out[f"g/{name}"] = g.numpy()
    for name, p in model.named_parameters():
        out[f"w/{name}"] = p.detach().numpy()
    for loss_name in GLOBAL_FORM if precision is None else ():
        if loss_name != "mean_l1":
            _, out[f"{loss_name}/loss"], grads = stepped(loss_name)
            for name, g in grads.items():
                out[f"{loss_name}/g/{name}"] = g.numpy()


def run_cli(workdir):
    from real_time_self_adaptive_deep_stereo_torch.cli import train

    argv = json.loads((workdir / "argv.json").read_text())
    args = train.build_argparser().parse_args(argv)
    try:
        train.main(args, device="cpu")
    except ValueError as e:
        if "--dataParallel" not in str(e):
            raise
    else:
        raise AssertionError("main ran several ranks without --dataParallel")
    args.dataParallel = True
    return train.main(args, device="cpu")


N_STREAMS = 4
BLOCK_CONFIG = "block_config/MadNet_full.json"


def _mad_engine(weights, bulkhead, adaptation="reprojection"):
    from real_time_self_adaptive_deep_stereo_torch.adapt import AdaptationEngine, blocks
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net

    model = get_stereo_net("MADNet", device="cpu", bulkhead=bulkhead)
    model.load_state_dict(weights)
    return AdaptationEngine(model, blocks.make_blocks(blocks.load_block_config(BLOCK_CONFIG), model),
                            lr=1e-4, adaptation=adaptation, device="cpu")


def _audit(layout):
    return [[*key, n] for key, n in sorted(layout.audit.items())]


# what a precision run holds to the JAX package, by rank mode: the step on
# frame 0 or not, and the width-sharded sessions (tag, mode, adaptation, frames)
PRECISION_RUNS = {
    "spatial": (True, (("mesh", "MAD", "reprojection", 3), ("proxy", "MAD", "proxy", 3))),
    "dispnet": (False, (("full", "FULL", "reprojection", 2),)),
}


def _digest(t):
    return hashlib.sha1(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()).hexdigest()


@contextmanager
def _recorded_exchanges(log):
    """Every fetch of the layout, in order, as ``["fetch", tag, dtype]``,
    and every exchange as ``["exchange", sent, received]``, each piece
    ``[peer, dtype, shape, digest]``: the ranks make their exchanges in
    one order, so the i-th of one rank pairs with the i-th of the other."""
    from real_time_self_adaptive_deep_stereo_torch.parallel.spatial import Layout

    fetch, exchange = Layout.fetch, Layout._exchange

    def recorded_fetch(self, x, dim, owned, spans, tag):
        log.append(["fetch", tag, str(x.dtype)])
        return fetch(self, x, dim, owned, spans, tag)

    def recorded_exchange(self, sends, recvs, like):
        got = exchange(self, sends, recvs, like)
        log.append(["exchange"] + [[[s, str(t.dtype), list(t.shape), _digest(t)] for s, t in sorted(pieces.items())]
                                   for pieces in (sends, got)])
        return got

    Layout.fetch, Layout._exchange = recorded_fetch, recorded_exchange
    try:
        yield log
    finally:
        Layout.fetch, Layout._exchange = fetch, exchange


def _halo_probe(group, out):
    """A halo of 3 and 5 columns of a bf16 tensor that both ranks make
    from one seed, each holding its piece: what arrived, and the whole
    tensor to hold it to."""
    from real_time_self_adaptive_deep_stereo_torch.parallel.spatial import Layout

    whole = torch.randn(1, 4, 3, 128, generator=torch.Generator().manual_seed(5)).bfloat16()
    layout = Layout(group, 128)
    lo, hi = layout.range(128)
    out["probe/whole"] = whole.view(torch.int16).numpy()
    got = layout.halo(whole[..., lo:hi].clone(), 3, 3, 5, "probe")
    out["probe/dtype"] = np.array(str(got.dtype))
    out["probe/halo"] = got.view(torch.int16).numpy()
    out["probe/span"] = np.array([lo - 3, hi + 5])


def _session_runs(runs, make_engine, weights, frames, proxies, mesh, out, audits):
    """The width-sharded fused sessions of ``runs`` (SEQUENTIAL, no
    reset): statistics, arena and every frame's disparity piece."""
    from real_time_self_adaptive_deep_stereo_torch.adapt import FusedOnlineSession
    from real_time_self_adaptive_deep_stereo_torch.parallel import shard_batch, width_sharded

    for tag, mode, adaptation, n in runs:
        sess = FusedOnlineSession(make_engine(weights, adaptation), mode=mode, sample_mode="SEQUENTIAL",
                                  max_steps=8, seed=0, ssim_th=1e9, mesh=mesh)
        for i in range(n):
            if i == n - 1:
                sess._layout.audit.clear()
            f = frames[i] if adaptation == "reprojection" else {**frames[i], "proxy": proxies[i]}
            sess.step(shard_batch(f, width_sharded(mesh)))
            out[f"{tag}/disp{i}"] = sess.last_disp.float().numpy().copy()
            out[f"{tag}/disp_dtype"] = np.array(str(sess.last_disp.dtype))
        audits[f"{tag}_frame"] = _audit(sess._layout)
        for k, v in sess.finalize().items():
            out[f"{tag}/{k}"] = np.asarray(v)
        out[f"{tag}/flat"] = sess.arena.flat.numpy()


def _precision_run(mode, model_name, rank, workdir, out, make_engine):
    """A precision run of rank mode ``mode``: the step on frame 0 (its
    loss, weights and gradient) and the sessions of ``PRECISION_RUNS``,
    every exchange recorded; then the bf16 halo probe."""
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.parallel import make_mesh, make_spatial_adapt_step, shard_batch, width_sharded

    mesh = make_mesh(device_type="cpu")
    with np.load(workdir / "weights.npz") as w:
        weights = {k: torch.from_numpy(w[k]) for k in w.files}
    with np.load(workdir / "frames.npz") as f:
        frames = [{k: f[f"frame{i}/{k}"] for k in ("left", "right", "target")} for i in range(3)]
        proxies = [f[f"frame{i}/proxy"] for i in range(3)]
    audits, log = {}, []
    with_step, runs = PRECISION_RUNS[mode]
    with _recorded_exchanges(log):
        if with_step:
            model = get_stereo_net(model_name, device="cpu", seed=100 + rank)
            if rank == 0:
                model.load_state_dict(weights)
            step = make_spatial_adapt_step(model, mesh, lr=1e-4)
            out["step/loss"] = np.float32(step(shard_batch(frames[0], width_sharded(mesh))))
            for (name, p), g in zip(model.named_parameters(), step.grads):
                out[f"step/w/{name}"] = p.detach().numpy()
                out[f"step/g/{name}"] = g.numpy()
            audits["step"] = _audit(step.layout)
        _session_runs(runs, make_engine, weights, frames, proxies, mesh, out, audits)
    audits["exchanges"] = log
    _halo_probe(mesh.get_group("data"), out)
    (workdir / f"rank{rank}.json").write_text(json.dumps(audits))


def run_spatial(rank, workdir, out, precision=None):
    from real_time_self_adaptive_deep_stereo_torch.adapt import FusedOnlineSession
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.parallel import (
        batch_sharded,
        make_mesh,
        make_spatial_adapt_step,
        shard_batch,
        width_sharded,
    )

    if precision is not None:
        return _precision_run("spatial", "MADNet", rank, workdir, out, lambda w, a: _mad_engine(w, True, a))
    mesh = make_mesh(device_type="cpu")
    with np.load(workdir / "weights.npz") as w:
        weights = {k: torch.from_numpy(w[k]) for k in w.files}
    with np.load(workdir / "frames.npz") as f:
        frames = [{k: f[f"frame{i}/{k}"] for k in ("left", "right", "target")} for i in range(3)]
        proxies = [f[f"frame{i}/proxy"] for i in range(3)]
    pieces = [shard_batch(f, width_sharded(mesh)) for f in frames]
    audits = {}

    model = get_stereo_net("MADNet", device="cpu", seed=100 + rank)
    if rank == 0:  # the other rank starts elsewhere: the broadcast must bring it over
        model.load_state_dict(weights)
    step = make_spatial_adapt_step(model, mesh, lr=1e-4)
    out["step/loss"] = np.float32(step(pieces[0]))
    for (name, p), g in zip(model.named_parameters(), step.grads):
        out[f"step/w/{name}"] = p.detach().numpy()
        out[f"step/g/{name}"] = g.numpy()
    audits["step"] = _audit(step.layout)

    sess = FusedOnlineSession(_mad_engine(weights, True), mode="MAD", sample_mode="SEQUENTIAL", max_steps=8,
                              seed=0, mesh=mesh)
    for i, piece in enumerate(pieces):
        if i == len(pieces) - 1:
            sess._layout.audit.clear()
        sess.step(piece)
        out[f"mesh/disp{i}"] = sess.last_disp.numpy().copy()
    audits["mesh_frame"] = _audit(sess._layout)
    for k, v in sess.finalize().items():
        out[f"mesh/{k}"] = np.asarray(v)
    out["mesh/flat"] = sess.arena.flat.numpy()
    try:
        sess.step_chunk({k: v[None] for k, v in pieces[0].items()})
    except ValueError as e:
        audits["step_chunk"] = str(e)

    sess = FusedOnlineSession(_mad_engine(weights, True, "proxy"), mode="MAD", sample_mode="SEQUENTIAL",
                              max_steps=8, seed=0, ssim_th=1e9, mesh=mesh)
    for f, proxy in zip(frames, proxies):
        sess.step(shard_batch({**f, "proxy": proxy}, width_sharded(mesh)))
    for k, v in sess.finalize().items():
        out[f"proxy/{k}"] = np.asarray(v)
    out["proxy/flat"] = sess.arena.flat.numpy()

    with np.load(workdir / "streams.npz") as f:
        streams = [{k: f[f"frame{i}/{k}"] for k in ("left", "right", "target")} for i in range(3)]
    sess = FusedOnlineSession(_mad_engine(weights, True), mode="MAD", sample_mode="PROBABILITY", max_steps=8,
                              seed=list(range(N_STREAMS)), ssim_th=1e9, num_streams=N_STREAMS, mesh=mesh)
    assert sess.stream_impl == "vmap"  # "auto" under a mesh
    for f in streams:
        sess.step(shard_batch(f, batch_sharded(mesh)))
    out["streams/rows"] = sess.arena.flat.numpy().copy()
    for k, v in sess.finalize().items():
        out[f"streams/{k}"] = np.asarray(v)
    out["streams/conv1"] = sess.current_params()["pyramid.conv1.weight"].numpy()
    (workdir / f"rank{rank}.json").write_text(json.dumps(audits))


DN_BLOCK_CONFIG = "block_config/dispnet_full_6.json"
DN_STREAMS = 2
# (k, stride, the input's global width) of the transposed convolutions
# checked alone: DispNet's 4x4 stride 2, other widths, kernels narrower
# than the stride, and strides 1 and 4
DECONV_CASES = [(4, 2, 24), (3, 2, 24), (5, 2, 12), (2, 2, 48), (1, 2, 24), (3, 1, 24), (4, 4, 12), (3, 4, 6)]


def _dn_engine(weights, adaptation="reprojection"):
    from real_time_self_adaptive_deep_stereo_torch.adapt import AdaptationEngine, blocks
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net

    model = get_stereo_net("Dispnet", device="cpu")
    model.load_state_dict(weights)
    return AdaptationEngine(model, blocks.make_blocks(blocks.load_block_config(DN_BLOCK_CONFIG), model),
                            lr=1e-4, adaptation=adaptation, device="cpu")


def _deconv_pieces(layout, workdir, out):
    from real_time_self_adaptive_deep_stereo_torch.ops import conv2d_transpose
    from real_time_self_adaptive_deep_stereo_torch.parallel.spatial import sharded

    with np.load(workdir / "deconv.npz") as d:
        for i, (k, stride, w) in enumerate(DECONV_CASES):
            lo, hi = layout.range(w)
            olo, ohi = layout.range(w * stride)
            x = torch.from_numpy(d[f"{i}/x"][..., lo:hi]).requires_grad_(True)
            weight = torch.from_numpy(d[f"{i}/w"]).requires_grad_(True)
            bias = torch.from_numpy(d[f"{i}/b"]).requires_grad_(True)
            with sharded(layout):
                y = conv2d_transpose(x, weight, bias, stride)
            (y * torch.from_numpy(d[f"{i}/g"][..., olo:ohi])).sum().backward()
            out[f"deconv{i}/y"] = y.detach().numpy()
            for name, t in (("x", x), ("w", weight), ("b", bias)):
                out[f"deconv{i}/d{name}"] = t.grad.numpy()


def run_dispnet(rank, workdir, out, precision=None):
    from real_time_self_adaptive_deep_stereo_torch.adapt import FusedOnlineSession
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.parallel import (
        batch_sharded,
        make_mesh,
        make_spatial_adapt_step,
        shard_batch,
        width_sharded,
    )
    from real_time_self_adaptive_deep_stereo_torch.parallel.spatial import Layout, sharded

    if precision is not None:
        return _precision_run("dispnet", "Dispnet", rank, workdir, out, _dn_engine)
    mesh = make_mesh(device_type="cpu")
    group = mesh.get_group("data")
    with np.load(workdir / "weights.npz") as w:
        weights = {k: torch.from_numpy(w[k]) for k in w.files}
    with np.load(workdir / "frames.npz") as f:
        frames = [{k: f[f"frame{i}/{k}"] for k in ("left", "right", "target")} for i in range(3)]
        proxies = [f[f"frame{i}/proxy"] for i in range(3)]
    pieces = [shard_batch(f, width_sharded(mesh)) for f in frames]
    audits = {}

    _deconv_pieces(Layout(group, frames[0]["left"].shape[2]), workdir, out)

    with np.load(workdir / "wide.npz") as f:
        wide = shard_batch({k: torch.from_numpy(f[k]) for k in f.files}, width_sharded(mesh))
    layout = Layout.for_pieces(group, wide["left"].shape[2])
    model = get_stereo_net("Dispnet", device="cpu")
    model.load_state_dict(weights)
    piece = lambda w: layout.range(w)[1] - layout.range(w)[0]  # noqa: E731
    out["wide/cannot_tell"] = np.bool_(piece(layout.width) == piece(layout.padded))
    out["wide/lookups"] = np.array([layout.global_width(piece(layout.width)),
                                    layout.global_width(piece(layout.padded), pyramid=True),
                                    layout.global_width(piece(layout.padded // 2), pyramid=True)])
    out["wide/padded_piece"] = np.int64(layout.global_width(piece(layout.padded)))  # read as the frame's
    with torch.no_grad(), sharded(layout):
        inside = {k: layout.enter(v) for k, v in wide.items()}
        out["wide/disp"] = layout.leave(model(inside["left"], inside["right"])["full_res_disp"]).numpy()

    model = get_stereo_net("Dispnet", device="cpu", seed=100 + rank)
    if rank == 0:  # the other rank starts elsewhere: the broadcast must bring it over
        model.load_state_dict(weights)
    step = make_spatial_adapt_step(model, mesh, lr=1e-4)
    out["step/loss"] = np.float32(step(pieces[0]))
    for name, p in model.named_parameters():
        out[f"step/w/{name}"] = p.detach().numpy()
    audits["step"] = _audit(step.layout)

    runs = (("mesh", "MAD", "reprojection", 3), ("full", "FULL", "reprojection", 2), ("proxy", "MAD", "proxy", 3))
    for tag, mode, adaptation, n in runs:
        sess = FusedOnlineSession(_dn_engine(weights, adaptation), mode=mode, sample_mode="SEQUENTIAL",
                                  max_steps=8, seed=0, ssim_th=1e9, mesh=mesh)
        for i in range(n):
            if i == n - 1:
                sess._layout.audit.clear()
            f = frames[i] if adaptation == "reprojection" else {**frames[i], "proxy": proxies[i]}
            sess.step(shard_batch(f, width_sharded(mesh)))
            out[f"{tag}/disp{i}"] = sess.last_disp.numpy().copy()
        audits[f"{tag}_frame"] = _audit(sess._layout)
        for k, v in sess.finalize().items():
            out[f"{tag}/{k}"] = np.asarray(v)
        out[f"{tag}/flat"] = sess.arena.flat.numpy()

    with np.load(workdir / "streams.npz") as f:
        streams = [{k: f[f"frame{i}/{k}"] for k in ("left", "right", "target")} for i in range(2)]
    sess = FusedOnlineSession(_dn_engine(weights), mode="MAD", sample_mode="PROBABILITY", max_steps=8,
                              seed=list(range(DN_STREAMS)), ssim_th=1e9, num_streams=DN_STREAMS, mesh=mesh)
    assert sess.stream_impl == "vmap"
    for f in streams:
        sess.step(shard_batch(f, batch_sharded(mesh)))
    out["streams/rows"] = sess.arena.flat.numpy().copy()
    for k, v in sess.finalize().items():
        out[f"streams/{k}"] = np.asarray(v)
    out["streams/flat"] = sess._gather_rows(sess.arena.flat).numpy()
    (workdir / f"rank{rank}.json").write_text(json.dumps(audits))


def main():
    from real_time_self_adaptive_deep_stereo_torch.ops import set_conv_precision

    mode, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    precision = sys.argv[5] if len(sys.argv) > 5 else None
    torch.set_num_threads(1)
    set_conv_precision(precision or "highest")  # per process: before any model is built
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'pg'}", rank=rank, world_size=world)
    try:
        if mode in ("step", "spatial", "dispnet"):
            out = {}
            {"step": run_step, "spatial": run_spatial, "dispnet": run_dispnet}[mode](rank, workdir, out, precision)
            np.savez(workdir / f"rank{rank}.npz", **out)
        else:
            result = run_cli(workdir)
            (workdir / f"rank{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
