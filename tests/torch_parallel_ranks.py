"""One rank of a two-process ``gloo`` group on the CPU, for
``tests/test_torch_parallel.py``. It imports the port only, never JAX.

    python -m tests.torch_parallel_ranks MODE RANK WORLD WORKDIR

joins the group through the file ``WORKDIR/pg`` and writes its results to
``WORKDIR/rank<RANK>.*``:

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
  step of MADNet on frame 0 (its loss, its weights, the fetches it made);
  then the width-sharded fused MAD session with the bulkhead, SEQUENTIAL,
  over frames 0-2 (its statistics, its arena, the disparity pieces, the
  fetches of its last frame); then ``step_chunk``, which a mesh session
  refuses; then the same session adapting to the proxy labels of frames
  0-2 (``frame<i>/proxy``; no reset: the random network's loss is above
  the threshold; its statistics and arena); then a vmap session of ``N_STREAMS`` streams (PROBABILITY,
  seeds 0..N-1) sharded over the ranks on the stream axis of
  ``WORKDIR/streams.npz``: the gathered statistics and weights, and this
  rank's own rows.
"""

import json
import sys
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


def run_step(rank, workdir, out):
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
    for loss_name in GLOBAL_FORM:
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


def run_spatial(rank, workdir, out):
    from real_time_self_adaptive_deep_stereo_torch.adapt import FusedOnlineSession
    from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
    from real_time_self_adaptive_deep_stereo_torch.parallel import (
        batch_sharded,
        make_mesh,
        make_spatial_adapt_step,
        shard_batch,
        width_sharded,
    )

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
    for name, p in model.named_parameters():
        out[f"step/w/{name}"] = p.detach().numpy()
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


def main():
    mode, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'pg'}", rank=rank, world_size=world)
    try:
        if mode in ("step", "spatial"):
            out = {}
            (run_step if mode == "step" else run_spatial)(rank, workdir, out)
            np.savez(workdir / f"rank{rank}.npz", **out)
        else:
            result = run_cli(workdir)
            (workdir / f"rank{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
