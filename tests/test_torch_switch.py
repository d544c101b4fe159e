"""The fused session's block switch on the CPU: the plain lookup that the
switch kernel (``csrc/graph_switch.cu``) computes on the card, the
session's host side of it, and the warm-up's snapshot of the state.

The JAX fused session trains the blocks of a draw by ``lax.switch`` over
the draw's ids; the port's switch trains the branch its lookup names. So
draws of both samplers (the port's ``_sample`` from a seeded generator,
the JAX ``_sample`` from seeded keys, on scores made with numpy) must each
name the branch of the draw's sorted, distinct ids, and every id set that
is no draw must name none. The snapshot is compared bit for bit. On the
card, ``tests/test_torch_cuda.py`` holds the kernel against this lookup
and the switched session against its eager twin.
"""

import itertools
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_self_adaptive_deep_stereo_torch.adapt import AdaptationEngine, FusedOnlineSession
from real_time_self_adaptive_deep_stereo_torch.adapt import blocks as tblocks
from real_time_self_adaptive_deep_stereo_torch.models import get_stereo_net
from real_time_self_adaptive_deep_stereo_torch.ops import cuda_lib
from real_time_self_adaptive_deep_stereo_torch.ops.graph_switch import (
    MAX_BLOCKS,
    GraphSwitch,
    branch_sets,
    branch_table,
    switch_index_torch,
)
from real_time_self_adaptive_deep_stereo_tpu.adapt.fused import FusedOnlineSession as JaxFused

BLOCK_CONFIG = "block_config/MadNet_full.json"
H, W = 32, 64
DRAWS = 2000


@pytest.mark.parametrize("n,m", [(5, 1), (5, 2), (5, 3), (6, 1), (6, 2), (6, 3)])
def test_every_block_set_has_its_own_branch(n, m):
    """Each sorted m-subset of n blocks, in any order of its ids, names
    its own index in [0, C(n, m)): the index of the subset in
    ``branch_sets``."""
    sets = branch_sets(n, m)
    assert len(sets) == math.comb(n, m) and all(list(s) == sorted(set(s)) for s in sets)
    table = branch_table(n, m)
    assert table.dtype == torch.int32 and table.numel() == 2**n
    assert sorted(table[table >= 0].tolist()) == list(range(len(sets)))
    for k, ks in enumerate(sets):
        orders = torch.tensor(list(itertools.permutations(ks)), dtype=torch.int32)
        assert switch_index_torch(orders, table, n).tolist() == [k] * len(orders)


def _port_draws(mode, m, n, seed):
    stub = SimpleNamespace(n_actions=n, num_blocks=m, sample_mode=mode, fixed_id=0, sample_frequency=1)
    scores = np.random.default_rng(seed).normal(size=(DRAWS, n)).astype(np.float32)
    gen = torch.Generator().manual_seed(seed)
    return torch.stack(
        [FusedOnlineSession._sample(stub, torch.from_numpy(s), gen, i) for i, s in enumerate(scores)]
    )


def _jax_draws(mode, m, n, seed):
    stub = SimpleNamespace(n_actions=n, num_blocks=m, sample_mode=mode, fixed_id=0, sample_frequency=1)
    scores = np.random.default_rng(seed).normal(size=(DRAWS, n)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), DRAWS)
    ids = jax.vmap(lambda s, k: JaxFused._sample(stub, s, k, 0))(jnp.asarray(scores), keys)
    return torch.from_numpy(np.array(ids))


@pytest.mark.parametrize("sampler", ["port", "jax"])
@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("mode", ["PROBABILITY", "RANDOM", "ARGMAX"])
def test_draws_name_the_branch_of_their_blocks(mode, m, sampler):
    """2000 draws of a sampler over MADNet's 5 blocks, on seeded scores:
    each names the branch whose blocks are the draw's sorted distinct ids,
    the set the host path trains and the JAX session's switches train."""
    n = 5
    ids = (_port_draws if sampler == "port" else _jax_draws)(mode, m, n, seed=17 + m)
    assert ids.dtype == torch.int32 and tuple(ids.shape) == (DRAWS, m)
    index = switch_index_torch(ids, branch_table(n, m), n).tolist()
    sets = branch_sets(n, m)
    assert all(k >= 0 for k in index)
    assert [sets[k] for k in index] == [tuple(sorted(set(row))) for row in ids.tolist()]
    if mode != "ARGMAX":  # every branch is drawn
        assert set(index) == set(range(len(sets)))


@pytest.mark.parametrize("ids", [[1, 1], [0, 5], [-1, 2], [7, 7]])
def test_ids_of_no_branch_give_the_marker(ids):
    """Repeated ids and ids out of [0, n) name no branch: -1, the value
    on which the kernel runs no step and raises its error counter."""
    n, m = 5, 2
    got = switch_index_torch(torch.tensor([ids], dtype=torch.int32), branch_table(n, m), n)
    assert got.tolist() == [-1]


def test_table_refuses_what_the_kernel_cannot_hold():
    with pytest.raises(ValueError):
        branch_table(MAX_BLOCKS + 1, 1)
    with pytest.raises(ValueError):
        branch_table(3, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        GraphSwitch([[0]], [torch.zeros(1, dtype=torch.int32)], 1, branch_table(1, 1))


def _session(optimizer="momentum", **kw):
    model = get_stereo_net("MADNet", bulkhead=True, seed=0, device="cpu")
    blocks = tblocks.make_blocks(tblocks.load_block_config(BLOCK_CONFIG), model)
    eng = AdaptationEngine(model, blocks, lr=1e-2, optimizer=optimizer, device="cpu")
    return FusedOnlineSession(eng, mode="MAD", ssim_th=1e9, max_steps=8, **kw)


def _frames(n, seed, streams=0):
    r = np.random.default_rng(seed)
    lead = (streams,) if streams else ()
    return [
        {
            "left": (r.random(lead + (1, H, W, 3)) * 255).astype(np.float32),
            "right": (r.random(lead + (1, H, W, 3)) * 255).astype(np.float32),
            "target": np.full(lead + (1, H, W, 1), 4.0, np.float32),
        }
        for _ in range(n)
    ]


@pytest.mark.parametrize(
    "kw",
    [dict(optimizer="momentum"), dict(optimizer="adam", arena=False), dict(num_streams=2, num_blocks=2)],
    ids=["momentum", "adam-no-arena", "streams-two-blocks"],
)
def test_warm_up_snapshot_restores_every_state_tensor(kw):
    """What the switch's warm-up does at its first frame, on an eager CPU
    session: snapshot, an eager step of every branch of every stream
    (which moves the state), restore. Every tensor a step writes is then
    bit for bit what it was, and so is the module's every parameter."""
    streams = kw.get("num_streams", 0)
    sess = _session(sample_mode="PROBABILITY", seed=3, **kw)
    frames = _frames(3, 5, streams)
    for f in frames[:2]:
        sess.step(f)
    before = [t.clone() for t in sess._state_tensors()]
    params = {k: v.clone() for k, v in sess.engine.model.state_dict().items()}
    saved = sess._snapshot()
    bufs = sess._load_frame(frames[2])
    for st in sess._streams:
        for ks in sess._branch_sets:
            sess._stream_step(st, ("mad", ks), bufs)
    moved = [not torch.equal(a, b) for a, b in zip(sess._state_tensors(), before)]
    assert sum(moved) >= 5  # weights, optimizer slots, scores, losses, step count
    sess._restore(saved)
    after = sess._state_tensors()
    # the switched disparity, made by the first run (the streams' by their first step)
    assert len(after) == len(before) + (0 if streams else 1)
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    if streams:
        sess.arena.bind(0)
    assert all(torch.equal(v, params[k]) for k, v in sess.engine.model.state_dict().items())


def test_eager_path_picks_the_branch_by_the_lookup_and_refuses_no_branch():
    """The eager path reads the draw and trains the lookup's branch; a draw
    that names no branch raises instead of training another set."""
    sess = _session(sample_mode="RANDOM", num_blocks=2, seed=1)
    frames = _frames(2, 6)
    sess.step(frames[0])
    assert sess._host_blocks == tuple(sorted(sess.cur_blocks.tolist()))
    sess._sample = lambda *a: torch.tensor([3, 3], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="name no branch"):
        sess.step(frames[1])


def test_switched_session_reads_nothing_on_the_host_and_counts_taken_branches():
    """The host side of a switched session, on the CPU with the switch
    stood in for: sampled train frames dispatch the switch branch and set
    no host blocks; ``_host_blocks`` raises where graphs replay; and
    ``sync_launches`` adds each branch's captured launches times the
    branch's count on the device, once."""
    sess = _session(sample_mode="PROBABILITY", seed=2)
    sess._switching = True
    assert sess._pick_branches(0) == [("switch",)]
    assert sess._streams[0].host_blocks == ()
    with pytest.raises(RuntimeError, match="cur_blocks"):
        FusedOnlineSession._host_blocks.fget(SimpleNamespace(use_graphs=True))

    taken = [torch.tensor([[2, 0, 1, 0, 0]]), torch.zeros(1, 5, dtype=torch.int64)]
    stand_in = SimpleNamespace(taken=lambda: taken.pop(0))
    keys = [[("mad", ks) for ks in sess._branch_sets]]
    sess.graph_launches = {key: {"corr_fwd": 5, "corr_bwd": 1, "warp_features_bwd": min(k, 1)}
                           for k, key in enumerate(keys[0])}
    sess._switch = (stand_in, keys)
    cuda_lib.reset_launches()
    sess.sync_launches()
    assert {k: v for k, v in cuda_lib.LAUNCHES.items() if v} == {"corr_fwd": 15, "corr_bwd": 3,
                                                                 "warp_features_bwd": 1}
    sess.sync_launches()  # nothing taken since
    assert cuda_lib.LAUNCHES["corr_fwd"] == 15
    cuda_lib.reset_launches()
