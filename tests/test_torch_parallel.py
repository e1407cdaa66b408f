"""The port's ``parallel/`` package in one process: the mesh, process
setup, the stream rule, sweeps, and a world of one rank against the
single-device trainers.

A world of one (gloo on the CPU, a ``FileStore`` in the test's temporary
directory) runs every collective of the SPMD trainers over a group of one
rank, so ``spmd_train_chunk`` on a (1, 1) mesh must equal
``agents.dqn.train_chunk`` bit for bit, ``spmd_hdqn_chunk`` must equal
``hdqn_train_chunk``, and the local-SGD chunks must equal the single-chip
``fused_dqn_chunk`` / ``fused_hdqn_chunk`` (K5's and K7's plain versions
here), in random mode too: rank 0 keeps the run's seed.  Sweeps hold the
rules of ``tests/test_sweep.py``: entries are independent, and an entry
equals its single run (here bit for bit).
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from merging_gym_tpu_torch.agents import dqn as D
from merging_gym_tpu_torch.agents import hdqn as H
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.io.checkpoint import state_tree
from merging_gym_tpu_torch.ops import fused_hdqn as FH
from merging_gym_tpu_torch.ops import fused_trainer as FT
from merging_gym_tpu_torch.parallel import mesh as M
from merging_gym_tpu_torch.parallel import multihost, spmd, sweep
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A world of one rank in this process, torn down after the module."""
    store = tmp_path_factory.mktemp("world1") / "store"
    multihost.initialize(f"file://{store}", 1, 0, device="cpu")
    yield M.make_mesh(1, 1)
    dist.destroy_process_group()


def assert_tree_equal(a, b, path="carry"):
    """Two carries bit for bit, through ``state_tree`` (dataclasses, dicts,
    tuples, tensors, the generators' states and the host counters)."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def test_import_starts_no_process_group():
    code = ("import torch.distributed as dist\n"
            "import merging_gym_tpu_torch.parallel.spmd, "
            "merging_gym_tpu_torch.parallel.sweep, "
            "merging_gym_tpu_torch.parallel.multihost\n"
            "assert not dist.is_initialized()\n"
            "import sys; assert 'jax' not in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.skipif(torch.cuda.is_available(), reason="the refusals of a "
                    "machine without a card")
def test_initialize_refuses_cuda_without_a_card(tmp_path):
    for kw in ({}, {"device": "cuda"}, {"device": "cuda:0"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            multihost.initialize(f"file://{tmp_path}/s", 1, 0, **kw)
    with pytest.raises(ValueError, match="NCCL needs a CUDA device"):
        multihost.initialize(f"file://{tmp_path}/s", 1, 0, device="cpu",
                             backend="nccl")
    with pytest.raises(ValueError, match="num_processes and process_id"):
        multihost.initialize("localhost:1", device="cpu")
    assert not dist.is_initialized()


def test_mesh_without_a_world_and_host_helpers():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize"):
        M.make_mesh()
    assert multihost.is_coordinator()
    assert multihost.envs_per_host(1024) == 1024
    part = M.Sharding(1, 4)
    assert part.rows(16) == slice(4, 8)
    np.testing.assert_array_equal(part.place(torch.arange(16)).numpy(),
                                  [4, 5, 6, 7])
    with pytest.raises(ValueError, match="does not divide"):
        part.rows(10)


def test_world_of_one_mesh(mesh1):
    assert tuple(mesh1.mesh.shape) == (1, 1)
    assert mesh1.mesh_dim_names == ("data", "model")
    assert M.axis_index(mesh1, "data") == M.axis_index(mesh1, "model") == 0
    assert multihost.is_coordinator()
    assert multihost.envs_per_host(96) == 96
    assert tuple(multihost.global_mesh().mesh.shape) == (1, 1)
    x = {"a": torch.arange(6.0), "b": (torch.ones(6, 2), 3)}
    assert_tree_equal(M.shard_batch(mesh1, x), x)
    assert M.replicated(mesh1) == M.Sharding(0, 1)
    assert M.data_sharding(mesh1) == M.Sharding(0, 1)
    with pytest.raises(AssertionError):
        M.make_mesh(2, 1)
    # A sum, a mean and a minimum over one rank are the identity.
    t = [torch.tensor([1.5, -2.0]), torch.tensor([3.25])]
    g = mesh1.get_group("data")
    assert_tree_equal(M.psum(t, g), t)
    assert_tree_equal(M.pmean(t, g), t)
    assert_tree_equal(M.pmin(torch.tensor(7), g), torch.tensor(7))


def test_qnet_shard_round_trip():
    g = torch.Generator().manual_seed(0)
    params = D.dqn_init(g, D.DQNConfig(), CPU).params
    for tp in (1, 2, 4):
        shards = [spmd.qnet_shard(params, m, tp) for m in range(tp)]
        assert shards[-1]["fc0"]["w"].shape == (10, 200 // tp)
        assert shards[-1]["fc1"]["w"].shape == (200 // tp, 100)
        assert_tree_equal(spmd.qnet_unshard(shards), params)
    with pytest.raises(ValueError, match="does not divide"):
        spmd.qnet_shard(params, 0, 3)


def test_data_seed_rule():
    assert spmd.data_seed(123, 0) == 123
    seeds = [spmd.data_seed(7, d) for d in range(64)]
    assert len({s & 0xFFFFFFFF for s in seeds}) == 64
    assert len({s ^ 0x5EED for s in seeds}) == 64


@pytest.mark.parametrize("opponent,extra", [
    (D.OPP_L0, {}),
    (D.OPP_SELFPLAY, {"sample_valid": True, "learns_per_step": 2}),
])
def test_world_of_one_train_chunk_equals_train_chunk(mesh1, opponent, extra):
    cfg = D.DQNConfig(memory_capacity=48, batch_size=8, target_sync=5,
                      opponent=opponent, **extra)
    ep = EnvParams(max_steps=25)
    got = spmd.spmd_train_init(5, cfg, ep, 16, mesh1, device=CPU)
    want = D.train_init(5, cfg, ep, 16, device=CPU)
    assert_tree_equal(state_tree(got), state_tree(want))
    for T in (7, 6):
        got = spmd.spmd_train_chunk(mesh1, cfg, ep, got, T)
        want = D.train_chunk(cfg, ep, want, T)
    assert int(want.dqn.learn_counter) > 0
    assert_tree_equal(state_tree(got), state_tree(want))


def test_world_of_one_hdqn_chunk_equals_hdqn_train_chunk(mesh1):
    kw = dict(memory_capacity=48, goal_memory_capacity=16, batch_size=8,
              target_sync=4, opponent=D.OPP_SELFPLAY)
    cfg = H.HDQNConfig(pmean_axis="data", **kw)
    ep = EnvParams(max_steps=20)
    got = spmd.spmd_hdqn_init(9, cfg, ep, 16, mesh1, device=CPU)
    got = spmd.spmd_hdqn_chunk(mesh1, cfg, ep, got, 12)
    want = H.hdqn_init(9, H.HDQNConfig(**kw), ep, 16, device=CPU)
    want = H.hdqn_train_chunk(H.HDQNConfig(**kw), ep, want, 12)
    assert int(want.upper.learn_counter) > 0
    assert int(want.lower.learn_counter) > 0
    assert_tree_equal(state_tree(got), state_tree(want))


def test_hdqn_pmean_axis_needs_the_mesh_groups(mesh1):
    cfg = H.HDQNConfig(pmean_axis="data", memory_capacity=32,
                       goal_memory_capacity=8, batch_size=4)
    carry = H.hdqn_init(0, cfg, EnvParams(), 4, device=CPU)
    with pytest.raises(ValueError, match="spmd_hdqn_chunk"):
        H.hdqn_train_chunk(cfg, EnvParams(), carry, 1)
    # A group without the flag is refused too.
    with pytest.raises(ValueError, match="pmean_axis='data'"):
        H.hdqn_train_chunk(cfg.replace(pmean_axis=None), EnvParams(), carry,
                           1, axis=mesh1.get_group("data"))


@pytest.mark.parametrize("greedy", [False, True])
def test_world_of_one_fused_dqn_equals_single_chip(mesh1, greedy):
    n = 128
    cfg = D.DQNConfig(lr=1e-3, target_sync=4, memory_capacity=3 * n,
                      opponent=D.OPP_SELFPLAY)
    ep = EnvParams(max_steps=25, random_start=not greedy)
    got = spmd.spmd_fused_dqn_init(0, cfg, ep, n, mesh1, device=CPU)
    want = FT.fused_dqn_init(0, cfg, ep, n, device=CPU)
    assert (got["n"], got["n_local"], got["n_global"]) == (n, n, n)
    for seed, T in ((7, 3), (8, 5)):
        got = spmd.spmd_fused_dqn_chunk(mesh1, cfg, ep, got, T, seed,
                                        greedy=greedy)
        want = FT.fused_dqn_chunk(cfg, ep, want, T, seed, greedy=greedy)
    assert want["learns"] > 0 and want["episodes"] >= 0
    assert_tree_equal({k: v for k, v in got.items()
                       if k not in ("n_local", "n_global")}, want)


def test_world_of_one_fused_hdqn_equals_single_chip(mesh1):
    n = 128
    kw = dict(lr=1e-3, target_sync=3, memory_capacity=2 * n,
              goal_memory_capacity=2 * n, opponent=D.OPP_SELFPLAY)
    ep = EnvParams(max_steps=20, random_start=True)
    got = spmd.spmd_fused_hdqn_init(0, H.HDQNConfig(**kw), ep, n, mesh1,
                                    device=CPU)
    want = FH.fused_hdqn_init(0, H.HDQNConfig(**kw), ep, n, device=CPU)
    for seed, T in ((13, 4), (14, 3)):
        got = spmd.spmd_fused_hdqn_chunk(mesh1, H.HDQNConfig(**kw), ep, got,
                                         T, seed)
        want = FH.fused_hdqn_chunk(H.HDQNConfig(**kw), ep, want, T, seed)
    assert want["lo_learns"] > 0
    assert_tree_equal({k: v for k, v in got.items()
                       if k not in ("n_local", "n_global")}, want)


def test_fused_launch_guards(mesh1):
    cfg = D.DQNConfig(memory_capacity=256)
    carry = spmd.spmd_fused_dqn_init(0, cfg, EnvParams(), 128, mesh1,
                                     device=CPU)
    with pytest.raises(ValueError, match="num_steps"):
        spmd.spmd_fused_dqn_chunk(mesh1, cfg, EnvParams(), carry, 0, 1)
    with pytest.raises(ValueError, match="greedy"):
        spmd.spmd_fused_dqn_chunk(mesh1, cfg, EnvParams(random_start=True),
                                  carry, 1, 1, greedy=True)


# ---------------------------------------------------------------------------
# Sweeps (tests/test_sweep.py)
# ---------------------------------------------------------------------------

def test_sweep_trains_configs_independently():
    cfg = D.DQNConfig(memory_capacity=64, batch_size=8, opponent=D.OPP_L0)
    params = sweep.stack_env_params([
        EnvParams(max_steps=120),
        EnvParams(max_steps=120, r_collision=-100.0),
        EnvParams(max_steps=120, vel_penalty=0.01),
    ])
    carries = sweep.sweep_train_init(0, cfg, params, num_envs=8, device=CPU)
    carries = sweep.sweep_train_chunk(cfg, params, carries, 150)
    eps = np.array([int(c.metrics.episodes) for c in carries])
    assert eps.shape == (3,) and (eps > 0).all()
    assert all(int(c.dqn.learn_counter) > 0 for c in carries)
    rewards = [round(float(c.metrics.sum_ep_reward), 4) for c in carries]
    assert len(set(rewards)) > 1
    assert all(np.isfinite(float(c.dqn.last_loss)) for c in carries)
    with pytest.raises(AssertionError):
        sweep.stack_env_params([EnvParams(), EnvParams(max_steps=10)])


def test_sweep_entry_equals_single_run():
    cfg = D.DQNConfig(memory_capacity=32, batch_size=8, opponent=D.OPP_L0)
    p0, p1 = EnvParams(), EnvParams(r_first=5.0)
    stacked = sweep.stack_env_params([p0, p1])
    carries = sweep.sweep_train_init(1, cfg, stacked, 4, device=CPU)
    carries = sweep.sweep_train_chunk(cfg, stacked, carries, 25)
    for i, p in enumerate((p0, p1)):
        single = D.train_init(spmd.data_seed(1, i), cfg, p, 4, device=CPU)
        single = D.train_chunk(cfg, p, single, 25)
        assert_tree_equal(state_tree(carries[i]), state_tree(single))
    assert carries[0].seed == 1
    assert not torch.equal(carries[0].dqn.params["fc0"]["w"],
                           carries[1].dqn.params["fc0"]["w"])


def test_learn_axis_of_one_rank_is_the_plain_learn(mesh1):
    cfg = D.DQNConfig(batch_size=8)
    g = torch.Generator().manual_seed(3)
    st = D.dqn_init(g, cfg, CPU)
    batch = {"obs": torch.randn(8, 10, generator=g),
             "action": torch.randint(0, 5, (8,), generator=g,
                                     dtype=torch.int32),
             "reward": torch.randn(8, generator=g),
             "next_obs": torch.randn(8, 10, generator=g),
             "done": torch.zeros(8, dtype=torch.bool)}
    got = D.learn(st, batch, cfg, axis=mesh1.get_group("data"))
    want = D.learn(st, batch, cfg)
    assert_tree_equal(state_tree(got), state_tree(want))
    assert dataclasses.is_dataclass(got)
