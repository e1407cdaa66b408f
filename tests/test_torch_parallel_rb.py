"""The data-parallel Rainbow and DRQN step loops of ``parallel.spmd``: a
world of one rank against the single-device trainers, and two gloo ranks
on the CPU against each other and against the JAX package's gradients.

* A world of one runs every collective over a group of one rank, so
  ``spmd_rainbow_chunk`` (1-step uniform, and PER 3-step) must equal
  ``rainbow_train_chunk`` bit for bit, and ``spmd_drqn_chunk`` must equal
  ``drqn_train_chunk``: rank 0 keeps the run's seed.
* On two ranks the replicated learner stays bitwise equal on both (the
  check of ``tests/test_spmd.py:98-121``), and so does Rainbow's noise
  (the JAX step draws it from ``noise_key``, a stream every device
  shares; ``tests/test_spmd.py``'s four devices keep one noise),
  ``env_steps`` and the other metrics are global, and the learn gate is
  the ranks' minimum fill: a rank whose ring could learn alone waits for
  the other.
* The gradients the two ranks apply (Adam's first moment after one learn
  from zero moments, over ``1 - b1``) equal the mean of ``jax.grad`` of
  the JAX ``rainbow_loss`` / ``drqn_loss`` over each rank's own batch (for
  Rainbow at each rank's own noise) at rtol 1e-4, atol 1e-5 of each
  tensor's largest entry (f32 sums over the batch and the atoms in
  another order), and the loss the ranks keep equals the mean of JAX's at
  the JAX tests' loss tolerances (rtol 1e-5, atol 1e-7 for Rainbow;
  rtol 1e-4 for DRQN).  Against the port's own autograd on the two
  batches the params after that step are bit for bit ``Adam((g0 + g1) /
  2)``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from merging_gym_tpu.agents import drqn as JDR
from merging_gym_tpu.agents import rainbow as JR
from merging_gym_tpu.nn import lstm as JL
from merging_gym_tpu.nn import rainbow_net as JRN
from merging_gym_tpu_torch.agents import dqn as D
from merging_gym_tpu_torch.agents import drqn as DR
from merging_gym_tpu_torch.agents import rainbow as RB
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.io.checkpoint import state_tree
from merging_gym_tpu_torch.nn.lstm import drqn_params_from_numpy
from merging_gym_tpu_torch.nn.rainbow_net import rainbow_params_from_numpy
from merging_gym_tpu_torch.parallel import mesh as M
from merging_gym_tpu_torch.parallel import multihost, spmd
from tests.test_torch_parallel import assert_tree_equal
from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_world import World, assert_results_equal

CPU = torch.device("cpu")
B1 = 0.9   # Adam's b1 (optax's default, agents.dqn's ADAM_B1)


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A world of one rank in this process, torn down after the module."""
    store = tmp_path_factory.mktemp("world1") / "store"
    multihost.initialize(f"file://{store}", 1, 0, device="cpu")
    yield M.make_mesh(1, 1)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(2, tmp_path_factory.mktemp("world2"))
    yield w
    w.close()


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


RB_CASES = {
    "uniform_1step": dict(memory_capacity=64, batch_size=8,
                          target_sync_episodes=2, opponent="selfplay"),
    "per_3step": dict(memory_capacity=64, batch_size=8,
                      target_sync_episodes=2, opponent="selfplay", per=True,
                      n_step=3),
}
RB_EP = dict(max_steps=12, random_start=True)
DR_KW = dict(memory_capacity=32, batch_size=4, target_sync=3, seq_len=4,
             burn_in=1, opponent="selfplay")
DR_EP = dict(max_steps=12, random_start=True)


# ---------------------------------------------------------------------------
# A world of one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(RB_CASES))
def test_world_of_one_rainbow_chunk_equals_rainbow_train_chunk(mesh1, case):
    kw, ep = RB_CASES[case], EnvParams(**RB_EP)
    cfg = RB.RainbowConfig(pmean_axis="data", **kw)
    got = spmd.spmd_rainbow_init(5, cfg, ep, 16, mesh1, device=CPU)
    want = RB.rainbow_train_init(5, RB.RainbowConfig(**kw), ep, 16,
                                 device=CPU)
    assert_tree_equal(state_tree(got), state_tree(want))
    for T in (9, 8):
        got = spmd.spmd_rainbow_chunk(mesh1, cfg, ep, got, T)
        want = RB.rainbow_train_chunk(RB.RainbowConfig(**kw), ep, want, T)
    assert int(want.opt_state.count) > 0 and int(want.metrics.episodes) > 0
    assert int(want.sync_chunks) > 0
    assert_tree_equal(state_tree(got), state_tree(want))


def test_world_of_one_drqn_chunk_equals_drqn_train_chunk(mesh1):
    cfg = DR.DRQNConfig(pmean_axis="data", **DR_KW)
    ep = EnvParams(**DR_EP)
    got = spmd.spmd_drqn_init(5, cfg, ep, 16, mesh1, device=CPU)
    want = DR.drqn_train_init(5, DR.DRQNConfig(**DR_KW), ep, 16, device=CPU)
    for T in (9, 8):
        got = spmd.spmd_drqn_chunk(mesh1, cfg, ep, got, T)
        want = DR.drqn_train_chunk(DR.DRQNConfig(**DR_KW), ep, want, T)
    assert int(want.learn_counter) > 3 and int(want.metrics.episodes) > 0
    assert_tree_equal(state_tree(got), state_tree(want))


@pytest.mark.parametrize("family", ["rainbow", "drqn"])
def test_pmean_axis_needs_the_mesh_groups(mesh1, family):
    """``pmean_axis`` without the group, and the group without
    ``pmean_axis``, are refused by the step."""
    if family == "rainbow":
        cfg = RB.RainbowConfig(pmean_axis="data", memory_capacity=16,
                               batch_size=4)
        carry = RB.rainbow_train_init(0, cfg, EnvParams(), 4, device=CPU)
        chunk, name = RB.rainbow_train_chunk, "spmd_rainbow_chunk"
    else:
        cfg = DR.DRQNConfig(pmean_axis="data", memory_capacity=16,
                            batch_size=4)
        carry = DR.drqn_train_init(0, cfg, EnvParams(), 4, device=CPU)
        chunk, name = DR.drqn_train_chunk, "spmd_drqn_chunk"
    with pytest.raises(ValueError, match=name):
        chunk(cfg, EnvParams(), carry, 1)
    with pytest.raises(ValueError, match="pmean_axis='data'"):
        chunk(cfg.replace(pmean_axis=None), EnvParams(), carry, 1,
              axis=mesh1.get_group("data"))


def test_drqn_ring_is_per_rank(mesh1):
    """The ring holds ``memory_capacity`` windows a rank, and only the
    per-rank flush rule applies (``drqn_train_init``'s own check is
    against the global envs)."""
    cfg = DR.DRQNConfig(pmean_axis="data", memory_capacity=4, batch_size=2)
    carry = spmd.spmd_drqn_init(0, cfg, EnvParams(), 4, mesh1, device=CPU)
    assert carry.replay.data["obs"].shape == (4, 17, 10)
    with pytest.raises(ValueError, match="per-rank memory_capacity=3 < "
                                         "local envs 4"):
        spmd.spmd_drqn_init(0, cfg.replace(memory_capacity=3), EnvParams(),
                            4, mesh1, device=CPU)


def test_pmax_and_broadcast_over_one_rank_are_the_identity(mesh1):
    g = mesh1.get_group("data")
    x = [torch.tensor([1.5, -0.0]), torch.tensor([3.25])]
    assert_tree_equal(M.broadcast(x, g), x)
    assert_tree_equal(M.pmax(torch.tensor(7), g), torch.tensor(7))


# ---------------------------------------------------------------------------
# Two ranks
# ---------------------------------------------------------------------------

def test_pmax_and_broadcast_over_two_ranks(world):
    for r in world.run("collectives_rb"):
        np.testing.assert_array_equal(r["max"], [1.0, 0.0, 2.5])
        np.testing.assert_array_equal(r["bcast"][0], [10.0, 10.0, 12.5])
        np.testing.assert_array_equal(r["bcast"][1], [0.0, 0.0])


@pytest.mark.parametrize("case", sorted(RB_CASES))
def test_rainbow_loop_two_ranks_stay_replicated(world, case):
    res = world.run("rainbow_loop", RB_CASES[case], RB_EP, 16, 8, [9, 8])
    a, b = res
    assert_results_equal(a["learner"], b["learner"], "learner")
    assert_results_equal(a["metrics"], b["metrics"], "metrics")
    assert a["env_steps"] == b["env_steps"] == [9 * 16, 17 * 16]
    assert a["learner"]["opt"]["fields"]["count"] > 0
    assert a["learner"]["sync_chunks"] > 0
    assert a["metrics"]["fields"]["episodes"] > 0
    assert (a["seed"], b["seed"]) == (8, spmd.data_seed(8, 1))
    # The noise stays replicated (JAX's shared noise_key): data rank 0's
    # fresh draws, not the first ones of the run's seed.
    assert_results_equal(a["noise"], b["noise"], "noise")
    assert not np.array_equal(a["noise"]["noisy_value1"]["w_eps"],
                              a["noise0"]["noisy_value1"]["w_eps"])
    assert not np.array_equal(a["obs"], b["obs"])
    if RB_CASES[case].get("per"):
        assert a["max_priority"] == b["max_priority"] > 1.0


def test_jax_step_loop_keeps_its_noise_replicated():
    """The reference the port's broadcast follows: JAX's ``spmd_rainbow``
    draws the noise from ``noise_key``, shared by the devices, so after a
    learning chunk every device's shard of the noise is the same."""
    from jax.sharding import Mesh

    from merging_gym_tpu.core.env import EnvParams as JEnvParams
    from merging_gym_tpu.parallel import spmd as JS

    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    cfg = JR.RainbowConfig(memory_capacity=64, batch_size=8,
                           pmean_axis="data")
    ep = JEnvParams(random_start=True)
    c0 = JS.spmd_rainbow_init(jax.random.key(8), cfg, ep, 16, mesh)
    c = JS.spmd_rainbow_chunk(mesh, cfg, ep, c0, 3)
    w = c.noise["noisy_value1"]["w_eps"]
    shards = [np.asarray(x.data) for x in w.addressable_shards]
    assert len(shards) == 2
    np.testing.assert_array_equal(shards[0], shards[1])
    assert not np.array_equal(shards[0],
                              np.asarray(c0.noise["noisy_value1"]["w_eps"]))


def test_drqn_loop_two_ranks_stay_replicated(world):
    cfg = dict(DR_KW, memory_capacity=8)
    a, b = world.run("drqn_loop", cfg, DR_EP, 16, 8, [9, 8])
    assert_results_equal(a["learner"], b["learner"], "learner")
    assert_results_equal(a["metrics"], b["metrics"], "metrics")
    assert a["env_steps"] == b["env_steps"] == [9 * 16, 17 * 16]
    assert a["learner"]["count"] > 3
    assert a["metrics"]["fields"]["episodes"] > 0
    # Eight windows a rank (memory_capacity is per rank), all filled.
    assert a["capacity"] == b["capacity"] == 8
    assert a["cursor"] == b["cursor"] == 4 * 8
    assert not np.array_equal(a["obs"], b["obs"])


def test_rainbow_learn_gate_is_global(world):
    """Rank 0 starts with a full ring and would learn at once alone; rank
    1 starts empty and passes ``batch_size`` 8 only on its second step
    (8 envs a rank): neither learns before then."""
    kw = dict(memory_capacity=64, batch_size=8)
    res = world.run("rainbow_gate", kw, 16, [64, 0], 3)
    for r, steps in enumerate(res):
        assert [s[0] for s in steps] == [0, 1, 2], (r, steps)
    # A single-device step from the same carry: rank 0 alone learns at once.
    assert [s[1] for s in res[0]] == [1, 1, 2]
    assert [s[1] for s in res[1]] == [0, 1, 2]
    assert [s[2] for s in res[1]] == [8, 16, 24]


def test_drqn_learn_gate_is_global(world):
    """Rank 1's first windows flush on step 4 (``seq_len`` 4), when its
    cursor reaches ``batch_size`` 4; rank 0's prefilled ring waits."""
    kw = dict(memory_capacity=8, batch_size=4, seq_len=4)
    res = world.run("drqn_gate", kw, 16, [8, 0], 5)
    for r, steps in enumerate(res):
        assert [s[0] for s in steps] == [0, 0, 0, 1, 2], (r, steps)
    assert [s[1] for s in res[0]] == [1, 1, 1, 1, 2]
    assert [s[2] for s in res[1]] == [0, 0, 0, 8, 8]


def _grad_check(mu, want, path):
    """The applied gradient ``mu / (1 - b1)`` against ``want``."""
    g = np.asarray(mu, np.float64) / (1.0 - B1)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-5 * scale,
                               err_msg=path)


def _port_grads(loss_fn, params):
    with torch.enable_grad():
        leaves = D._tree_map(lambda a: a.detach().requires_grad_(True),
                             params)
        flat = torch.autograd.grad(loss_fn(leaves), D._leaves(leaves))
    it = iter(flat)
    return D._tree_map(lambda _: next(it), leaves)


def _assert_adam_of_mean(got, params, g0, g1, lr):
    """``got`` (numpy) is bit for bit one Adam step on ``(g0 + g1) / 2``
    from ``params`` and zero moments."""
    mean = D._tree_map(lambda a, b: (a + b) / 2, g0, g1)
    zeros = D._tree_map(torch.zeros_like, params)
    new, _ = D._adam(params, mean, D.AdamState(
        torch.zeros((), dtype=torch.int32), zeros, zeros), lr)
    for layer in new:
        for k in new[layer]:
            np.testing.assert_array_equal(got[layer][k],
                                          new[layer][k].numpy(),
                                          f"{layer}.{k}")


def test_rainbow_gradients_are_the_mean_of_jax_grads_at_each_rank_noise(
        world):
    kw = dict(lr=1e-3, gamma=0.9, obs_scale=0.01, batch_size=16)
    jcfg, cfg = JR.RainbowConfig(**kw), RB.RainbowConfig(**kw)
    k = jax.random.split(jax.random.key(3), 6)
    params, target = (_np(JRN.rainbow_init(k[i], 10, 5)) for i in (0, 1))
    noise = [_np(JRN.rainbow_sample_noise(k[2 + r], 5)) for r in (0, 1)]
    tnoise = [_np(JRN.rainbow_sample_noise(k[4 + r], 5)) for r in (0, 1)]
    rng = np.random.default_rng(4)
    items = [{"obs": rng.normal(0, 30, (24, 10)).astype(np.float32),
              "next_obs": rng.normal(0, 30, (24, 10)).astype(np.float32),
              "action": rng.integers(0, 5, 24).astype(np.int32),
              "reward": rng.normal(0, 2, 24).astype(np.float32),
              "done": rng.random(24) < 0.3} for _ in (0, 1)]
    res = world.run("rainbow_learn", params, target, noise, tnoise, items,
                    kw)
    a, b = res
    assert_results_equal(a["params"], b["params"], "params")
    assert a["loss"] == b["loss"]
    ones = jnp.ones(cfg.batch_size, jnp.float32)
    jgrads, losses, port = [], [], []
    for r in (0, 1):
        batch = res[r]["batch"]
        assert not np.array_equal(batch["obs"], res[1 - r]["batch"]["obs"])
        (jloss, _), g = jax.value_and_grad(JR.rainbow_loss, has_aux=True)(
            params, target, noise[r], tnoise[r],
            {k2: jnp.asarray(v) for k2, v in batch.items()}, ones, jcfg)
        jgrads.append(g)
        losses.append(float(jloss))
        tb = {k2: torch.as_tensor(v) for k2, v in batch.items()}
        port.append(_port_grads(lambda p: RB.rainbow_loss(
            p, rainbow_params_from_numpy(target, CPU),
            rainbow_params_from_numpy(noise[r], CPU),
            rainbow_params_from_numpy(tnoise[r], CPU), tb,
            torch.ones(cfg.batch_size), cfg)[0],
            rainbow_params_from_numpy(params, CPU)))
    for layer in params:
        for k2 in params[layer]:
            want = (np.asarray(jgrads[0][layer][k2], np.float64)
                    + np.asarray(jgrads[1][layer][k2], np.float64)) / 2
            _grad_check(a["mu"][layer][k2], want, f"{layer}.{k2}")
    np.testing.assert_allclose(float(a["loss"]), np.mean(losses), rtol=1e-5,
                               atol=1e-7)
    _assert_adam_of_mean(a["params"], rainbow_params_from_numpy(params, CPU),
                         port[0], port[1], cfg.lr)


def test_drqn_gradients_are_the_mean_of_jax_grads(world):
    seq_len = 4
    kw = dict(lr=0.01, gamma=0.9, seq_len=seq_len, burn_in=1)
    jcfg, cfg = JDR.DRQNConfig(**kw), DR.DRQNConfig(**kw)

    def shrunk(key):
        return _np(jax.tree.map(lambda w: (w - jnp.mean(w)) * 0.4,
                                JL.drqn_init(jax.random.key(key), 10, 5)))
    params, target = shrunk(1), shrunk(2)
    rng = np.random.default_rng(6)
    batches = []
    for _ in (0, 1):
        done = np.zeros((16, seq_len), bool)
        ends = rng.integers(0, 2 * seq_len, 16)
        for i in range(16):
            if ends[i] < seq_len:
                done[i, ends[i]] = True
        batches.append({
            "obs": (rng.standard_normal((16, seq_len + 1, 10)) * 5.0
                    ).astype(np.float32),
            "action": rng.integers(0, 5, (16, seq_len)).astype(np.int32),
            "reward": rng.standard_normal((16, seq_len)).astype(np.float32),
            "done": done})
    a, b = world.run("drqn_learn", params, target, batches, kw)
    assert_results_equal(a["params"], b["params"], "params")
    jgrads, losses, port = [], [], []
    for r in (0, 1):
        loss, g = jax.value_and_grad(JDR.drqn_loss)(
            params, target, jax.tree.map(jnp.asarray, batches[r]), jcfg)
        jgrads.append(g)
        losses.append(float(loss))
        tb = {k2: torch.tensor(v) for k2, v in batches[r].items()}
        port.append(_port_grads(lambda p: DR.drqn_loss(
            p, drqn_params_from_numpy(target, CPU), tb, cfg),
            drqn_params_from_numpy(params, CPU)))
    for layer in params:
        for k2 in params[layer]:
            want = (np.asarray(jgrads[0][layer][k2], np.float64)
                    + np.asarray(jgrads[1][layer][k2], np.float64)) / 2
            _grad_check(a["mu"][layer][k2], want, f"{layer}.{k2}")
    np.testing.assert_allclose(float(a["loss"]), np.mean(losses), rtol=1e-4)
    _assert_adam_of_mean(a["params"], drqn_params_from_numpy(params, CPU),
                         port[0], port[1], cfg.lr)


def test_step_loop_carries_cut_to_the_rank():
    """The n-step history's env axis is its second (``[n, envs, ...]``);
    its ``length`` is per env."""
    ep = EnvParams()
    carry = RB.rainbow_train_init(0, RB.RainbowConfig(n_step=3), ep, 8,
                                  device=CPU)
    part = M.Sharding(1, 2)
    cut = spmd._local_rows(carry, ("nstep",), part, second_axis=True)
    assert cut.nstep.obs.shape == (3, 4, 10)
    assert cut.nstep.action.shape == cut.nstep.ret.shape == (3, 4)
    assert cut.nstep.length.shape == (4,)
    cut = spmd._local_rows(dataclasses.replace(
        carry, obs=torch.arange(80.0).reshape(8, 10)), ("obs",), part)
    np.testing.assert_array_equal(cut.obs.numpy()[:, 0], [40, 50, 60, 70])
