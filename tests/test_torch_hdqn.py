"""The port's h-DQN step loop and hierarchical policy against
``merging_gym_tpu/agents/hdqn.py`` and ``agents/policies.hdqn_policy``.

``goal_status`` and ``goal_obs`` are held exactly.  The step loop's
actors (K4's plain version here) draw from other random streams than
JAX's, so a learning run is held on its counters, as
``tests/test_hdqn.py`` holds JAX's; and with ``epsilon = 40`` both
packages' actors are greedy (JAX keeps the argmax where ``randn() <=
40``; the port where a uint32 draw is below Phi(40) * 2**32, which rounds
to the top of the range) and with both capacities above n * T no learn
changes a net, so a whole chunk from the same nets and race starts must
take the same goals, options and actions: held exactly on every discrete
quantity (goals, option flags, actions, done flags, cursors, counters)
and on the floats at the port's f32 allowance against XLA:CPU (obs at
atol 1e-3, returns at 1e-4; ROADMAP Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merging_gym_tpu.agents import hdqn as JH
from merging_gym_tpu.agents import policies as JP
from merging_gym_tpu.core import env as jax_env
from merging_gym_tpu.core.env import EnvParams as JEnvParams
from merging_gym_tpu.nn.mlp import qnet_apply as jax_qnet_apply
from merging_gym_tpu.nn.mlp import qnet_init as jax_qnet_init
from merging_gym_tpu_torch.agents import dqn as D
from merging_gym_tpu_torch.agents import hdqn as H
from merging_gym_tpu_torch.agents import policies as P
from merging_gym_tpu_torch.core import env as core_env
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.nn.mlp import qnet_apply, qnet_params_from_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _obs_rows(rng, n):
    o = rng.standard_normal((n, 10)).astype(np.float32) * 30.0
    o[:, 9] = np.abs(o[:, 9])  # v2 >= 0, as in the env
    return o


def test_goal_status_truth_table_and_random_obs():
    """tests/test_hdqn.py:13-33, then 4,096 random obs against JAX."""
    def mk(dx1, v2):
        o = np.zeros(10, np.float32)
        o[0], o[9] = dx1, v2
        return o

    cases = [(mk(-11.0, 20.0), 0), (mk(-10.0, 20.0), 1), (mk(0.0, 20.0), 1),
             (mk(9.99, 20.0), 1), (mk(10.0, 20.0), 2), (mk(50.0, 20.0), 2),
             (mk(0.0, 0.0), 2), (mk(-0.1, 0.0), 0)]
    obs = np.stack([c[0] for c in cases])
    got = H.goal_status(torch.as_tensor(obs))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), [c[1] for c in cases])
    obs = _obs_rows(np.random.default_rng(0), 4096)
    obs[:64, 0] = -0.5 * obs[:64, 9]  # on the boundaries
    obs[64:128, 0] = 0.5 * obs[64:128, 9]
    np.testing.assert_array_equal(H.goal_status(torch.as_tensor(obs)).numpy(),
                                  np.asarray(JH.goal_status(obs)))


def test_goal_obs_shape_and_order():
    obs = torch.arange(10, dtype=torch.float32)
    go = H.goal_obs(torch.tensor(2, dtype=torch.int32), obs)
    assert go.shape == (11,) and go[0] == 2.0 and go[1] == 0.0
    g_b = torch.tensor([0, 1, 2, 1], dtype=torch.int32)
    go_b = H.goal_obs(g_b, obs.repeat(4, 1))
    assert go_b.shape == (4, 11) and go_b.dtype == torch.float32
    np.testing.assert_array_equal(go_b[:, 0].numpy(), [0, 1, 2, 1])
    np.testing.assert_array_equal(
        go_b.numpy(), np.asarray(JH.goal_obs(jnp.asarray(g_b.numpy()),
                                             jnp.asarray(go_b[:, 1:]))))


def _jax_nets(seed):
    upper = jax_qnet_init(jax.random.key(seed), 10, 3)
    lower = jax_qnet_init(jax.random.key(seed + 1), 11, 5)
    return (jax.tree.map(np.asarray, upper), jax.tree.map(np.asarray, lower))


def test_hdqn_policy_matches_jax():
    upper, lower = _jax_nets(3)
    obs = _obs_rows(np.random.default_rng(1), 512)
    pol = JP.hdqn_policy(upper, lower, greedy=True)
    want = np.asarray(jax.vmap(pol.act, in_axes=(None, 0, 0))(
        pol.params, jnp.asarray(obs), jax.random.split(jax.random.key(0),
                                                      512)))
    mine = P.hdqn_policy(qnet_params_from_numpy(upper, CPU),
                         qnet_params_from_numpy(lower, CPU), greedy=True)
    got = mine.act(mine.params, torch.as_tensor(obs), None)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)

    # Not greedy: the goal is still the argmax; only the action draws, from
    # the caller's generator, through eps_greedy_from_q over 5 actions.
    noisy = P.hdqn_policy(mine.params["upper"], mine.params["lower"],
                          greedy=False, epsilon=0.7)
    x = torch.as_tensor(obs)
    goal = np.array(jnp.argmax(jax_qnet_apply(upper, jnp.asarray(obs)),
                               axis=-1))
    q_lo = qnet_apply(mine.params["lower"],
                      H.goal_obs(torch.as_tensor(goal, dtype=torch.int32), x))
    want = P.eps_greedy_from_q(q_lo, torch.Generator().manual_seed(5), 0.7, 5)
    got = noisy.act(noisy.params, x, torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    greedy = mine.act(mine.params, x, None)
    kept = (got == greedy).float().mean().item()
    assert 0.70 < kept < 0.86  # Phi(0.7) + (1 - Phi(0.7)) / 5 = 0.806


@pytest.mark.parametrize("opponent,n,T", [(D.OPP_L0, 16, 64),
                                          (D.OPP_SELFPLAY, 8, 24)])
def test_end_to_end_counters(opponent, n, T):
    """tests/test_hdqn.py:51-72 for the port."""
    cfg = H.HDQNConfig(memory_capacity=256 if n == 16 else 128,
                       goal_memory_capacity=64 if n == 16 else 32,
                       batch_size=16 if n == 16 else 8, opponent=opponent)
    carry = H.hdqn_init(0, cfg, EnvParams(), n, device=CPU)
    carry = H.hdqn_train_chunk(cfg, EnvParams(), carry, T)
    assert carry.step == T and int(carry.metrics.env_steps) == n * T
    first = next(t for t in range(T) if (t + 1) * n >= cfg.memory_capacity)
    assert int(carry.lower.learn_counter) == T - first
    assert int(carry.upper_replay.cursor) > 0  # options do terminate
    assert int(carry.lower_replay.cursor) == n * T
    assert np.isfinite(float(carry.lower.last_loss))
    assert np.isfinite(float(carry.upper.last_loss))
    assert int(carry.goal.min()) >= 0 and int(carry.goal.max()) < 3
    if opponent == D.OPP_L0:
        assert int(carry.upper.learn_counter) > 0
        assert torch.equal(carry.goal_op, torch.zeros_like(carry.goal_op))
    else:
        assert int(carry.goal_op.min()) >= 0 and int(carry.goal_op.max()) < 3


def test_config_refuses_pmean_axis_and_splits_learners():
    # pmean_axis is accepted; a step refuses it without the mesh's groups
    # (parallel.spmd.spmd_hdqn_chunk passes them).
    cfg = H.HDQNConfig(pmean_axis="data", memory_capacity=16,
                       goal_memory_capacity=4, batch_size=4)
    carry = H.hdqn_init(0, cfg, EnvParams(), 4, device=CPU)
    with pytest.raises(ValueError, match="spmd_hdqn_chunk"):
        H.hdqn_step(cfg, EnvParams(), carry)
    cfg = H.HDQNConfig(compute_dtype="bfloat16")
    lo, up = cfg.lower_cfg(), cfg.upper_cfg()
    assert (lo.obs_dim, lo.num_actions, lo.memory_capacity) == (11, 5, 2000)
    assert (up.obs_dim, up.num_actions, up.memory_capacity) == (10, 3, 200)
    assert lo.compute_dtype == up.compute_dtype == "bfloat16"
    assert set(JH.HDQNConfig.__dataclass_fields__) == set(
        H.HDQNConfig.__dataclass_fields__)
    for name, field in H.HDQNConfig.__dataclass_fields__.items():
        assert getattr(JH.HDQNConfig(), name) == field.default, name


def _race(rng, n):
    pos = rng.uniform(870.0, 948.0, (n, 2)).astype(np.float32)
    vel = rng.uniform(5.0, 40.0, (n, 2)).astype(np.float32)
    return pos, vel


@pytest.mark.parametrize("faithful_meta", [True, False])
def test_greedy_learn_free_chunk_equals_jax(faithful_meta):
    n, T, opponent = 64, 30, D.OPP_SELFPLAY
    kw = dict(epsilon=40.0, memory_capacity=4 * n * T,
              goal_memory_capacity=2 * n * T, batch_size=16,
              opponent=opponent, faithful_meta=faithful_meta)
    jcfg, cfg = JH.HDQNConfig(**kw), H.HDQNConfig(**kw)
    jep, ep = JEnvParams(max_steps=25), EnvParams(max_steps=25)
    pos, vel = _race(np.random.default_rng(11), n)

    jc = JH.hdqn_init(jax.random.key(4), jcfg, jep, n)
    es = jc.env_state.replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel))
    obs = jax.vmap(jax_env.observe)(es)
    jc = jc.replace(env_state=es, obs=obs, option_start_obs=obs)

    c = H.hdqn_init(0, cfg, ep, n, device=CPU)
    st = c.env_state
    st.pos, st.vel = torch.as_tensor(pos), torch.as_tensor(vel)
    c.obs = core_env.observe(st)
    c.option_start_obs = c.obs
    for mine, theirs in ((c.upper, jc.upper), (c.lower, jc.lower)):
        mine.params = qnet_params_from_numpy(theirs.params, CPU)
        mine.target_params = qnet_params_from_numpy(theirs.target_params,
                                                    CPU)
    np.testing.assert_allclose(c.obs.numpy(), np.asarray(jc.obs), atol=1e-3)

    jc = JH.hdqn_train_chunk(jcfg, jep, jc, T)
    c = H.hdqn_train_chunk(cfg, ep, c, T)

    assert int(jc.lower.learn_counter) == int(c.lower.learn_counter) == 0
    assert int(jc.upper.learn_counter) == int(c.upper.learn_counter) == 0
    for k in ("goal", "goal_op", "option_start"):
        np.testing.assert_array_equal(getattr(c, k).numpy(),
                                      np.asarray(getattr(jc, k)), err_msg=k)
    np.testing.assert_allclose(c.extr_return.numpy(),
                               np.asarray(jc.extr_return), atol=1e-4)
    np.testing.assert_allclose(c.ep_reward.numpy(), np.asarray(jc.ep_reward),
                               atol=1e-4)
    np.testing.assert_allclose(c.env_state.pos.numpy(),
                               np.asarray(jc.env_state.pos), rtol=2.5e-7,
                               atol=1e-4)
    for name in ("lower_replay", "upper_replay"):
        mine, theirs = getattr(c, name), getattr(jc, name)
        assert int(mine.cursor) == int(theirs.cursor) > 0, name
        for k in ("action", "done"):
            np.testing.assert_array_equal(
                mine.data[k].numpy(), np.asarray(theirs.data[k]),
                err_msg=f"{name} {k}")
        for k in ("obs", "next_obs"):
            np.testing.assert_allclose(
                mine.data[k].numpy(), np.asarray(theirs.data[k]), rtol=0,
                atol=1e-3, err_msg=f"{name} {k}")
        np.testing.assert_allclose(mine.data["reward"].numpy(),
                                   np.asarray(theirs.data["reward"]),
                                   rtol=0, atol=1e-4, err_msg=f"{name} r")
    assert int(c.upper_replay.cursor) < n * T  # gated by option ends
    m, jm = c.metrics, jc.metrics
    for k in ("env_steps", "episodes", "collisions", "wins"):
        assert int(getattr(m, k)) == int(getattr(jm, k)), k
    assert int(m.episodes) > 0 and int(m.wins) > 0
    np.testing.assert_allclose(float(m.sum_ep_reward),
                               float(jm.sum_ep_reward), rtol=1e-5, atol=1e-3)
    if not faithful_meta:  # the textbook pair: option-start obs first
        np.testing.assert_allclose(c.option_start_obs.numpy(),
                                   np.asarray(jc.option_start_obs), atol=1e-3)


def test_actor_seeds_differ_per_call_and_step():
    seeds = {H.actor_seed(7, s, k) for s in range(50)
             for k in range(H.ACTOR_CALLS)}
    assert len(seeds) == 50 * H.ACTOR_CALLS
    assert H.actor_seed(7, 0, 0) >> 32 == 7
