"""The port's step-loop DQN trainer against ``merging_gym_tpu/agents/dqn.py``.

``td_loss`` and ``learn`` (autograd + the hand-written Adam) run on the
same params and batches as JAX's (``jax.grad`` + ``optax.adam``) for three
steps: the loss to rtol 1e-5, params and both Adam moments to f32
round-off by the outlier rule of ``tests/test_fused_trainer.py:77-89``.
The actor and the replay draws use other random streams than JAX's, so a
whole chunk is held on its counters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merging_gym_tpu.agents import dqn as JD
from merging_gym_tpu.nn.mlp import qnet_init as jax_qnet_init
from merging_gym_tpu_torch.agents import dqn as D
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.nn.mlp import qnet_params_from_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _rand_batch(rng, n):
    return {
        "obs": rng.standard_normal((n, 10)).astype(np.float32) * 20.0,
        "action": rng.integers(0, 5, n).astype(np.int32),
        "reward": rng.standard_normal(n).astype(np.float32),
        "next_obs": rng.standard_normal((n, 10)).astype(np.float32) * 20.0,
        "done": rng.random(n) < 0.1,
    }


def _net(seed):
    p = jax_qnet_init(jax.random.key(seed), 10, 5)
    return jax.tree.map(lambda w: np.asarray((w - 0.5) * 0.1, np.float32), p)


def _roundoff(got, want, cap, what):
    a = np.asarray(got, np.float64)
    b = np.asarray(want, np.float64)
    err = np.abs(a - b)
    loose = err > (5e-5 + 2e-4 * np.abs(b))
    assert loose.mean() <= 1e-3, f"{what}: {loose.sum()}/{loose.size} loose"
    assert err.max() < cap, f"{what}: max |diff| {err.max():.2e}"


@pytest.mark.parametrize("mask_terminal,compute_dtype",
                         [(False, "float32"), (True, "float32"),
                          (False, "bfloat16")])
def test_learn_matches_jax_three_steps(mask_terminal, compute_dtype):
    # The setup of tests/test_fused_trainer.py:31-68 (nets, batches of
    # 256); the first learn syncs the target (counter 0), the others not.
    jcfg = JD.DQNConfig(lr=0.01, gamma=0.9, mask_terminal=mask_terminal,
                        compute_dtype=compute_dtype)
    cfg = D.DQNConfig(lr=0.01, gamma=0.9, mask_terminal=mask_terminal,
                      compute_dtype=compute_dtype)
    params, target = _net(1), _net(2)
    jst = JD.DQNState(params=jax.tree.map(jnp.asarray, params),
                      target_params=jax.tree.map(jnp.asarray, target),
                      opt_state=JD.make_optimizer(jcfg).init(
                          jax.tree.map(jnp.asarray, params)),
                      learn_counter=jnp.zeros((), jnp.int32),
                      last_loss=jnp.zeros((), jnp.float32))
    st = D.dqn_init(torch.Generator().manual_seed(0), cfg, CPU)
    st.params = qnet_params_from_numpy(params, CPU)
    st.target_params = qnet_params_from_numpy(target, CPU)
    rng = np.random.default_rng(0)
    bf16 = compute_dtype == "bfloat16"
    for step in range(3):
        batch = _rand_batch(rng, 256)
        want_loss = JD.td_loss(jst.params, jst.target_params,
                               jax.tree.map(jnp.asarray, batch), jcfg)
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        got_loss = D.td_loss(st.params, st.target_params, tb, cfg)
        jst = JD.learn(jst, jax.tree.map(jnp.asarray, batch), jcfg)
        st = D.learn(st, tb, cfg)
        # bf16 rounds at other places in the two frameworks
        # (tests/test_fused_trainer.py:133): the loss within bf16
        # resolution.
        rtol = 5e-2 if bf16 else 1e-5
        np.testing.assert_allclose(float(got_loss), float(want_loss),
                                   rtol=rtol)
        np.testing.assert_allclose(float(st.last_loss),
                                   float(jst.last_loss), rtol=rtol)
        assert int(st.learn_counter) == int(jst.learn_counter) == step + 1
        adam = jst.opt_state[0]
        assert int(st.opt_state.count) == int(adam.count)
        for name in ("fc0", "fc1", "fc2"):
            for leaf in ("w", "b"):
                np.testing.assert_array_equal(
                    st.target_params[name][leaf].numpy(),
                    np.asarray(jst.target_params[name][leaf]))
                if bf16:
                    continue
                what = f"{name}/{leaf} step {step}"
                _roundoff(st.params[name][leaf].numpy(),
                          jst.params[name][leaf], 0.05 * cfg.lr, what)
                for mine, theirs in ((st.opt_state.mu, adam.mu),
                                     (st.opt_state.nu, adam.nu)):
                    b = np.abs(np.asarray(theirs[name][leaf]))
                    _roundoff(mine[name][leaf].numpy(),
                              theirs[name][leaf], 1e-3 * b.max() + 1e-12,
                              what + " moment")


def test_target_sync_timing_and_independent_init():
    cfg = D.DQNConfig(memory_capacity=64, batch_size=8, target_sync=3)
    st = D.dqn_init(torch.Generator().manual_seed(0), cfg, CPU)
    # eval and target are independently initialised (main.py:80)
    assert not torch.equal(st.params["fc0"]["w"], st.target_params["fc0"]["w"])
    batch = {"obs": torch.ones(8, 10), "action": torch.zeros(8, dtype=torch.int32),
             "reward": torch.zeros(8), "next_obs": torch.ones(8, 10),
             "done": torch.zeros(8, dtype=torch.bool)}
    history = [st]
    for _ in range(5):
        history.append(D.learn(history[-1], batch, cfg))
    for k in range(1, 6):
        # learn k (counter k-1 before it) syncs to the pre-update params
        # iff (k-1) % 3 == 0 (main.py:125-127), else keeps the target.
        src = history[k - 1].params if (k - 1) % 3 == 0 else \
            history[k - 1].target_params
        assert torch.equal(history[k].target_params["fc0"]["w"],
                           src["fc0"]["w"]), k
    assert int(history[5].learn_counter) == 5


@pytest.mark.parametrize("opponent", ["L0", "selfplay"])
def test_train_chunk_runs_and_counts(opponent):
    n, T = 128, 30
    cfg = D.DQNConfig(memory_capacity=1024, batch_size=64, opponent=opponent,
                      lr=1e-3)
    ep = EnvParams(max_steps=12)
    carry = D.train_init(3, cfg, ep, n, device=CPU)
    carry = D.train_chunk(cfg, ep, carry, T)
    m = carry.metrics
    assert carry.step == T and int(m.env_steps) == n * T
    assert int(m.episodes) == n * (T // 12)  # every episode times out
    assert int(m.wins) <= int(m.episodes) >= int(m.collisions)
    stored = int(carry.replay.cursor)
    assert n * T * 0.5 < stored <= n * T
    # The gate opens once 1,024 slots are filled; one learn per step on.
    first = next(t for t in range(T) if (t + 1) * n >= 1024)
    assert int(carry.dqn.learn_counter) == T - first
    assert np.isfinite(float(carry.dqn.last_loss))
    for layer in carry.dqn.params.values():
        for w in layer.values():
            assert torch.isfinite(w).all()


def test_learns_per_step_and_sample_valid_gate():
    n = 128
    cfg = D.DQNConfig(memory_capacity=4096, batch_size=64, learns_per_step=2,
                      sample_valid=True, lr=1e-3)
    carry = D.train_init(0, cfg, EnvParams(), n, device=CPU)
    carry = D.train_chunk(cfg, EnvParams(), carry, 3)
    # sample_valid opens the gate at one stored batch: every step learns.
    assert int(carry.dqn.learn_counter) == 6
    faithful = D.train_chunk(cfg.replace(sample_valid=False), EnvParams(),
                             D.train_init(0, cfg, EnvParams(), n, device=CPU),
                             3)
    assert int(faithful.dqn.learn_counter) == 0
