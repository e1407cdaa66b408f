"""K6 of the PyTorch port (plain version, on the CPU) against the JAX
Pallas kernel in interpret mode, and the port's evaluators against the
JAX package's and against each other.

Greedy mode with deterministic starts is deterministic, so it is held
exactly: actions, done, winner and collision equal, rewards to 1e-6
(tests/test_fused_policy_rollout.py:55-73).  The nets are the
small-magnitude ``_params`` of that file (:37-42), so the argmax is
decisive in both frameworks.  Phi(eps)-greedy and random starts use the
port's Philox stream, which cannot match the TPU's; they are held by
distribution.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merging_gym_tpu.agents import evaluate as JE
from merging_gym_tpu.agents.policies import q_policy as jax_q_policy
from merging_gym_tpu.core.env import EnvParams as JEnvParams
from merging_gym_tpu.nn.mlp import qnet_apply as jax_qnet_apply
from merging_gym_tpu.nn.mlp import qnet_init as jax_qnet_init
from merging_gym_tpu.ops import fused_policy_rollout as JFPR
from merging_gym_tpu_torch.agents import evaluate as E
from merging_gym_tpu_torch.agents import policies as P
from merging_gym_tpu_torch.core import constants as C
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.nn.mlp import qnet_apply, qnet_params_from_numpy
from merging_gym_tpu_torch.ops import fused_policy_rollout as FPR
from merging_gym_tpu_torch.ops import fused_rollout as FR
from merging_gym_tpu_torch.ops import philox

CPU = torch.device("cpu")
PHI = 0.5 * (1 + math.erf(0.7 / math.sqrt(2)))


@pytest.fixture
def _interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(JFPR.pl, "pallas_call", patched)
    yield


def _params(seed, decisive=False):
    p = jax_qnet_init(jax.random.key(seed), C.OBS_DIM, C.NUM_ACTIONS)
    p = jax.tree.map(lambda w: np.asarray((w - jnp.mean(w)) * 0.05), p)
    if decisive:  # argmax independent of the dtype
        p["fc2"]["b"] = p["fc2"]["b"] + np.arange(C.NUM_ACTIONS,
                                                  dtype=np.float32) * 300.0
    return p


def _t(p):
    return qnet_params_from_numpy(p, CPU)


def _compare(got, want):
    np.testing.assert_array_equal(got["actions"].numpy(),
                                  np.asarray(want["actions"]))
    np.testing.assert_allclose(got["rewards"].numpy(),
                               np.asarray(want["rewards"]), rtol=1e-6,
                               atol=1e-6)
    for k in ("done", "winner", "collision"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("case", ["vs_l0", "frozen_opponent", "selfplay"])
def test_k6_plain_matches_pallas_kernel(_interpret_mode, case):
    T, N = 80, 128
    p1 = _params(1)
    p2 = {"vs_l0": None, "frozen_opponent": _params(2), "selfplay": p1}[case]
    want = JFPR.fused_policy_rollout(T, N, p1, p2, greedy=True)
    got = FPR.fused_policy_rollout(T, N, _t(p1), None if p2 is None else _t(p2),
                                   greedy=True)
    _compare(got, want)
    if p2 is None:
        assert (got["actions"][:, 1] == C.ACTION_NONE).all()
    if case == "selfplay":  # symmetric start: both pick the same action
        assert torch.equal(got["actions"][0, 0], got["actions"][0, 1])


def test_k6_bf16_matches_pallas_kernel_under_decisive_bias(_interpret_mode):
    T, N = 60, 128
    p = _params(6, decisive=True)
    want = JFPR.fused_policy_rollout(T, N, p, p, greedy=True,
                                     compute_dtype="bfloat16")
    got16 = FPR.fused_policy_rollout(T, N, _t(p), _t(p), greedy=True,
                                     compute_dtype="bfloat16")
    got32 = FPR.fused_policy_rollout(T, N, _t(p), _t(p), greedy=True)
    _compare(got16, want)
    for k in got32:
        assert torch.equal(got16[k], got32[k]), k


def test_evaluate_fused_matches_jax(_interpret_mode):
    p1, p2 = _params(4), _params(5)
    want = JE.evaluate_fused(p1, p2, JEnvParams(max_steps=150), num_envs=128,
                             num_steps=160)
    got = E.evaluate_fused(_t(p1), _t(p2), EnvParams(max_steps=150),
                           num_envs=128, num_steps=160)
    assert got["episodes"] > 0
    for k in ("episodes", "p1_first", "p2_first", "collisions", "timeouts"):
        assert got[k] == want[k], k
    for k in ("p1_first_rate", "p2_first_rate", "collision_rate",
              "timeout_rate", "mean_return_p1", "mean_return_p2"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)


def test_greedy_evaluate_matches_evaluate_fused_and_jax():
    # Deterministic greedy play from deterministic starts: every episode
    # of a matchup is the same, so the three evaluators must agree.
    p1, p2 = _params(4), _params(5)
    ep = EnvParams(max_steps=150)
    fused = E.evaluate_fused(_t(p1), _t(p2), ep, num_envs=128, num_steps=160)
    pol1 = P.q_policy(qnet_apply, _t(p1), greedy=True)
    pol2 = P.q_policy(qnet_apply, _t(p2), greedy=True)
    loop = E.evaluate(pol1, pol2, ep, torch.Generator().manual_seed(0),
                      num_envs=128, min_episodes=64, chunk_steps=160,
                      max_chunks=1)
    jloop = JE.evaluate(jax_q_policy(jax_qnet_apply, p1, greedy=True),
                        jax_q_policy(jax_qnet_apply, p2, greedy=True),
                        JEnvParams(max_steps=150), jax.random.key(0),
                        num_envs=128, min_episodes=64, chunk_steps=160,
                        max_chunks=1)
    assert loop["episodes"] > 0
    for k in ("p1_first_rate", "p2_first_rate", "collision_rate",
              "timeout_rate", "mean_return_p1", "mean_return_p2"):
        np.testing.assert_allclose(fused[k], loop[k], atol=1e-5, err_msg=k)
        np.testing.assert_allclose(loop[k], jloop[k], atol=1e-5, err_msg=k)


def test_phi_greedy_fraction():
    # Q-values with a known argmax: the kept-greedy share of the Philox
    # selection and of the rollout-side eps_greedy_from_q is Phi(0.7)
    # plus the random arm's 1/A (tests/test_fused_actor.py:25-44).
    n = 40000
    q = torch.zeros(n, C.NUM_ACTIONS)
    q[:, 3] = 1.0
    w = philox.draw(0, n, philox.STREAM_ACTIONS, philox.seed_key(1), CPU)
    a = FPR._select(q, w[0], w[1], False, FPR.greedy_threshold(0.7))
    expect = PHI + (1 - PHI) / C.NUM_ACTIONS
    assert abs((a == 3).float().mean().item() - expect) < 0.01
    others = np.bincount(a.numpy(), minlength=5)[[0, 1, 2, 4]] / n
    np.testing.assert_allclose(others, (1 - PHI) / 5, atol=0.01)
    b = P.eps_greedy_from_q(q, torch.Generator().manual_seed(2))
    assert abs((b == 3).float().mean().item() - expect) < 0.01


def test_phi_greedy_rollout_is_seeded_and_explores():
    p = _t(_params(3))
    a = FPR.fused_policy_rollout(40, 128, p, p, greedy=False, seed=1)
    b = FPR.fused_policy_rollout(40, 128, p, p, greedy=False, seed=1)
    c = FPR.fused_policy_rollout(40, 128, p, p, greedy=False, seed=2)
    g = FPR.fused_policy_rollout(40, 128, p, p, greedy=True)
    assert torch.equal(a["actions"], b["actions"])
    assert not torch.equal(a["actions"], c["actions"])
    kept = (a["actions"][0] == g["actions"][0]).float().mean().item()
    assert abs(kept - (PHI + (1 - PHI) / 5)) < 0.08


def test_random_start_moments():
    pos, vel = FR.random_reset_vals(0, 40000, philox.seed_key(3),
                                    torch.float32, CPU)
    pos, vel = pos.numpy(), vel.numpy()
    # core/env.py:115-125: pos1 ~ N(50, 5), vel1 ~ N(20, 3),
    # pos2 ~ U(46, 54), vel2 ~ U(15, 30).
    np.testing.assert_allclose([pos[:, 0].mean(), pos[:, 0].std()], [50, 5],
                               atol=0.1)
    np.testing.assert_allclose([vel[:, 0].mean(), vel[:, 0].std()], [20, 3],
                               atol=0.06)
    np.testing.assert_allclose([pos[:, 1].mean(), pos[:, 1].std()],
                               [50, 8 / math.sqrt(12)], atol=0.05)
    np.testing.assert_allclose([vel[:, 1].mean(), vel[:, 1].std()],
                               [22.5, 15 / math.sqrt(12)], atol=0.1)
    assert 46 <= pos[:, 1].min() and pos[:, 1].max() <= 54


def test_random_start_rollout_starts_apart_and_resets():
    p = _t(_params(3))
    out = FPR.fused_policy_rollout(300, 128, p, None, greedy=True, seed=4,
                                   env_params=EnvParams(random_start=True,
                                                        max_steps=100))
    # Starts differ, so do the first step's velocity penalties.
    assert len(torch.unique(out["rewards"][0, 0])) > 100
    done = out["done"].numpy()
    assert done.any(axis=0).all()
    assert (done.sum(axis=0) >= 300 // 101).all()


def test_episodes_terminate_and_autoreset():
    p = _t(_params(3))
    out = FPR.fused_policy_rollout(300, 128, p, None, greedy=True,
                                   env_params=EnvParams(max_steps=100))
    done = out["done"].numpy()
    assert done.any(axis=0).all()
    assert (done.sum(axis=0) >= 300 // 101).all()


def test_round_robin_keys_and_outcomes():
    pols = {"a": P.constant_policy(4), "b": P.constant_policy(1),
            "l0": P.l0_policy()}
    res = E.round_robin(pols, EnvParams(), torch.Generator().manual_seed(0),
                        num_envs=16, min_episodes=16, chunk_steps=300)
    assert sorted(res) == sorted(f"{x} vs {y}" for x in pols for y in pols
                                 if x != y)
    assert res["a vs b"]["p1_first_rate"] > 0.9
    assert res["b vs a"]["p2_first_rate"] > 0.9
