"""K1/K2 of the PyTorch port (plain versions, on the CPU) against the JAX
Pallas kernels in interpret mode, plus the Philox generator and the
seed-mode action distribution.

Tolerances are the JAX tests' own: tests/test_fused_rollout.py:42-56 and
tests/test_fused_rollout_counters.py:35-48.  Seed mode cannot match the
TPU's PRNG stream, so it is held by distribution and by K1 == K2.
"""

import numpy as np
import pytest
import torch

from merging_gym_tpu.ops import fused_rollout as JFR
from merging_gym_tpu_torch.core import constants as C
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.ops import fused_rollout as FR
from merging_gym_tpu_torch.ops import philox
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture
def _interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(JFR.pl, "pallas_call", patched)
    yield


def _assert_rollouts_match(got, want):
    T = got["obs"].shape[0]
    for t in range(T):
        np.testing.assert_allclose(got["obs"][t].numpy(),
                                   np.asarray(want["obs"][t]), rtol=1e-6,
                                   atol=1e-3, err_msg=f"obs step {t}")
    np.testing.assert_allclose(got["rewards"].numpy(),
                               np.asarray(want["rewards"]), rtol=1e-6,
                               atol=1e-6)
    for k in ("done", "winner", "collision"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def _assert_counters_match(traj, cnt, atol=1e-3):
    done, win, col = (traj[k].numpy() for k in ("done", "winner",
                                                "collision"))
    np.testing.assert_allclose(cnt["reward_sum"].numpy(),
                               traj["rewards"].numpy().sum(axis=0),
                               rtol=1e-5, atol=atol)
    np.testing.assert_array_equal(cnt["episodes"].numpy(), done.sum(0))
    np.testing.assert_array_equal(cnt["collisions"].numpy(), col.sum(0))
    np.testing.assert_array_equal(cnt["wins1"].numpy(),
                                  (done & (win == 1) & ~col).sum(0))
    np.testing.assert_array_equal(cnt["wins2"].numpy(),
                                  (done & (win == 2) & ~col).sum(0))


def _actions(T, N, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-1, C.NUM_ACTIONS, size=(T, 2, N)).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 3])
def test_k1_plain_matches_pallas_kernel(_interpret_mode, seed):
    T, N = 300, 128
    actions = _actions(T, N, seed)
    got = FR.fused_rollout(T, N, actions=torch.as_tensor(actions))
    want = JFR.fused_rollout(T, N, actions=actions)
    assert got["done"].any() and got["collision"].any()
    _assert_rollouts_match(got, want)


def test_k2_plain_matches_pallas_kernel(_interpret_mode):
    T, N = 400, 128
    actions = _actions(T, N, 5)
    got = FR.fused_rollout_counters(T, N, actions=torch.as_tensor(actions))
    want = JFR.fused_rollout_counters(T, N, actions=actions)
    assert int(got["episodes"].sum()) > 0
    assert int(got["collisions"].sum()) > 0
    np.testing.assert_allclose(got["reward_sum"].numpy(),
                               np.asarray(want["reward_sum"]), rtol=1e-5,
                               atol=1e-3)
    for k in ("episodes", "collisions", "wins1", "wins2"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("mode", ["actions", "seed"])
def test_k2_matches_k1_reductions(mode):
    T, N = 400, 128
    kw = ({"actions": torch.as_tensor(_actions(T, N, 6))} if mode == "actions"
          else {"seed": 11, "device": CPU})
    traj = FR.fused_rollout(T, N, **kw)
    cnt = FR.fused_rollout_counters(T, N, **kw)
    assert int(cnt["episodes"].sum()) > 0
    assert int(cnt["collisions"].sum()) > 0
    _assert_counters_match(traj, cnt)


def test_reward_params_and_max_steps_respected():
    T, N = 200, 128
    mirror = torch.full((T, 2, N), 2, dtype=torch.int32)  # abreast: collide
    a = FR.fused_rollout(T, N, actions=mirror)
    b = FR.fused_rollout(T, N, actions=mirror,
                         env_params=EnvParams(r_collision=-100.0))
    assert a["rewards"].min() > -20 and b["rewards"].min() < -90
    brake = torch.zeros((130, 2, N), dtype=torch.int32)  # only timeout ends
    out = FR.fused_rollout(130, N, actions=brake,
                           env_params=EnvParams(max_steps=100))
    assert int(out["done"][:, 0].int().argmax()) == 99 and out["done"][99].all()
    assert not FR.fused_rollout(130, N, actions=brake)["done"].any()


def test_unroll_changes_nothing():
    T, N = 24, 128
    actions = torch.as_tensor(_actions(T, N, 3))
    base = FR.fused_rollout(T, N, actions=actions)
    other = FR.fused_rollout(T, N, actions=actions, unroll=8)
    for k in base:
        assert torch.equal(base[k], other[k]), k


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    # Random123's known-answer vectors for philox4x32-10.
    c = [torch.tensor([v], dtype=torch.int64) for v in ctr]
    got = tuple(int(x) for x in philox.philox4x32_10(*c, key))
    assert got == want


def test_seed_mode_actions_uniform_and_seeded():
    key = philox.seed_key(7)
    acts = torch.cat([FR.seed_actions(s, 4096, key, CPU) for s in range(8)])
    counts = np.bincount(acts.numpy().ravel() + 1, minlength=6) / acts.numel()
    assert acts.min() == -1 and acts.max() == C.NUM_ACTIONS - 1
    np.testing.assert_allclose(counts, 1 / 6, atol=0.01)
    # Different players, steps and seeds draw different streams.
    assert (acts[:, 0] != acts[:, 1]).float().mean() > 0.75
    other = FR.seed_actions(0, 4096, philox.seed_key(8), CPU)
    assert (other != acts[:4096]).float().mean() > 0.75


def test_seed_mode_is_a_function_of_seed_alone():
    a = FR.fused_rollout(50, 128, seed=3, device=CPU)
    b = FR.fused_rollout(50, 128, seed=3, device=CPU, unroll=5)
    assert torch.equal(a["obs"], b["obs"])
    # Envs are independent: the first 64 of 128 envs are the 64-env run.
    c = FR.fused_rollout(50, 64, seed=3, device=CPU)
    assert torch.equal(a["obs"][:, :, :64], c["obs"])


def test_argument_checks():
    with pytest.raises(ValueError, match="XOR"):
        FR.fused_rollout(4, 128, device=CPU)
    with pytest.raises(ValueError, match="deterministic"):
        FR.fused_rollout(4, 128, seed=0, device=CPU,
                         env_params=EnvParams(random_start=True))
    with pytest.raises(ValueError, match=r"\[4, 2, 128\]"):
        FR.fused_rollout(4, 128, actions=torch.zeros(4, 2, 64))
