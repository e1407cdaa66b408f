"""The port's float64 oracle and native C++ core against the JAX package's.

``merging_gym_tpu_torch.core.oracle`` and ``core.native`` (the port's copy
of ``native/merging_core.cpp``, built into ``kernels/_build``) must equal
``merging_gym_tpu.core.oracle`` and ``merging_gym_tpu.core.native`` bit for
bit over seeded random action streams (the L0 ``None`` action included)
to the end of every episode, and the native QP solvers must meet the JAX
tests' tolerances (``tests/test_native.py``).
"""

import numpy as np
import pytest

from merging_gym_tpu.core import native as jnative
from merging_gym_tpu.core.oracle import OracleMergeEnv as JaxOracle
from merging_gym_tpu_torch.core import constants as C
from merging_gym_tpu_torch.core import native
from merging_gym_tpu_torch.core.oracle import OracleMergeEnv
from tests.torch_threads import one_torch_thread  # noqa: F401

EPISODES = 24


@pytest.fixture(scope="module")
def libs():
    return native.load_library(), jnative.load_library()


def _oracle_pair(seed, random_start):
    return (OracleMergeEnv(random_start=random_start,
                           rng=np.random.default_rng(seed)),
            JaxOracle(random_start=random_start,
                      rng=np.random.default_rng(seed)))


def _state(env):
    return (env.state1, env.state2, env.winner, env.done, env.time_stamp,
            env.r1_accumulate, env.r2_accumulate)


@pytest.mark.parametrize("random_start", [False, True])
def test_oracle_equals_jax_oracle_bit_for_bit(random_start):
    rng = np.random.default_rng(7)
    port, ref = _oracle_pair(3, random_start)
    for ep in range(EPISODES):
        assert port.reset() == ref.reset()
        assert _state(port) == _state(ref)
        for _ in range(3000):
            a1 = int(rng.integers(0, 5))
            a2 = int(rng.integers(-1, 5))
            a2 = None if a2 < 0 else a2
            got, want = port.step(a1, a2), ref.step(a1, a2)
            assert got == want
            assert _state(port) == _state(ref)
            assert port.is_collided() == ref.is_collided()
            if got[2]:
                break
        assert got[2], f"episode {ep} did not end"
    assert port.show_reward() == ref.show_reward()


def test_struct_layouts_equal(libs):
    assert native._STATE_DTYPE == jnative._STATE_DTYPE
    assert native._OUT_DTYPE == jnative._OUT_DTYPE
    assert native._STATE_DTYPE.itemsize == jnative._STATE_DTYPE.itemsize
    assert native._OUT_DTYPE.itemsize == jnative._OUT_DTYPE.itemsize


@pytest.mark.parametrize("rewards", [(2.0, 1.0, -10.0, 0.001, 0.0),
                                     (2.0, 0.0, -100.0, 0.0, 0.005)])
def test_native_equals_jax_native_bit_for_bit(libs, rewards):
    n = EPISODES
    port = native.NativeMergeEnv(n, rewards)
    ref = jnative.NativeMergeEnv(n, rewards)
    np.testing.assert_array_equal(port.reset(), ref.reset())
    rng = np.random.default_rng(11)
    ended = np.zeros(n, bool)
    for _ in range(3000):
        a1 = rng.integers(0, 5, n).astype(np.int32)
        a2 = rng.integers(-1, 5, n).astype(np.int32)
        got, want = port.step(a1, a2), ref.step(a1, a2)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert port.state.tobytes() == ref.state.tobytes()
        np.testing.assert_array_equal(port.observe(), ref.observe())
        ended |= got[2]
        if ended.all():
            break
    assert ended.all()


def test_native_equals_port_oracle_on_one_episode(libs):
    rng = np.random.default_rng(5)
    env, oracle = native.NativeMergeEnv(1), OracleMergeEnv()
    for _ in range(3000):
        a1, a2 = int(rng.integers(0, 5)), int(rng.integers(-1, 5))
        obs_o, r_o, done_o, info_o = oracle.step(a1, None if a2 < 0 else a2)
        obs_n, r_n, done_n, col_n, win_n = env.step([a1], [a2])
        np.testing.assert_array_equal(obs_n[0], np.asarray(obs_o))
        np.testing.assert_array_equal(r_n[0], np.asarray(r_o))
        assert (bool(done_n[0]), bool(col_n[0]), int(win_n[0])) == (
            done_o, info_o["collision"], oracle.winner or 0)
        if done_o:
            break
    assert done_o


def test_native_reset_envs_resets_only_the_masked_envs(libs):
    n = 6
    env = native.NativeMergeEnv(n)
    start = jnative.NativeMergeEnv(1).state[0].item()  # fields, no padding
    rng = np.random.default_rng(2)
    for _ in range(40):
        env.step(rng.integers(0, 5, n), rng.integers(-1, 5, n))
    before = env.state.copy()
    mask = np.array([True, False, True, False, False, True])
    env.reset_envs(mask)
    for i in range(n):
        want = start if mask[i] else before[i].item()
        assert env.state[i].item() == want
    assert before[0].item() != start


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_rollout_equals_jax(libs, seed):
    rng = np.random.default_rng(seed)
    a1 = rng.integers(0, 5, 3000).astype(np.int32)
    a2 = rng.integers(-1, 5, 3000).astype(np.int32)
    steps, obs, rew = native.NativeMergeEnv(1).rollout(a1, a2)
    want = jnative.NativeMergeEnv(1).rollout(a1, a2)
    assert steps == want[0] and steps < 3000
    np.testing.assert_array_equal(obs, want[1])
    np.testing.assert_array_equal(rew, want[2])


def test_native_qp_solvers(libs):
    for v0 in (0.0, 7.3, 20.0, 41.5):
        for vt in C.TARGET_VELS:
            got = native.mpc_1d_action(v0, vt, 3.0)
            assert abs(got - (vt - v0) / 3.0) < 1e-9
            assert got == jnative.mpc_1d_action(v0, vt, 3.0)
    rng = np.random.default_rng(3)
    n, m = 10, 2
    a = rng.standard_normal((n, n))
    P = a @ a.T + np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    kkt = np.block([[P, A.T], [A, np.zeros((m, m))]])
    expect = np.linalg.solve(kkt, np.concatenate([-q, b]))[:n]
    got = native.eq_qp(P, q, A, b)
    np.testing.assert_allclose(got, expect, atol=1e-8)
    np.testing.assert_array_equal(got, jnative.eq_qp(P, q, A, b))


def test_native_refusals(libs, tmp_path, monkeypatch):
    with pytest.raises(np.linalg.LinAlgError, match="singular"):
        native.eq_qp(np.zeros((3, 3)), np.zeros(3), np.ones(3), 1.0)
    with pytest.raises(ValueError, match="eq_qp"):
        native.eq_qp(np.eye(3), np.zeros(2), np.ones(3), 1.0)
    env = native.NativeMergeEnv(2)
    with pytest.raises(ValueError, match="for 2 envs"):
        env.step([1, 2, 3], [0, 0, 0])
    with pytest.raises(ValueError, match="one env"):
        env.rollout([1], [1])
    # A source that does not compile raises, and leaves nothing behind.
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_SO_PATH", str(tmp_path / "lib.so"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native._build()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["bad.cpp"]
