"""The port's class envs, gymnasium registration, renderer and screens
against the JAX package's.

``merging_gym_tpu_torch.envs.gym_env.MergeEnv`` and
``GymnasiumMergeEnv`` step for step against JAX's (the same seeds, the
same opponents), ``envs.vector_env.NativeVectorEnv`` bit for bit against
JAX's with NEXT_STEP autoreset steps, both packages' ``register_gymnasium``
in one process in either order, and the pygame renderer's frames byte for
byte (headless, ``SDL_VIDEODRIVER=dummy``).
"""

import os
import subprocess
import sys

import gymnasium as gym
import numpy as np
import pytest

from merging_gym_tpu.envs import gym_env as jgym
from merging_gym_tpu.envs import vector_env as jvec
from merging_gym_tpu_torch.core import constants as C
from merging_gym_tpu_torch.envs import gym_env, vector_env
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("SDL_VIDEODRIVER", "dummy")


def _env_state(env):
    return (env.state1, env.state2, env.winner, env.done, env.time_stamp,
            env.r1_accumulate, env.r2_accumulate, env.action1, env.action2)


def test_merge_env_reference_api():
    env = gym_env.MergeEnv()
    obs = env.reset()
    assert isinstance(obs, list) and len(obs) == 10
    assert env.show_reward() == (2.0, 1.0, -10.0, 0.001)
    assert env.action_dict == {0: 0.0, 1: 10.0, 2: 20.0, 3: 30.0, 4: 40.0}
    assert env.action_space == jgym.MergeEnv().action_space
    assert env.observation_space == jgym.MergeEnv().observation_space


@pytest.mark.parametrize("kw", [{}, {"r_collision": -100.0,
                                     "time_penalty": 0.005}])
def test_merge_env_equals_jax_step_for_step(kw):
    port, ref = gym_env.MergeEnv(**kw), jgym.MergeEnv(**kw)
    rng = np.random.default_rng(1)
    for _ in range(6):
        assert port.reset() == ref.reset()
        for _ in range(3000):
            a1 = int(rng.integers(0, 5))
            a2 = int(rng.integers(-1, 5))
            a2 = None if a2 < 0 else a2
            got, want = port.step(a1, a2), ref.step(a1, a2)
            assert got == want
            assert _env_state(port) == _env_state(ref)
            if got[2]:
                break
        assert got[2]
    port.close()


def _greedy_obs_opponent(obs, rng):
    """Deterministic in the obs: race while behind, cruise once ahead."""
    return 4 if obs[0] < 0 else 2


def _rng_opponent(obs, rng):
    """Deterministic given the env's seeded numpy generator."""
    a = int(rng.integers(-1, 5))
    return None if a < 0 else a


@pytest.mark.parametrize("opponent", [None, _greedy_obs_opponent,
                                      _rng_opponent])
@pytest.mark.parametrize("random_start", [False, True])
def test_gymnasium_env_equals_jax(opponent, random_start):
    port = gym_env.GymnasiumMergeEnv(opponent=opponent,
                                     random_start=random_start)
    ref = jgym.GymnasiumMergeEnv(opponent=opponent,
                                 random_start=random_start)
    rng = np.random.default_rng(2)
    for seed in (0, 3):
        got, want = port.reset(seed=seed), ref.reset(seed=seed)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == want[0].dtype == np.float32
        for _ in range(3000):
            a = int(rng.integers(0, 5))
            got, want = port.step(a), ref.step(a)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]
            if got[2] or got[3]:
                break
        assert got[2] or got[3]
    assert port.observation_space == ref.observation_space
    assert port.action_space == ref.action_space
    port.close()
    ref.close()


def test_gymnasium_env_custom_opponent_wins():
    env = gym_env.GymnasiumMergeEnv(opponent=lambda obs, rng: 4)
    env.reset(seed=1)
    for _ in range(3000):
        obs, r, term, trunc, info = env.step(0)
        if term or trunc:
            break
    assert info["winner"] == 2  # full-throttle opponent wins vs braking ego


def test_port_ids_make_the_port_envs():
    gym_env.register_gymnasium()
    env = gym.make("merging_gym_tpu_torch/MergeEnv-v0")
    assert isinstance(env.unwrapped, gym_env.GymnasiumMergeEnv)
    obs, info = env.reset(seed=0)
    assert obs.shape == (10,)
    for _ in range(3000):
        obs, r, term, trunc, info = env.step(4)
        if term or trunc:
            break
    assert (term or trunc) and "winner" in info and "reward_opponent" in info
    env.close()
    assert "merging_gym_tpu_torch/MergeEnvExtend-v0" in gym.registry
    assert "merging_env-v0" in gym.registry
    assert "merging_env_extend-v0" in gym.registry


_ORDER_SCRIPT = """
import sys, gymnasium as gym
from merging_gym_tpu.envs import gym_env as jgym
from merging_gym_tpu_torch.envs import gym_env as pgym
first, second = (jgym, pgym) if sys.argv[1] == "jax" else (pgym, jgym)
first.register_gymnasium(); second.register_gymnasium()
for pkg, mod in (("merging_gym_tpu", jgym), ("merging_gym_tpu_torch", pgym)):
    env = gym.make(pkg + "/MergeEnv-v0")
    assert type(env.unwrapped) is mod.GymnasiumMergeEnv, (pkg, env.unwrapped)
    env.close()
    spec = gym.spec(pkg + "/MergeEnvExtend-v0")
    assert spec.entry_point == mod.__name__ + ":MergeEnvExtend", spec
alias = type(gym.make("merging_env-v0").unwrapped)
print(alias.__module__)
"""


@pytest.mark.parametrize("first", ["jax", "port"])
def test_registration_in_either_order(first):
    r = subprocess.run([sys.executable, "-c", _ORDER_SCRIPT, first],
                       cwd=REPO, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "OMP_NUM_THREADS": "1",
                            "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    # The reference aliases: the port never overrides them; the JAX
    # package re-registers its own over the port's.
    assert r.stdout.split()[-1] == "merging_gym_tpu.envs.gym_env"


def _vector_pair(n, opponent=None, **kw):
    return (vector_env.NativeVectorEnv(n, opponent, **kw),
            jvec.NativeVectorEnv(n, opponent, **kw))


def _vec_greedy(obs, rng):
    return np.where(obs[:, 0] < 0, 4, 2)


def _vec_rng(obs, rng):
    return rng.integers(-1, 5, len(obs))


@pytest.mark.parametrize("opponent", [None, _vec_greedy, _vec_rng])
def test_native_vector_env_equals_jax_bit_for_bit(opponent):
    n = 16
    port, ref = _vector_pair(n, opponent)
    assert port.metadata == ref.metadata
    got, want = port.reset(seed=4), ref.reset(seed=4)
    np.testing.assert_array_equal(got[0], want[0])
    rng = np.random.default_rng(9)
    resets = 0
    pending = np.zeros(n, bool)
    for _ in range(700):
        a = rng.integers(0, 5, n).astype(np.int32)
        got, want = port.step(a), ref.step(a)
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, w)
        assert got[4].keys() == want[4].keys()
        for k in got[4]:
            np.testing.assert_array_equal(got[4][k], want[4][k])
        resets += int(pending.sum())
        pending = got[2] | got[3]
    assert resets >= 2 * n  # every env went through NEXT_STEP resets
    assert port.single_observation_space == ref.single_observation_space
    assert port.action_space == ref.action_space


def test_native_vector_env_termination_and_rewards():
    port, ref = _vector_pair(8, lambda obs, rng: np.full(len(obs), 2),
                             rewards=(2.0, 1.0, -100.0, 0.001, 0.0))
    port.reset(), ref.reset()
    for _ in range(300):
        got = port.step(np.full(8, 2, np.int32))
        want = ref.step(np.full(8, 2, np.int32))
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, w)
        obs, rew, term, trunc, infos = got
        if term.any():
            assert not trunc[term].any()
            assert infos["collision"][term].all()
            assert float(rew.min()) < -90.0
            break
    else:
        pytest.fail("no collision episode within 300 steps")


def test_renderer_frames_equal_jax():
    from merging_gym_tpu.ui.render import Renderer as JaxRenderer
    from merging_gym_tpu.ui.render import snapshot as jsnapshot
    from merging_gym_tpu_torch.ui.render import Renderer, snapshot

    s1 = {"pos": 100.0, "vel": 20.0, "acc": 1.0}
    s2 = {"pos": 120.0, "vel": 25.0, "acc": -1.0}
    assert snapshot(s1, s2, 1.0, -2.0) == jsnapshot(s1, s2, 1.0, -2.0)
    frames = []
    for cls in (Renderer, JaxRenderer):
        r = cls(wait_ms=0)
        r.render(snapshot(s1, s2, 1.0, -2.0), goal=1, player=2,
                 tag_right="Finished", wait=False)
        frames.append(r.frame_array())
        r.close()
    assert frames[0].shape == (1000, 900, 3)
    assert (frames[0][:, :300] < 250).any() and (frames[0][:, 600:] < 250).any()
    np.testing.assert_array_equal(frames[0], frames[1])


def test_screens_and_lazy_ui_run_headless():
    from merging_gym_tpu_torch.ui.render import Renderer
    from merging_gym_tpu_torch.ui.screens import ExperimentScreens

    r = Renderer(wait_ms=0)
    s = ExperimentScreens(r, time_scale=0.0)
    s.intro()
    s.prepare()
    s.feedback(1.5, -0.5)
    s.finish(3.0, 1.0)
    r.close()
    env = gym_env.GymnasiumMergeEnv(render_mode="rgb_array")
    env.reset(seed=0)
    env.step(3)
    env._env._ui().wait_ms = 0
    assert env.render().shape == (1000, 900, 3)
    env.close()
    assert C.NUM_ACTIONS == env.action_space.n
