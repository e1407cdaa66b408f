"""Gymnasium VectorEnv over the native C++ batch core.

Counterpart of ``merging_gym_tpu/envs/vector_env.py``.  For consumers who
want batched stepping on the host (SB3-style trainers, evaluation
scripts): wraps ``core.native.NativeMergeEnv`` -- the bit-exact C++ env
core -- in the ``gymnasium.vector.VectorEnv`` interface.  Single-agent
view: player 2 is a pluggable opponent callable ``opponent(obs_swapped,
rng) -> actions`` (default L0), as in ``envs.gym_env.GymnasiumMergeEnv``.
The env is a host env by design, as in the JAX package; the opponent may
run on the card (a ``q_policy`` there runs K3 at ``num_envs`` rows).

Autoreset follows gymnasium 1.x NEXT_STEP semantics: the step on which
an episode ends returns its true terminal observation; the reset happens
at the start of the following step (whose action is ignored for that
env).  ``terminated`` covers collisions and race completion even when
they coincide with the step cap; ``truncated`` is the pure timeout.
For the card's throughput use ``ops.fused_rollout`` and
``ops.fused_policy_rollout``.
"""

from __future__ import annotations

import gymnasium as gym
import numpy as np

from merging_gym_tpu_torch.core import constants as C
from merging_gym_tpu_torch.core import native

try:  # gymnasium >= 1.0
    from gymnasium.vector import AutoresetMode
    _AUTORESET_META = {"autoreset_mode": AutoresetMode.NEXT_STEP}
except ImportError:  # pragma: no cover - older gymnasium
    _AUTORESET_META = {}


class NativeVectorEnv(gym.vector.VectorEnv):
    """Batched single-agent merging env backed by the C++ core."""

    metadata = {"render_modes": [], **_AUTORESET_META}

    def __init__(self, num_envs: int = 64, opponent=None,
                 rewards=(C.R_FIRST, C.R_SECOND, C.R_COLLISION,
                          C.VEL_PENALTY, C.TIME_PENALTY)):
        self.num_envs = num_envs
        self.single_observation_space = gym.spaces.Box(
            low=-np.inf, high=np.inf, shape=(C.OBS_DIM,), dtype=np.float32)
        self.single_action_space = gym.spaces.Discrete(C.NUM_ACTIONS)
        self.observation_space = gym.vector.utils.batch_space(
            self.single_observation_space, num_envs)
        self.action_space = gym.vector.utils.batch_space(
            self.single_action_space, num_envs)
        self.opponent = opponent
        self._env = native.NativeMergeEnv(num_envs, rewards)
        self._rng = np.random.default_rng(0)
        self._needs_reset = np.zeros(num_envs, bool)
        self._obs = self._env.observe().astype(np.float32)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._obs = self._env.reset().astype(np.float32)
        self._needs_reset[:] = False
        return self._obs.copy(), {}

    def _opponent_actions(self, obs: np.ndarray) -> np.ndarray:
        if self.opponent is None:
            return np.full(self.num_envs, -1, np.int32)  # L0
        swapped = np.concatenate([obs[:, 5:], obs[:, :5]], axis=1)
        return np.asarray(self.opponent(swapped, self._rng), np.int32)

    def step(self, actions):
        # NEXT_STEP autoreset: for envs flagged on the previous step, this
        # step performs the reset -- the given action is fully ignored and
        # the returned tuple is (reset_obs, 0, False, False) for them
        # (gymnasium 1.x contract).
        was_reset = self._needs_reset.copy()

        a1 = np.asarray(actions, np.int32)
        a2 = self._opponent_actions(self._obs)
        obs, rewards, done, collision, winner = self._env.step(a1, a2)

        timeout = self._env.state["t"] >= C.TIMEOUT_STEPS
        terminated = done & (collision | ~timeout)
        truncated = done & timeout & ~collision

        if was_reset.any():
            # Undo the step for resetting envs and report the reset obs.
            self._env.reset_envs(was_reset)
            reset_obs = np.asarray(
                self._env.observe()[was_reset], np.float32)
            obs[was_reset] = reset_obs
            rewards[was_reset] = 0.0
            terminated[was_reset] = False
            truncated[was_reset] = False
            collision[was_reset] = False
            winner[was_reset] = 0
            done = done & ~was_reset

        self._obs = obs.astype(np.float32)
        self._needs_reset = done.copy()

        infos = {
            "collision": collision,
            "winner": winner,
            "reward_opponent": rewards[:, 1].astype(np.float32),
        }
        return (self._obs.copy(), rewards[:, 0].astype(np.float32),
                terminated, truncated, infos)

    def close(self):
        pass
