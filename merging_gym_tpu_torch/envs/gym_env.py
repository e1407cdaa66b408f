"""Drop-in class-based envs over the float64 oracle.

Counterpart of ``merging_gym_tpu/envs/gym_env.py``.  Two wrappers:

* :class:`MergeEnv` -- the reference's exact public surface
  (merging_gym/envs/merging_env.py:72-230; gym 0.20 conventions):
  ``reset() -> obs list``, ``step(a1, a2=None) -> (obs, [r1, r2], done,
  info)``, ``observe``, ``is_collided``, ``show_reward``, ``action_dict``,
  ``state1``/``state2`` dicts, ``winner``, ``r1_accumulate``/
  ``r2_accumulate``, ``render``/``plot`` and the experiment screens
  ``intro``/``prepare``/``feedback``/``finish``.  A reference user's
  training script ports by changing only the import.  Numerics run through
  the float64 oracle; rendering is *lazy* (the reference opens a pygame
  window in the constructor, merging_env.py:82-98 -- here the window only
  appears on first render, so headless training needs no SDL).

* :class:`GymnasiumMergeEnv` -- a modern gymnasium.Env over the same
  core (5-tuple step, seeded reset), registered as
  ``merging_gym_tpu_torch/MergeEnv-v0``.  The opponent is a pluggable
  policy callable; ``None`` reproduces the L0 constant-velocity opponent.

Both are host envs (numpy float64), as in the JAX package; an opponent
callable may run a net on the card.  gymnasium is imported with this
module.
"""

from __future__ import annotations

import gymnasium as gym
import numpy as np

from merging_gym_tpu_torch.core import constants as C
from merging_gym_tpu_torch.core.oracle import OracleMergeEnv


class MergeEnv(OracleMergeEnv):
    """Reference-API environment (see module docstring)."""

    metadata = {"render_modes": ["human"]}

    def __init__(self, render_mode=None, **reward_kwargs):
        self.render_mode = render_mode
        self._renderer = None
        self._screens = None
        self.observation_space, self.action_space = _spaces()
        # action -> target velocity (merging_env.py:100-102)
        self.action_dict = {i: v for i, v in enumerate(C.TARGET_VELS)}
        self.action1 = 1
        self.action2 = 1
        super().__init__(**reward_kwargs)

    # -- stepping -----------------------------------------------------------

    def step(self, action1, action2=None):
        self.action1, self.action2 = action1, action2
        return super().step(action1, action2)

    # -- rendering (lazy) ---------------------------------------------------

    def _ui(self):
        if self._renderer is None:
            from merging_gym_tpu_torch.ui.render import Renderer
            from merging_gym_tpu_torch.ui.screens import ExperimentScreens
            self._renderer = Renderer()
            self._screens = ExperimentScreens(self._renderer)
        return self._renderer

    def render(self, goal=None, goal_op=None, player=1, sum_r1=0, sum_r2=0,
               tag_left=None, tag_right=None, last_r1=0, last_r2=0):
        from merging_gym_tpu_torch.ui.render import snapshot
        self._ui().render(
            snapshot(self.state1, self.state2, self.r1_accumulate, self.r2_accumulate),
            goal=goal, goal_op=goal_op, player=player,
            tag_left=tag_left, tag_right=tag_right)

    def plot(self, player=1):
        self._ui().plot(player)

    def intro(self, player=1):
        self._ui()
        self._screens.intro(player)

    def prepare(self, player=1):
        self._ui()
        self._screens.prepare(player, rng=self.rng)

    def feedback(self, player=1):
        self._ui()
        self._screens.feedback(self.r1_accumulate, self.r2_accumulate, player)

    def finish(self, sum_r1, sum_r2, player=1):
        self._ui()
        self._screens.finish(sum_r1, sum_r2, player)

    def close(self):
        if self._renderer is not None:
            self._renderer.close()
            self._renderer = None


def _spaces():
    """The reference's spaces (merging_env.py:75-78,102) in gymnasium terms."""
    h, w = C.H, C.W
    low = np.array([-h, -w, -100, 0, 0, -h, -w, -100, 0, 0], np.float16)
    high = np.array([h, w, 100, h, 100, h, w, 100, h, 100], np.float16)
    return (gym.spaces.Box(low=low, high=high, dtype=np.float16),
            gym.spaces.Discrete(C.NUM_ACTIONS))


class GymnasiumMergeEnv(gym.Env):
    """Modern single-agent gymnasium.Env; player 2 is a policy callable
    ``opponent(obs_swapped, rng) -> action | None`` (default: L0)."""

    metadata = {"render_modes": ["human", "rgb_array"]}

    def __init__(self, opponent=None, render_mode=None, random_start=False,
                 **reward_kwargs):
        super().__init__()
        # The reference's declared Box (f16, low=0 on the distance dims) is
        # wrong: observations go negative once a player crosses the merge
        # point and are never clipped (SURVEY.md section 2.1).  MergeEnv
        # keeps the faithful space; this modern wrapper declares a correct
        # unbounded f32 Box.
        self.observation_space = gym.spaces.Box(
            low=-np.inf, high=np.inf, shape=(C.OBS_DIM,), dtype=np.float32)
        _, self.action_space = _spaces()
        self.opponent = opponent
        self.render_mode = render_mode
        self._env = MergeEnv(render_mode=render_mode,
                             random_start=random_start, **reward_kwargs)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._env.rng = np.random.default_rng(seed)
        obs = self._env.reset()
        return np.asarray(obs, np.float32), {}

    def step(self, action):
        a2 = None
        if self.opponent is not None:
            swapped = self._env.observe()
            swapped = swapped[5:] + swapped[:5]
            a2 = self.opponent(np.asarray(swapped, np.float32), self._env.rng)
        obs, rewards, done, info = self._env.step(int(action), a2)
        info = dict(info)
        info["reward_opponent"] = rewards[1]
        info["winner"] = self._env.winner
        truncated = bool(done and self._env.time_stamp > C.TIME_LIMIT
                         and not info["collision"])
        terminated = bool(done and not truncated)
        return (np.asarray(obs, np.float32), float(rewards[0]),
                terminated, truncated, info)

    def render(self):
        self._env.render()
        if self.render_mode == "rgb_array":
            return self._env._renderer.frame_array()

    def close(self):
        self._env.close()


class MergeEnvExtend(gym.Env):
    """Print-only placeholder, kept for registry parity with the
    reference's ``merging_env_extend-v0`` (merging_env.py:404-410,
    merging_gym/__init__.py:8-11)."""

    def __init__(self):
        print("MergeEnvExtend Environment initialized")

    def step(self):
        print("MergeEnvExtend Step successful!")

    def reset(self):
        print("MergeEnvExtend Environment reset")


def register_gymnasium():
    """Register ``merging_gym_tpu_torch/MergeEnv-v0`` and
    ``merging_gym_tpu_torch/MergeEnvExtend-v0`` (cf. the reference's
    ``merging_env-v0`` registration, merging_gym/__init__.py:3-11).

    The port has a namespace of its own, so that the JAX package's
    ``merging_gym_tpu/MergeEnv-v0`` and the port's ids build each
    package's own class whichever package registers first.  The
    reference's old-gym ids ``merging_env-v0`` and
    ``merging_env_extend-v0`` are registered as aliases of the port's
    classes only where no package has registered them yet: this function
    never overrides an id, so after the JAX package's registration they
    keep building the JAX package's classes.
    """
    ids = {"merging_gym_tpu_torch/MergeEnv-v0": "GymnasiumMergeEnv",
           "merging_gym_tpu_torch/MergeEnvExtend-v0": "MergeEnvExtend",
           # Old-gym aliases (merging_gym/__init__.py:3-11).
           "merging_env-v0": "GymnasiumMergeEnv",
           "merging_env_extend-v0": "MergeEnvExtend"}
    for env_id, cls in ids.items():
        if env_id not in gym.registry:
            gym.register(id=env_id, entry_point=f"{__name__}:{cls}")
