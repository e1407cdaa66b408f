"""Human-vs-agent / human-vs-human experiment harness.

Counterpart of ``merging_gym_tpu/ui/human.py`` and port of
scripts/human_player.py: a pygame keyboard loop over the reference-API env
with per-episode CSV trajectory logging and the psych protocol (intro ->
prepare -> episodes -> feedback -> finish).

Controls (human_player.py:126-174): player 1 sets the absolute action
with numpad 0-4; in pvp mode player 2 increments/decrements with w/s.

Opponent modes (human_player.py:45-46,58-86):
* ``"dqn"``     -- flat Q-net, epsilon-greedy with the Phi(0.7) quirk;
* ``"hdqn"``    -- goal-conditioned pair; the goal is re-selected when
  achieved (human_player.py:151-152);
* ``"rainbow"`` -- noisy-greedy C51 net;
* ``"pvp"``     -- second human;
* ``"l0"``      -- constant-velocity (action None).

Model opponents load reference ``.pth`` run dirs (``io.torch_import``) on
the card unless the CPU is asked for.  Every forward of ``dqn`` and
``hdqn`` is ``nn.mlp.qnet_apply``, the K3 kernel on the card, on one row;
``rainbow`` is ``torch.matmul`` (JAX computes it outside any Pallas
kernel).  Each ``act`` moves the 10 observation floats to the net's device
and reads the picks back.  pygame and gymnasium are imported by
:func:`run_session` only, so the opponents need neither.
"""

from __future__ import annotations

import os

import torch

from merging_gym_tpu_torch.agents.hdqn import goal_obs, goal_status
from merging_gym_tpu_torch.agents.policies import eps_greedy_from_q
from merging_gym_tpu_torch.core import constants as C
from merging_gym_tpu_torch.device import tensor_device
from merging_gym_tpu_torch.io.trajectory import EpisodeLogger, make_log_dir
from merging_gym_tpu_torch.nn.mlp import qnet_apply
from merging_gym_tpu_torch.nn.rainbow_net import (rainbow_apply,
                                                  rainbow_q_values)


def _swap(obs):
    return obs[C.OBS_DIM // 2:] + obs[:C.OBS_DIM // 2]


class ScriptedOpponent:
    """Bundles params + mode into one ``act(obs_swapped) -> action|None``.

    A model opponent runs on its params' device and draws from one
    ``torch.Generator`` there, seeded from ``seed``: "epsilon-greedy" is
    greedy iff a standard normal is ``<= EPSILON`` (main.py:105), so
    P(greedy) = Phi(0.7), for the action and for h-DQN's goal.
    """

    def __init__(self, mode: str, params=None, meta_params=None,
                 seed: int = 0):
        self.mode = mode
        self.params = params
        self.meta_params = meta_params
        self.goal = None
        self.device = self.generator = None
        if params is not None:
            self.device = tensor_device(params)
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(seed)

    def reset(self):
        self.goal = None

    def _pick(self, q, num_actions=C.NUM_ACTIONS) -> int:
        return int(eps_greedy_from_q(q[None], self.generator,
                                     num_actions=num_actions)[0])

    def act(self, obs_swapped):
        if self.mode == "l0":
            return None
        x = torch.tensor(obs_swapped, dtype=torch.float32, device=self.device)
        if self.mode == "dqn":
            return self._pick(qnet_apply(self.params, x))
        if self.mode == "hdqn":
            status = int(goal_status(x))
            if self.goal is None or self.goal == status:
                self.goal = self._pick(qnet_apply(self.meta_params, x),
                                       C.NUM_GOALS)
            goal = torch.tensor(self.goal, device=self.device)
            return self._pick(qnet_apply(self.params, goal_obs(goal, x)))
        if self.mode == "rainbow":
            return int(torch.argmax(rainbow_q_values(
                rainbow_apply(self.params, x, None))))
        raise ValueError(f"unknown opponent mode: {self.mode}")


def read_keys(pygame, action: int, action_op: int, pvp: bool):
    """Keyboard mapping (human_player.py:126-174)."""
    pressed = pygame.key.get_pressed()
    for i, key in enumerate([pygame.K_KP0, pygame.K_KP1, pygame.K_KP2,
                             pygame.K_KP3, pygame.K_KP4]):
        if pressed[key]:
            action = i
    if pvp:
        if pressed[pygame.K_w]:
            action_op = min(action_op + 1, C.NUM_ACTIONS - 1)
        elif pressed[pygame.K_s]:
            action_op = max(action_op - 1, 0)
    return action, action_op


def run_session(opponent: ScriptedOpponent | None = None, episodes: int = 5,
                log_root: str = "log", tag: str | None = None,
                max_steps: int | None = None, time_scale: float = 1.0):
    """Full experiment session (human_player.py:49-198).

    ``time_scale=0`` removes all waits (for automated smoke tests);
    ``max_steps`` caps episode length for the same purpose.
    """
    import pygame

    from merging_gym_tpu_torch.envs.gym_env import MergeEnv

    opponent = opponent or ScriptedOpponent("l0")
    pvp = opponent.mode == "pvp"
    player = 2 if pvp else 1
    tag = tag or opponent.mode

    env = MergeEnv()
    env._ui()
    env._renderer.wait_ms = int(50 * time_scale)
    env._screens.time_scale = time_scale
    log_dir = make_log_dir(log_root)

    sum_r1 = sum_r2 = 0.0
    collision_count = 0

    env.intro(player)
    for i in range(episodes):
        state = env.reset()
        if not pvp:
            opponent.reset()
        done = False
        action, action_op = 2, 2  # initial mid actions (human_player.py:97-98)
        env.prepare(player=player)

        logger = EpisodeLogger(log_dir, i, tag)
        steps = 0
        while not done:
            if env.winner is None:
                tl, tr = None, None
            elif env.winner == 1:
                tl, tr = None, "Finished"
            else:
                tl, tr = "Finished", None
            env.render(player=player, tag_left=tl, tag_right=tr)

            action, action_op = read_keys(pygame, action, action_op, pvp)
            a2 = action_op if pvp else opponent.act(_swap(state))
            pygame.event.pump()
            next_state, rewards, done, info = env.step(action, a2)
            logger.log_step(state, action, a2, rewards, env.winner)
            if info["collision"]:
                collision_count += 1
            state = next_state
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        logger.close()

        sum_r1 += env.r1_accumulate
        sum_r2 += env.r2_accumulate
        env.render(player=player, tag_left="Finished", tag_right="Finished")
        env.feedback(player=player)
    env.finish(sum_r1=sum_r1, sum_r2=sum_r2, player=player)
    env.close()
    return {"log_dir": log_dir, "sum_r1": sum_r1, "sum_r2": sum_r2,
            "collisions": collision_count}


def load_opponent(mode: str, load_path: str | None = None,
                  device=None) -> ScriptedOpponent:
    """Build an opponent, loading a reference .pth run dir onto ``device``
    (default ``cuda``) when its mode needs a model (human_player.py:58-86).
    """
    if mode in ("l0", "pvp"):
        return ScriptedOpponent(mode)
    if load_path is None:
        raise ValueError(
            f"opponent mode {mode!r} needs --load-path (a reference .pth "
            "run dir); only 'l0' and 'pvp' run without a model")
    from merging_gym_tpu_torch.io import torch_import as ti

    if mode == "dqn":
        params, _ = ti.load_reference_dqn(load_path, device)
        return ScriptedOpponent(mode, params=params)
    if mode == "hdqn":
        nets = ti.load_reference_hdqn(load_path, device)
        return ScriptedOpponent(mode, params=nets["lower_eval"],
                                meta_params=nets["meta_eval"])
    if mode == "rainbow":
        params = ti.load_rainbow_pth(os.path.join(load_path, "eval.pth"),
                                     device)
        return ScriptedOpponent(mode, params=params)
    raise ValueError(f"unknown opponent mode: {mode}")
