"""Policy protocol: params plus a batched act function.

Counterpart of ``merging_gym_tpu/agents/policies.py``.  ``act(params,
obs, generator) -> int32[N]`` acts on a batch of one player's view of the
observation; :func:`two_player` composes two policies into the rollout's
``policy_fn``, player 2 acting on the half-swapped observation.

Reference quirk preserved: "epsilon-greedy" draws a standard normal and
acts greedily iff ``randn() <= 0.7`` (main.py:105), i.e. P(greedy) =
Phi(0.7) ~= 0.758.  The normal comes from the caller's generator.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable

import torch

from merging_gym_tpu_torch.core import constants as C
from merging_gym_tpu_torch.core.env import swap_obs

EPSILON = 0.7  # main.py:16 ("EPISILO")


@dataclass(frozen=True)
class Policy:
    """A single-player policy over the player's own view of the obs."""

    act: Callable[[Any, torch.Tensor, torch.Generator], torch.Tensor]
    params: Any = None


def _const_act(action, params, obs, generator):
    return torch.full((obs.shape[0],), action, dtype=torch.int32,
                      device=obs.device)


def l0_policy() -> Policy:
    """The ``action2=None`` constant-velocity opponent (merging_env.py:152)."""
    return Policy(act=functools.partial(_const_act, C.ACTION_NONE))


def constant_policy(action: int) -> Policy:
    return Policy(act=functools.partial(_const_act, action))


def _random_act(num_actions, params, obs, generator):
    return torch.randint(0, num_actions, (obs.shape[0],), generator=generator,
                         dtype=torch.int32, device=obs.device)


def random_policy(num_actions: int = C.NUM_ACTIONS) -> Policy:
    return Policy(act=functools.partial(_random_act, num_actions))


def eps_greedy_from_q(q_values: torch.Tensor, generator: torch.Generator,
                      epsilon: float = EPSILON,
                      num_actions: int = C.NUM_ACTIONS) -> torch.Tensor:
    """Reference epsilon-greedy over a batch of Q-values ``[N, A]``
    (main.py:105-111): greedy iff a standard normal is ``<= epsilon``."""
    n = q_values.shape[0]
    greedy = torch.randn(n, generator=generator,
                         device=q_values.device) <= epsilon
    rand = torch.randint(0, num_actions, (n,), generator=generator,
                         dtype=torch.int32, device=q_values.device)
    return torch.where(greedy, torch.argmax(q_values, dim=-1).to(torch.int32),
                       rand)


def _q_act(apply_fn, greedy, epsilon, params, obs, generator):
    q = apply_fn(params, obs)
    if greedy:
        return torch.argmax(q, dim=-1).to(torch.int32)
    return eps_greedy_from_q(q, generator, epsilon, q.shape[-1])


def q_policy(apply_fn, params, greedy: bool = False,
             epsilon: float = EPSILON) -> Policy:
    """Epsilon-greedy (or purely greedy) policy over a Q-net ``apply_fn``."""
    return Policy(act=functools.partial(_q_act, apply_fn, greedy, epsilon),
                  params=params)


def two_player(policy1: Policy, policy2: Policy):
    """Compose two single-player policies into a batched rollout
    ``policy_fn``; its state is the pair of policy params."""
    def policy_fn(pstate, obs, generator):
        p1, p2 = pstate
        a1 = policy1.act(p1, obs, generator)
        a2 = policy2.act(p2, swap_obs(obs), generator)
        return pstate, torch.stack([a1, a2], dim=-1)

    return policy_fn, (policy1.params, policy2.params)
