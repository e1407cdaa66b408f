"""Vectorised auto-resetting env and the policy-driven rollout loop.

Counterpart of ``merging_gym_tpu/core/vector.py``.  The env functions in
``core.env`` are already batched, so ``step_batch`` is ``step``; the JAX
``lax.scan`` becomes a Python loop over batched tensors.  The hot paths
that replace this loop with one kernel launch are ``ops.fused_rollout``
(action streams) and ``ops.fused_policy_rollout`` (Q-net policies).
"""

from __future__ import annotations

import torch

from merging_gym_tpu_torch.core import env as core_env
from merging_gym_tpu_torch.core.env import EnvParams, EnvState, TimeStep


def reset_batch(params: EnvParams, generator: torch.Generator | None,
                num_envs: int, dtype=torch.float32, device=None) -> EnvState:
    """Batched reset; random starts draw from ``generator``."""
    return core_env.reset(params, generator, num_envs, dtype, device)


def step_batch(params: EnvParams, state: EnvState, actions: torch.Tensor):
    """Batched step. ``actions``: int[num_envs, 2]."""
    return core_env.step(params, state, actions)


def autoreset_step(params: EnvParams, state: EnvState, actions: torch.Tensor,
                   generator: torch.Generator | None = None):
    """Step all envs, then reset the ones that finished.

    The returned ``TimeStep`` carries the pre-reset terminal observation;
    the returned state is post-reset.
    """
    next_state, ts = step_batch(params, state, actions)
    n = ts.done.shape[0]
    fresh = reset_batch(params, generator, n, state.pos.dtype, state.pos.device)
    d = ts.done

    def pick(new, old):
        return torch.where(d.reshape((n,) + (1,) * (old.dim() - 1)), new, old)

    return EnvState(**{f: pick(getattr(fresh, f), getattr(next_state, f))
                       for f in EnvState.__dataclass_fields__}), ts


def observe_after_reset(params: EnvParams, state: EnvState, ts: TimeStep):
    """Post-auto-reset observation: ``ts.obs`` where the env ran on, the
    start observation where it was reset."""
    if params.random_start:
        return core_env.observe(state)
    fresh = core_env.observe(core_env.reset(
        params, None, 1, state.pos.dtype, state.pos.device))
    return torch.where(ts.done[:, None], fresh.to(ts.obs.dtype), ts.obs)


def rollout(params: EnvParams, state: EnvState, policy_fn, policy_state,
            generator: torch.Generator | None, num_steps: int,
            collect: str = "full"):
    """``num_steps`` lockstep env steps driven by ``policy_fn``.

    ``policy_fn(policy_state, obs_batch, generator) -> (policy_state,
    actions)`` with ``actions`` int[num_envs, 2].  ``collect``:
      * ``"full"``    -- the whole ``TimeStep``, stacked to ``[T, N, ...]``;
      * ``"rewards"`` -- ``(rewards, done)`` only;
      * ``"none"``    -- nothing per step.
    """
    if collect not in ("full", "rewards", "none"):
        raise ValueError(f"unknown collect mode {collect!r}")
    obs = core_env.observe(state)
    steps = []
    for _ in range(num_steps):
        policy_state, actions = policy_fn(policy_state, obs, generator)
        state, ts = autoreset_step(params, state, actions, generator)
        obs = observe_after_reset(params, state, ts)
        if collect == "full":
            steps.append(ts)
        elif collect == "rewards":
            steps.append((ts.rewards, ts.done))
    if collect == "full":
        traj = TimeStep(**{f: torch.stack([getattr(s, f) for s in steps])
                           for f in TimeStep.__dataclass_fields__})
    elif collect == "rewards":
        traj = (torch.stack([s[0] for s in steps]),
                torch.stack([s[1] for s in steps]))
    else:
        traj = None
    return (state, policy_state), traj
