"""Head-to-head policy evaluation (league play).

Counterpart of ``merging_gym_tpu/agents/evaluate.py`` (``evaluate``,
``round_robin``, ``evaluate_fused``): pits two policies against each
other over many vectorised envs and reports the episode outcome
distribution.  ``evaluate`` steps the env in a Python loop (on the card
each Q-net forward is the K3 kernel); ``evaluate_fused`` runs the whole
match as one launch of the K6 kernel.  Both return the same dict.
"""

from __future__ import annotations

import numpy as np
import torch

from merging_gym_tpu_torch.agents.policies import Policy, two_player
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.core.vector import reset_batch, rollout
from merging_gym_tpu_torch.ops.fused_policy_rollout import fused_policy_rollout


def evaluate(policy1: Policy, policy2: Policy, env_params: EnvParams,
             generator: torch.Generator, num_envs: int = 256,
             min_episodes: int = 512, chunk_steps: int = 512,
             max_chunks: int = 64) -> dict:
    """Play until at least ``min_episodes`` finished; return outcome stats.

    Runs on ``generator``'s device.  Outcomes per finished episode:
      * ``p1_first`` / ``p2_first`` -- who crossed the merge point first
        (``winner`` at the done step);
      * ``collisions`` -- episode ended in a collision;
      * ``timeouts`` -- episode hit the step cap with no winner.
    An episode can count in a ``p*_first`` bucket and in ``collisions``.
    """
    policy_fn, pstate = two_player(policy1, policy2)
    state = reset_batch(env_params, generator, num_envs,
                        device=generator.device)

    counts = {"episodes": 0, "p1_first": 0, "p2_first": 0,
              "collisions": 0, "timeouts": 0}
    ret_sums = np.zeros(2)
    ep_r = np.zeros((num_envs, 2))

    with torch.no_grad():
        for _ in range(max_chunks):
            (state, pstate), traj = rollout(env_params, state, policy_fn,
                                            pstate, generator, chunk_steps)
            _accumulate(counts, ret_sums, ep_r, traj)
            if counts["episodes"] >= min_episodes:
                break

    return _finalize(counts, ret_sums)


def _accumulate(counts, ret_sums, ep_r, traj):
    """Fold one chunk's trajectory ([T, N, ...]) into the running counters."""
    done = traj.done.cpu().numpy()
    rewards = traj.rewards.cpu().numpy()
    winner = traj.winner.cpu().numpy()
    collision = traj.collision.cpu().numpy()
    for t in range(done.shape[0]):
        ep_r += rewards[t]
        d = done[t]
        if d.any():
            counts["episodes"] += int(d.sum())
            counts["p1_first"] += int((d & (winner[t] == 1)).sum())
            counts["p2_first"] += int((d & (winner[t] == 2)).sum())
            counts["collisions"] += int((d & collision[t]).sum())
            counts["timeouts"] += int(
                (d & (winner[t] == 0) & ~collision[t]).sum())
            ret_sums += ep_r[d].sum(axis=0)
            ep_r[d] = 0.0


def _finalize(counts, ret_sums):
    eps = max(counts["episodes"], 1)
    return {
        **counts,
        "p1_first_rate": counts["p1_first"] / eps,
        "p2_first_rate": counts["p2_first"] / eps,
        "collision_rate": counts["collisions"] / eps,
        "timeout_rate": counts["timeouts"] / eps,
        "mean_return_p1": float(ret_sums[0]) / eps,
        "mean_return_p2": float(ret_sums[1]) / eps,
    }


def round_robin(named_policies: dict, env_params: EnvParams,
                generator: torch.Generator, **kwargs) -> dict:
    """All ordered pairs of a policy dict -> results keyed ``"A vs B"``."""
    return {f"{n1} vs {n2}": evaluate(p1, p2, env_params, generator, **kwargs)
            for n1, p1 in named_policies.items()
            for n2, p2 in named_policies.items() if n1 != n2}


def evaluate_fused(params1, params2=None, env_params: EnvParams | None = None,
                   num_envs: int = 4096, num_steps: int = 2600,
                   greedy: bool = True, epsilon: float = 0.7, seed: int = 0,
                   compute_dtype: str = "float32", device=None) -> dict:
    """``evaluate`` as one launch of the policy-rollout kernel (K6).

    ``params1``/``params2`` are Q-net param dicts; ``params2=None`` plays
    L0.  With the default ``num_steps`` above the 2,501-step timeout every
    env finishes at least one episode.  Returns of finished episodes only
    enter the mean returns.
    """
    out = fused_policy_rollout(
        num_steps, num_envs, params1, params2, greedy=greedy,
        epsilon=epsilon, seed=seed, env_params=env_params or EnvParams(),
        compute_dtype=compute_dtype, device=device)
    d = out["done"].cpu().numpy()                 # [T, N]
    winner = out["winner"].cpu().numpy()
    collision = out["collision"].cpu().numpy()
    rewards = out["rewards"].cpu().numpy()        # [T, 2, N]

    counts = {
        "episodes": int(d.sum()),
        "p1_first": int((d & (winner == 1)).sum()),
        "p2_first": int((d & (winner == 2)).sum()),
        "collisions": int((d & collision).sum()),
        "timeouts": int((d & (winner == 0) & ~collision).sum()),
    }
    # Finished-episode returns: every reward up to each env's last done
    # step (the tail after it belongs to an unfinished episode).
    T = d.shape[0]
    last_done = np.where(d.any(axis=0), T - 1 - d[::-1].argmax(axis=0), -1)
    in_finished = np.arange(T)[:, None] <= last_done[None, :]   # [T, N]
    ret_sums = (rewards * in_finished[:, None, :]).sum(axis=(0, 2))
    return _finalize(counts, ret_sums)
