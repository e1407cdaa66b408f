"""Head-to-head policy evaluation (league play).

Counterpart of ``merging_gym_tpu/agents/evaluate.py`` (``evaluate``,
``round_robin``, ``evaluate_fused``): pits two policies against each
other over many vectorised envs and reports the episode outcome
distribution.  ``evaluate`` steps the env in a Python loop (on the card
each Q-net forward is the K3 kernel); ``evaluate_fused`` runs the whole
match as one launch of the K6 kernel; ``evaluate_drqn`` / ``evaluate_mixed``
play a recurrent (DRQN) seat, whose per-env LSTM state the stateless
policy protocol cannot carry.  All return the same dict.
"""

from __future__ import annotations

import numpy as np
import torch

from merging_gym_tpu_torch.agents.policies import (EPSILON, Policy,
                                                   eps_greedy_from_q,
                                                   l0_policy, two_player)
from merging_gym_tpu_torch.core import env as core_env
from merging_gym_tpu_torch.core.env import EnvParams, TimeStep, swap_obs
from merging_gym_tpu_torch.core.vector import (autoreset_step,
                                               observe_after_reset,
                                               reset_batch, rollout)
from merging_gym_tpu_torch.device import tensor_device
from merging_gym_tpu_torch.nn.lstm import drqn_step, lstm_zero_carry
from merging_gym_tpu_torch.ops.fused_policy_rollout import fused_policy_rollout
from merging_gym_tpu_torch.utils.profiling import span


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
    enter the mean returns.  The events are reduced where they lie
    (:func:`fused_outcomes`), and only the seven sums come back.
    """
    out = fused_policy_rollout(
        num_steps, num_envs, params1, params2, greedy=greedy,
        epsilon=epsilon, seed=seed, env_params=env_params or EnvParams(),
        compute_dtype=compute_dtype, device=device)
    with span("mgt.eval.outcomes"):
        sums = fused_outcomes(out["done"], out["winner"], out["collision"],
                              out["rewards"])
        with span("mgt.readback"):
            sums = sums.tolist()                       # the one read-back
    counts = {k: int(v) for k, v in zip(OUTCOME_COUNTS, sums)}
    return _finalize(counts, sums[len(OUTCOME_COUNTS):])


OUTCOME_COUNTS = ("episodes", "p1_first", "p2_first", "collisions",
                  "timeouts")


def fused_outcomes(done, winner, collision, rewards) -> torch.Tensor:
    """The outcome counts and finished-episode return sums of a fused
    rollout's events (``done``/``collision`` bool[T, N], ``winner``
    i32[T, N], ``rewards`` f32[T, 2, N]) on their own device: f64[7], the
    ``OUTCOME_COUNTS`` (exact int64 sums) then player 1's and player 2's
    return sums (f32 sums, as the JAX package's numpy takes them).  A
    finished episode's return is every reward up to its env's last done
    step; the tail after it belongs to an unfinished episode.
    """
    counts = torch.stack([
        done.sum(), (done & (winner == 1)).sum(), (done & (winner == 2)).sum(),
        (done & collision).sum(), (done & (winner == 0) & ~collision).sum()])
    steps = torch.arange(done.shape[0], device=done.device)[:, None]
    last_done = torch.where(done, steps, -1).amax(dim=0)          # [N]
    in_finished = steps <= last_done                              # [T, N]
    ret_sums = (rewards * in_finished[:, None, :]).sum(dim=(0, 2))
    return torch.cat([counts.double(), ret_sums.double()])


def evaluate_drqn(params1, policy2: Policy | None = None,
                  env_params: EnvParams | None = None,
                  generator: torch.Generator | None = None,
                  num_envs: int = 256, min_episodes: int = 512,
                  chunk_steps: int = 512, max_chunks: int = 64,
                  greedy: bool = False, epsilon: float = EPSILON,
                  drqn_params2=None) -> dict:
    """:func:`evaluate` with a DRQN (``nn.lstm`` params) in seat 1.

    Seat 2 is a stateless :class:`Policy` (default L0, the reference's
    ``action2=None`` opponent) or, with ``drqn_params2``, a second DRQN
    with its own recurrent state.  See :func:`evaluate_mixed`.
    """
    if drqn_params2 is not None:
        if policy2 is not None:
            raise ValueError("pass either a stateless policy2 or "
                             "drqn_params2, not both")
        seat2 = ("drqn", drqn_params2)
    else:
        seat2 = ("policy", policy2 if policy2 is not None else l0_policy())
    return evaluate_mixed(("drqn", params1), seat2, env_params, generator,
                          num_envs, min_episodes, chunk_steps, max_chunks,
                          greedy, epsilon)


def evaluate_mixed(seat1, seat2, env_params: EnvParams | None = None,
                   generator: torch.Generator | None = None,
                   num_envs: int = 256, min_episodes: int = 512,
                   chunk_steps: int = 512, max_chunks: int = 64,
                   greedy: bool = False, epsilon: float = EPSILON) -> dict:
    """:func:`evaluate` where either seat may be recurrent.

    Each seat is ``("policy", Policy)`` or ``("drqn", nn.lstm params)``.  A
    DRQN seat carries per-env LSTM state across steps, zeroed on episode
    reset, and acts by its argmax (``greedy``) or the Phi(eps)-greedy pick;
    seat 2 acts on the half-swapped obs (main.py:199).  Runs on the
    generator's device (default: a generator seeded with 0 on the device
    of the first DRQN seat's params).
    """
    for kind, _ in (seat1, seat2):
        if kind not in ("policy", "drqn"):
            raise ValueError(f"unknown seat kind {kind!r}")
    env_params = env_params or EnvParams()
    if generator is None:
        params = next(p for kind, p in (seat1, seat2) if kind == "drqn")
        generator = torch.Generator(device=tensor_device(params))
        generator.manual_seed(0)
    dev = generator.device
    state = reset_batch(env_params, generator, num_envs, device=dev)
    obs = core_env.observe(state)
    carries = [lstm_zero_carry((num_envs,), device=dev) for _ in range(2)]

    def act(seat, i, x):
        kind, payload = seat
        if kind == "policy":
            return payload.act(payload.params, x, generator)
        q, carries[i] = drqn_step(payload, x, carries[i])
        if greedy:
            return torch.argmax(q, dim=-1).to(torch.int32)
        return eps_greedy_from_q(q, generator, epsilon, q.shape[-1])

    counts = {"episodes": 0, "p1_first": 0, "p2_first": 0,
              "collisions": 0, "timeouts": 0}
    ret_sums = np.zeros(2)
    ep_r = np.zeros((num_envs, 2))
    with torch.no_grad():
        for _ in range(max_chunks):
            steps = []
            for _ in range(chunk_steps):
                actions = torch.stack([act(seat1, 0, obs),
                                       act(seat2, 1, swap_obs(obs))], dim=-1)
                state, ts = autoreset_step(env_params, state, actions,
                                           generator)
                obs = observe_after_reset(env_params, state, ts)
                d = ts.done[:, None]
                carries = [(torch.where(d, 0.0, h), torch.where(d, 0.0, c))
                           for h, c in carries]
                steps.append(ts)
            _accumulate(counts, ret_sums, ep_r, TimeStep(**{
                f: torch.stack([getattr(s, f) for s in steps])
                for f in TimeStep.__dataclass_fields__}))
            if counts["episodes"] >= min_episodes:
                break
    return _finalize(counts, ret_sums)
