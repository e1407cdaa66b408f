"""Hierarchical goal-conditioned DQN (h-DQN): the step-loop trainer.

Counterpart of ``merging_gym_tpu/agents/hdqn.py`` (the reference trainer
of scripts/hdqn.py): the meta-controller (hdqn.py:58-139) picks one of 3
goals, the low-level controller (hdqn.py:142-221) picks velocity actions
on the 11-dim ``[goal] + obs`` input (hdqn.py:146,291), and the
intrinsic reward is 1.0 iff the chosen goal matches the achieved
:func:`goal_status` (hdqn.py:223-236,314).  Both learners are
``agents.dqn.learn`` (autograd + the hand-written Adam) on
``HDQNConfig.lower_cfg()`` / ``upper_cfg()``; every actor call is one K4
launch (``ops.fused_actor``), three per step against L0 and five against
an opponent net, each with its own seed from the run seed, the step and
the call's index.  The K4 stream differs from the JAX actor's threefry
stream; the two draw from the same distribution.

Nothing is read back from the card inside a chunk: both learn gates are
device tensors (a gated-off learn is computed and discarded), replay
draws come from the carry's ``torch.Generator``.

The reference's data-dependent two-timescale loop (hdqn.py:281-327)
becomes a per-env ``goal`` and an ``option_start`` mask, with the quirks
of the JAX module (``agents/hdqn.py:1-28``):

* the goal is re-chosen from the post-step obs after *every* env step
  (hdqn.py:303), so an option can drift mid-execution -- the intrinsic
  reward compares the *new* goal with the status of the *pre-step* obs
  (hdqn.py:314);
* an option ends when the env is done or the new goal matches the new
  obs's status (hdqn.py:322-323);
* the meta transition is stored at option end as ``(state, goal,
  extrinsic_return, next_state)`` where both observations are the
  *final* state (hdqn.py:320,325); ``faithful_meta=False`` stores the
  textbook (option-start obs, option-end obs) pair;
* no winner-based store gating and unconditional reward accumulation
  (hdqn.py:312,316), unlike the flat DQN trainer;
* the opponent's goal is refreshed only at the ego's option boundaries;
* the win is tested on the *post-step* obs (hdqn.py:342), unlike
  ``agents.dqn``;
* goal memory is tiny: 200 slots (hdqn.py:22,75).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from merging_gym_tpu_torch.agents import dqn as D
from merging_gym_tpu_torch.agents.policies import EPSILON
from merging_gym_tpu_torch.core import constants as C
from merging_gym_tpu_torch.core import env as core_env
from merging_gym_tpu_torch.core.env import EnvParams, swap_obs
from merging_gym_tpu_torch.core.vector import (autoreset_step,
                                               observe_after_reset,
                                               reset_batch)
from merging_gym_tpu_torch.device import resolve_device
from merging_gym_tpu_torch.ops import replay as rp
from merging_gym_tpu_torch.ops.collectives import pmin, psum
from merging_gym_tpu_torch.ops.fused_actor import fused_eps_greedy_actions

# K4 launches per step against an opponent net: the ego's goal, action and
# post-step goal, the opponent's goal and action (three against L0).
ACTOR_CALLS = 5


def goal_status(obs: torch.Tensor) -> torch.Tensor:
    """Discretise relative longitudinal position into 3 classes
    (hdqn.py:223-236): dx1 < -0.5*v2 -> 0 (behind); < 0.5*v2 -> 1
    (alongside); else 2 (ahead).  ``obs`` may be batched."""
    dx1, v2 = obs[..., 0], obs[..., 9]
    return torch.where(dx1 < -0.5 * v2, 0,
                       torch.where(dx1 < 0.5 * v2, 1, 2)).to(torch.int32)


def goal_obs(goal: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """``[goal] + state`` input of the low-level net (hdqn.py:291)."""
    return torch.cat([goal[..., None].to(obs.dtype), obs], dim=-1)


@dataclass(frozen=True)
class HDQNConfig:
    """Hyper-parameters of hdqn.py, with the fields and defaults of the
    JAX ``HDQNConfig``."""

    batch_size: int = 128
    lr: float = 0.01
    gamma: float = 0.90
    epsilon: float = EPSILON
    memory_capacity: int = 2000
    goal_memory_capacity: int = 200
    target_sync: int = 100
    obs_dim: int = C.OBS_DIM
    num_actions: int = C.NUM_ACTIONS
    num_goals: int = C.NUM_GOALS
    hidden: tuple = (200, 100)
    mask_terminal: bool = False
    opponent: str = D.OPP_L0
    faithful_meta: bool = True
    # Data-parallel training: "data" marks a config whose steps take the
    # mesh's data group as ``axis`` (``parallel.spmd.spmd_hdqn_chunk``),
    # which averages both learns, gates the upper learn and sums the
    # metrics.
    pmean_axis: str | None = None
    # Both learners' forwards (agents.dqn contract: compute-dtype
    # operands, f32 masters and moments); flows into K7 too.
    compute_dtype: str = "float32"

    def replace(self, **changes) -> "HDQNConfig":
        return dataclasses.replace(self, **changes)

    def lower_cfg(self) -> D.DQNConfig:
        return D.DQNConfig(
            batch_size=self.batch_size, lr=self.lr, gamma=self.gamma,
            epsilon=self.epsilon, memory_capacity=self.memory_capacity,
            target_sync=self.target_sync, obs_dim=self.obs_dim + 1,
            num_actions=self.num_actions, hidden=self.hidden,
            mask_terminal=self.mask_terminal,
            compute_dtype=self.compute_dtype)

    def upper_cfg(self) -> D.DQNConfig:
        return D.DQNConfig(
            batch_size=self.batch_size, lr=self.lr, gamma=self.gamma,
            epsilon=self.epsilon, memory_capacity=self.goal_memory_capacity,
            target_sync=self.target_sync, obs_dim=self.obs_dim,
            num_actions=self.num_goals, hidden=self.hidden,
            mask_terminal=self.mask_terminal,
            compute_dtype=self.compute_dtype)


@dataclass
class HDQNCarry:
    env_state: core_env.EnvState
    obs: torch.Tensor               # f32[num_envs, 10]
    goal: torch.Tensor              # i32[num_envs] current option
    goal_op: torch.Tensor           # i32[num_envs] opponent option
    option_start_obs: torch.Tensor  # f32[num_envs, 10] (textbook meta mode)
    option_start: torch.Tensor      # bool[num_envs]
    extr_return: torch.Tensor       # f32[num_envs] per-option return
    ep_reward: torch.Tensor         # f32[num_envs]
    upper: D.DQNState
    lower: D.DQNState
    opp_upper_params: Any
    opp_lower_params: Any
    upper_replay: rp.ReplayState
    lower_replay: rp.ReplayState
    generator: torch.Generator      # replay draws and random starts
    seed: int                       # run seed: the actors' Philox keys
    step: int                       # steps taken
    metrics: D.Metrics


def hdqn_init(seed: int, cfg: HDQNConfig, env_params: EnvParams,
              num_envs: int, opp_upper=None, opp_lower=None,
              device=None) -> HDQNCarry:
    """Fresh envs, both nets, both replays and counters for a run with
    ``seed`` (frozen opponents: ``opp_upper``/``opp_lower`` on the same
    device)."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    env_state = reset_batch(env_params, generator, num_envs, device=dev)
    obs = core_env.observe(env_state)
    upper = D.dqn_init(generator, cfg.upper_cfg(), dev)
    lower = D.dqn_init(generator, cfg.lower_cfg(), dev)
    if cfg.opponent == D.OPP_FROZEN:
        if opp_upper is None or opp_lower is None:
            raise ValueError("a frozen opponent needs opp_upper and "
                             "opp_lower")
    else:  # placeholders with the right structure
        opp_upper, opp_lower = upper.params, lower.params
    zeros_i = torch.zeros(num_envs, dtype=torch.int32, device=dev)
    return HDQNCarry(
        env_state=env_state, obs=obs, goal=zeros_i, goal_op=zeros_i,
        option_start_obs=obs.to(torch.float32),
        option_start=torch.ones(num_envs, dtype=torch.bool, device=dev),
        extr_return=torch.zeros(num_envs, dtype=torch.float32, device=dev),
        ep_reward=torch.zeros(num_envs, dtype=torch.float32, device=dev),
        upper=upper, lower=lower,
        opp_upper_params=opp_upper, opp_lower_params=opp_lower,
        upper_replay=rp.replay_init(cfg.goal_memory_capacity,
                                    D.transition_example(cfg.upper_cfg(),
                                                         dev)),
        lower_replay=rp.replay_init(cfg.memory_capacity,
                                    D.transition_example(cfg.lower_cfg(),
                                                         dev)),
        generator=generator, seed=seed, step=0, metrics=D.Metrics.zero(dev))


def actor_seed(run_seed: int, step: int, call: int) -> int:
    """Philox key of actor call ``call`` (0 <= call < ACTOR_CALLS) at
    ``step``: the run seed in the high word, ``ACTOR_CALLS * step + call``
    in the low one."""
    return (((run_seed & 0xFFFFFFFF) << 32)
            | ((ACTOR_CALLS * step + call) & 0xFFFFFFFF))


def _choose_goals(params, obs, seed: int, cfg: HDQNConfig):
    # The JAX actors run the f32 forward whatever compute_dtype says.
    return fused_eps_greedy_actions(params, obs, seed, cfg.epsilon)


def _choose_actions_lower(params, goal, obs, seed: int, cfg: HDQNConfig):
    return fused_eps_greedy_actions(params, goal_obs(goal, obs), seed,
                                    cfg.epsilon)


def hdqn_step(cfg: HDQNConfig, env_params: EnvParams, carry: HDQNCarry,
              axis=None) -> HDQNCarry:
    """One lockstep step of both controllers, both replays and both
    learners over all envs.  ``axis``: the mesh's data group, given with
    ``cfg.pmean_axis`` (as ``agents.dqn.learn`` takes it)."""
    D.check_axis(cfg.pmean_axis, axis, "spmd_hdqn_chunk")
    obs = carry.obs

    def seed(call):
        return actor_seed(carry.seed, carry.step, call)

    # Fresh options where the previous one ended (outer loop top,
    # hdqn.py:283-286): re-choose the goal and zero the extrinsic return.
    goal_fresh = _choose_goals(carry.upper.params, obs, seed(0), cfg)
    goal = torch.where(carry.option_start, goal_fresh, carry.goal)
    extr = torch.where(carry.option_start, 0.0, carry.extr_return)
    start_obs = torch.where(carry.option_start[:, None],
                            obs.to(torch.float32), carry.option_start_obs)

    # The opponent's goal is refreshed at the ego's boundaries (hdqn.py:285).
    if cfg.opponent == D.OPP_L0:
        goal_op = carry.goal_op
        a2 = torch.full_like(goal, C.ACTION_NONE)
    else:
        opp_obs = swap_obs(obs)
        selfplay = cfg.opponent == D.OPP_SELFPLAY
        up_op = carry.upper.params if selfplay else carry.opp_upper_params
        lo_op = carry.lower.params if selfplay else carry.opp_lower_params
        goal_op = torch.where(carry.option_start,
                              _choose_goals(up_op, opp_obs, seed(3), cfg),
                              carry.goal_op)
        a2 = _choose_actions_lower(lo_op, goal_op, opp_obs, seed(4), cfg)

    a1 = _choose_actions_lower(carry.lower.params, goal, obs, seed(1), cfg)
    env_state, ts = autoreset_step(env_params, carry.env_state,
                                   torch.stack([a1, a2], dim=-1),
                                   carry.generator)
    next_obs_env = observe_after_reset(env_params, env_state, ts)

    # Goal re-chosen from the post-step state every step (hdqn.py:303).
    goal_new = _choose_goals(carry.upper.params, ts.obs, seed(2), cfg)
    # Intrinsic reward: new goal vs pre-step status (hdqn.py:314).
    intrinsic = (goal_new == goal_status(obs)).to(torch.float32)

    lower_replay = rp.add_batch(carry.lower_replay, {
        "obs": goal_obs(goal, obs).to(torch.float32),
        "action": a1,
        "reward": intrinsic,
        "next_obs": goal_obs(goal_new, ts.obs).to(torch.float32),
        "done": ts.done,
    })
    batch, _ = rp.sample(lower_replay, carry.generator, cfg.batch_size)
    lower = D._where_state(rp.can_learn(lower_replay),
                           D.learn(carry.lower, batch, cfg.lower_cfg(),
                                   axis=axis),
                           carry.lower)

    # Option termination (hdqn.py:322-323).
    extr = extr + ts.rewards[:, 0]
    option_end = ts.done | (goal_new == goal_status(ts.obs))
    upper_replay = rp.add_batch(carry.upper_replay, {
        "obs": (ts.obs.to(torch.float32) if cfg.faithful_meta
                else start_obs),
        "action": goal_new,
        "reward": extr,
        "next_obs": ts.obs.to(torch.float32),
        "done": ts.done,
    }, option_end)
    # One meta learn per step when any option ended (the reference: one
    # per option end, hdqn.py:326-327; at one env this matches exactly).
    # Under SPMD the gate is a global decision: option ends and masked
    # goal-memory fills differ per rank.
    batch, _ = rp.sample(upper_replay, carry.generator, cfg.batch_size)
    upper_fill, any_end = upper_replay.cursor, option_end.any()
    if axis is not None:
        upper_fill = pmin(upper_fill, axis)
        any_end = psum(any_end.to(torch.int64), axis) > 0
    gate = (upper_fill >= cfg.goal_memory_capacity) & any_end
    upper = D._where_state(gate, D.learn(carry.upper, batch,
                                         cfg.upper_cfg(), axis=axis),
                           carry.upper)

    # Metrics (hdqn.py:330-346): unconditional reward accumulation; the
    # win is tested on the post-step obs (hdqn.py:342 reads the state
    # after `state = next_state`, unlike main.py).
    done = ts.done
    ep_reward = carry.ep_reward + ts.rewards[:, 0]
    won = done & (ts.obs[:, 8] > ts.obs[:, 3])
    metrics = D.add_metrics(carry.metrics, done, ts.collision, won,
                            ep_reward, axis)
    return HDQNCarry(
        env_state=env_state, obs=next_obs_env, goal=goal_new,
        goal_op=goal_op, option_start_obs=start_obs,
        option_start=option_end,
        extr_return=torch.where(option_end, 0.0, extr),
        ep_reward=torch.where(done, 0.0, ep_reward),
        upper=upper, lower=lower,
        opp_upper_params=carry.opp_upper_params,
        opp_lower_params=carry.opp_lower_params,
        upper_replay=upper_replay, lower_replay=lower_replay,
        generator=carry.generator, seed=carry.seed, step=carry.step + 1,
        metrics=metrics)


def hdqn_train_chunk(cfg: HDQNConfig, env_params: EnvParams,
                     carry: HDQNCarry, num_steps: int,
                     axis=None) -> HDQNCarry:
    """``num_steps`` hierarchical training steps."""
    for _ in range(num_steps):
        carry = hdqn_step(cfg, env_params, carry, axis)
    return carry
