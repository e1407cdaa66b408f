"""Recurrent DQN (DRQN): the step-loop trainer with sequence replay.

Counterpart of ``merging_gym_tpu/agents/drqn.py``: the working version of
the reference's dead DRQN (main.py:49-74).  Design, as in JAX:

* the actor carries per-env LSTM state, zeroed on episode reset;
* each env accumulates non-overlapping windows of ``seq_len`` steps (an
  obs window of ``seq_len + 1`` for bootstrap targets), emitted into a
  sequence replay ring (``ops.replay``; items ``{obs [L+1, 10], action
  [L], reward [L], done [L]}``);
* the learner samples whole windows, unrolls the eval and target nets
  from zero state, takes Double-DQN targets per timestep after a burn-in
  prefix and masks timesteps past the first in-window episode end;
* hyper-parameters default to the flat DQN's (Adam 0.01, gamma 0.90,
  target sync every 100 learns, Phi(0.7)-greedy);
* opponents: ``L0``, ``selfplay`` (the live net on the half-swapped obs
  with its OWN per-env LSTM state) and ``frozen`` (a frozen DRQN, also
  with its own state); both seats' state is zeroed on reset.

Quirks of the JAX step kept: slot ``idx + 1`` of the window gets the
pre-reset obs; windows flush on every lane on the same step and span
episode boundaries; after a flush only ``obs`` and ``done`` are cleared,
so ``action`` and ``reward`` keep stale values; the win is read from the
pre-step obs; the episode reward accumulates on every step.

The learner is autograd through :func:`drqn_loss` (``torch.matmul``) and
the hand-written Adam of ``agents.dqn`` in optax's formula.  Nothing is
read back from the card inside a chunk: the learn gate (``cursor >=
batch_size``) is a device tensor (a gated-off learn is computed and
discarded), and every draw comes from the carry's ``torch.Generator``.
The actor's draws differ from JAX's threefry stream; the two draw from the
same distribution.

Data-parallel training (``pmean_axis="data"``, ``parallel.spmd.
spmd_drqn_chunk``): a step given the mesh's data group as ``axis`` gates
the learner on the group minimum of the ring cursors, averages the
gradients and the loss over the group before Adam and sums the metric
increments; the learn count, and with it the every-``target_sync`` copy,
stays equal on every rank.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from merging_gym_tpu_torch.agents import dqn as D
from merging_gym_tpu_torch.agents.policies import EPSILON, eps_greedy_from_q
from merging_gym_tpu_torch.core import constants as C
from merging_gym_tpu_torch.core import env as core_env
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.core.vector import (autoreset_step,
                                               observe_after_reset,
                                               reset_batch)
from merging_gym_tpu_torch.device import resolve_device
from merging_gym_tpu_torch.nn.lstm import (drqn_init, drqn_step, drqn_unroll,
                                           lstm_zero_carry)
from merging_gym_tpu_torch.ops import replay as rp
from merging_gym_tpu_torch.ops.collectives import pmean, pmin


@dataclass(frozen=True)
class DRQNConfig:
    """The fields and defaults of the JAX ``DRQNConfig``."""

    batch_size: int = 32
    lr: float = 0.01
    gamma: float = 0.90
    epsilon: float = EPSILON
    memory_capacity: int = 512
    target_sync: int = 100
    obs_dim: int = C.OBS_DIM
    num_actions: int = C.NUM_ACTIONS
    seq_len: int = 16
    burn_in: int = 4
    opponent: str = D.OPP_L0
    # Data-parallel training: "data" marks a config whose steps take the
    # mesh's data group as ``axis`` (``parallel.spmd.spmd_drqn_chunk``).
    pmean_axis: str | None = None

    def replace(self, **changes) -> "DRQNConfig":
        return dataclasses.replace(self, **changes)


@dataclass
class DRQNCarry:
    env_state: core_env.EnvState
    obs: torch.Tensor          # f32[envs, 10]
    lstm_h: torch.Tensor       # f32[envs, hidden]
    lstm_c: torch.Tensor
    lstm_h2: torch.Tensor      # the opponent seat's state (zeros and unused
    lstm_c2: torch.Tensor      # under L0)
    opp_params: Any            # frozen opponent params (None unless frozen)
    window: dict               # {obs [envs, L+1, d], action, reward, done}
    window_len: torch.Tensor   # i32[envs]
    ep_reward: torch.Tensor
    params: dict
    target_params: dict
    opt_state: D.AdamState
    learn_counter: torch.Tensor  # i32 0-d
    last_loss: torch.Tensor      # f32 0-d
    replay: rp.ReplayState
    generator: torch.Generator   # actions, replay draws and random starts
    metrics: D.Metrics


def _window_example(cfg: DRQNConfig, device) -> dict:
    L = cfg.seq_len
    return {
        "obs": torch.zeros(L + 1, cfg.obs_dim, device=device),
        "action": torch.zeros(L, dtype=torch.int32, device=device),
        "reward": torch.zeros(L, device=device),
        "done": torch.zeros(L, dtype=torch.bool, device=device),
    }


def drqn_train_init(seed: int, cfg: DRQNConfig, env_params: EnvParams,
                    num_envs: int, opp_params=None,
                    device=None) -> DRQNCarry:
    """Fresh envs, eval and target nets (drawn one after the other from a
    generator seeded with ``seed``), windows, ring and counters."""
    if cfg.opponent == D.OPP_FROZEN:
        if opp_params is None:
            raise ValueError("frozen opponent needs params")
    elif opp_params is not None:
        raise ValueError(f"opponent={cfg.opponent!r} takes no params")
    # Windows flush on every lane on the same step, so a ring smaller than
    # one flush would scatter num_envs windows onto fewer slots.
    if cfg.memory_capacity < num_envs:
        raise ValueError(
            f"memory_capacity={cfg.memory_capacity} < num_envs={num_envs}: "
            "the sequence ring must hold at least one synchronized flush")
    dev = resolve_device(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    env_state = reset_batch(env_params, generator, num_envs, device=dev)
    obs = core_env.observe(env_state)
    params = drqn_init(generator, cfg.obs_dim, cfg.num_actions, device=dev)
    target = drqn_init(generator, cfg.obs_dim, cfg.num_actions, device=dev)
    L = cfg.seq_len
    window = {
        "obs": torch.zeros(num_envs, L + 1, cfg.obs_dim, device=dev),
        "action": torch.zeros(num_envs, L, dtype=torch.int32, device=dev),
        "reward": torch.zeros(num_envs, L, device=dev),
        "done": torch.zeros(num_envs, L, dtype=torch.bool, device=dev),
    }
    window["obs"][:, 0] = obs.to(torch.float32)
    h, c = lstm_zero_carry((num_envs,), device=dev)
    h2, c2 = lstm_zero_carry((num_envs,), device=dev)
    return DRQNCarry(
        env_state=env_state, obs=obs, lstm_h=h, lstm_c=c, lstm_h2=h2,
        lstm_c2=c2, opp_params=opp_params, window=window,
        window_len=torch.zeros(num_envs, dtype=torch.int32, device=dev),
        ep_reward=torch.zeros(num_envs, device=dev),
        params=params, target_params=target,
        opt_state=D.AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                              D._tree_map(torch.zeros_like, params),
                              D._tree_map(torch.zeros_like, params)),
        learn_counter=torch.zeros((), dtype=torch.int32, device=dev),
        last_loss=torch.zeros((), device=dev),
        replay=rp.replay_init(cfg.memory_capacity, _window_example(cfg, dev)),
        generator=generator, metrics=D.Metrics.zero(dev))


def drqn_loss(params, target_params, batch, cfg: DRQNConfig):
    """Double-DQN over sequences from zero start state, with burn-in and
    first-done masks; the mean over valid positions.

    batch: {obs [B, L+1, d], action [B, L], reward [B, L], done [B, L]}.
    Differentiable in ``params`` only.
    """
    obs = batch["obs"].transpose(0, 1)            # [L+1, B, d]
    B = obs.shape[1]
    dev = obs.device
    q_all, _ = drqn_unroll(params, obs, lstm_zero_carry((B,), device=dev))
    with torch.no_grad():
        qt_all, _ = drqn_unroll(target_params, obs,
                                lstm_zero_carry((B,), device=dev))
        a_star = torch.argmax(q_all[1:].detach(), dim=-1, keepdim=True)
        bootstrap = qt_all[1:].gather(-1, a_star)[..., 0]
        action = batch["action"].transpose(0, 1).long()
        reward = batch["reward"].transpose(0, 1)
        done = batch["done"].transpose(0, 1)
        target = reward + cfg.gamma * bootstrap * (1.0 - done.to(
            bootstrap.dtype))
        # Valid: past burn-in and not after an in-window episode end.
        ended_before = torch.cat([
            torch.zeros(1, B, dtype=torch.bool, device=dev),
            torch.cumsum(done[:-1].to(torch.int32), dim=0) > 0])
        t_idx = torch.arange(cfg.seq_len, device=dev)[:, None]
        mask = ((t_idx >= cfg.burn_in) & ~ended_before).to(torch.float32)
    q_sel = q_all[:-1].gather(-1, action[..., None])[..., 0]
    err = (q_sel - target) ** 2
    return torch.sum(err * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def _learn(carry: DRQNCarry, batch, cfg: DRQNConfig, axis=None):
    """One Adam step with the every-``target_sync``-learns target sync
    applied before the update: ``(params, target, opt_state, loss)``.
    Given a process group ``axis``, the gradients and the loss are averaged
    over it before Adam (each rank's batch is drawn from its own ring)."""
    sync = carry.learn_counter % cfg.target_sync == 0
    target = D._tree_map(lambda e, t: torch.where(sync, e, t), carry.params,
                         carry.target_params)
    with torch.enable_grad():
        params = D._tree_map(lambda p: p.detach().requires_grad_(True),
                             carry.params)
        loss = drqn_loss(params, target, batch, cfg)
        flat = torch.autograd.grad(loss, D._leaves(params))
    loss = loss.detach()
    if axis is not None:
        *flat, loss = pmean([*flat, loss], axis)
    it = iter(flat)
    grads = D._tree_map(lambda _: next(it), params)
    new_params, opt = D._adam(carry.params, grads, carry.opt_state, cfg.lr)
    return new_params, target, opt, loss.to(torch.float32)


def drqn_train_step(cfg: DRQNConfig, env_params: EnvParams,
                    carry: DRQNCarry, axis=None) -> DRQNCarry:
    """One lockstep actor + window + replay + learner step.  ``axis``: the
    mesh's data group, given with ``cfg.pmean_axis``."""
    D.check_axis(cfg.pmean_axis, axis, "spmd_drqn_chunk")
    gen = carry.generator
    obs = carry.obs
    n = obs.shape[0]

    # Recurrent actor: one LSTM step per env step, hidden state carried.
    q, (h, c) = drqn_step(carry.params, obs, (carry.lstm_h, carry.lstm_c))
    a1 = eps_greedy_from_q(q, gen, cfg.epsilon, cfg.num_actions)
    # The opponent seat (main.py:161-168 modes, recurrent analogue) runs its
    # own LSTM step on the half-swapped obs (main.py:199).
    h2, c2 = carry.lstm_h2, carry.lstm_c2
    if cfg.opponent == D.OPP_L0:
        a2 = torch.full_like(a1, C.ACTION_NONE)
    else:
        opp = (carry.params if cfg.opponent == D.OPP_SELFPLAY
               else carry.opp_params)
        q2, (h2, c2) = drqn_step(opp, core_env.swap_obs(obs), (h2, c2))
        a2 = eps_greedy_from_q(q2, gen, cfg.epsilon, cfg.num_actions)
    env_state, ts = autoreset_step(env_params, carry.env_state,
                                   torch.stack([a1, a2], dim=-1), gen)
    next_obs = observe_after_reset(env_params, env_state, ts)

    # The recurrent state must not leak across episodes: both seats.
    dcol = ts.done[:, None]
    h, c = torch.where(dcol, 0.0, h), torch.where(dcol, 0.0, c)
    h2, c2 = torch.where(dcol, 0.0, h2), torch.where(dcol, 0.0, c2)

    # Window accumulation: slot idx + 1 gets the pre-reset obs.
    L = cfg.seq_len
    rows = torch.arange(n, device=obs.device)
    idx = torch.clamp_max(carry.window_len, L - 1).long()
    w = {k: v.clone() for k, v in carry.window.items()}
    w["obs"][rows, idx + 1] = ts.obs.to(torch.float32)
    w["action"][rows, idx] = a1
    w["reward"][rows, idx] = ts.rewards[:, 0].to(torch.float32)
    w["done"][rows, idx] = ts.done
    wl = carry.window_len + 1
    emit = wl >= L
    replay = rp.add_batch(carry.replay, w, emit)

    # Restart only the windows that emitted (they span episode boundaries;
    # the loss's first-done mask drops the steps past an episode end).
    wl = torch.where(emit, 0, wl)
    fresh = torch.zeros_like(w["obs"])
    fresh[:, 0] = next_obs.to(torch.float32)
    w["obs"] = torch.where(emit[:, None, None], fresh, w["obs"])
    w["done"] = torch.where(emit[:, None], torch.zeros_like(w["done"]),
                            w["done"])

    # Learner, gated on a device tensor; under a group the gate is global.
    batch, _ = rp.sample_valid(replay, gen, cfg.batch_size)
    fill = replay.cursor if axis is None else pmin(replay.cursor, axis)
    gate = fill >= cfg.batch_size
    params, target, opt, loss = _learn(carry, batch, cfg, axis)

    def pick(new, old):
        return D._tree_map(lambda a, b: torch.where(gate, a, b), new, old)

    opt = D.AdamState(torch.where(gate, opt.count, carry.opt_state.count),
                      pick(opt.mu, carry.opt_state.mu),
                      pick(opt.nu, carry.opt_state.nu))

    # Metrics: every reward counts; the win is read from the pre-step obs
    # (main.py:225).
    ep_reward = carry.ep_reward + ts.rewards[:, 0]
    done = ts.done
    won = done & (obs[:, 8] > obs[:, 3])
    metrics = D.add_metrics(carry.metrics, done, ts.collision, won,
                            ep_reward, axis)
    return DRQNCarry(
        env_state=env_state, obs=next_obs, lstm_h=h, lstm_c=c, lstm_h2=h2,
        lstm_c2=c2, opp_params=carry.opp_params, window=w, window_len=wl,
        ep_reward=torch.where(done, 0.0, ep_reward),
        params=pick(params, carry.params),
        target_params=pick(target, carry.target_params), opt_state=opt,
        learn_counter=carry.learn_counter + gate.to(torch.int32),
        last_loss=torch.where(gate, loss, carry.last_loss),
        replay=replay, generator=gen, metrics=metrics)


def drqn_train_chunk(cfg: DRQNConfig, env_params: EnvParams,
                     carry: DRQNCarry, num_steps: int,
                     axis=None) -> DRQNCarry:
    """``num_steps`` recurrent actor + learner steps."""
    for _ in range(num_steps):
        carry = drqn_train_step(cfg, env_params, carry, axis)
    return carry
