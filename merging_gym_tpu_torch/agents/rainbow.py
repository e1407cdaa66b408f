"""Rainbow DQN (C51 + NoisyNet + Dueling, optional PER / n-step): the
step-loop trainer.

Counterpart of ``merging_gym_tpu/agents/rainbow.py`` (the reference
trainer of scripts/ranbowdqn.py:623-700): vectorised envs, the replay and
the learner advance in lockstep, one Python-loop step at a time (the JAX
``lax.scan``).  The net is ``nn.rainbow_net`` (``torch.matmul``); the
learner is autograd through :func:`rainbow_loss` and the hand-written Adam
of ``agents.dqn`` (optax's formula).  The learn gate and the
noise-resample gate are device tensors (a gated-off learn is computed and
discarded), replay draws and noise come from the carry's
``torch.Generator``, so nothing is read back inside a chunk.  A frozen
opponent acts through K4 (``ops.fused_actor``) with the reference's
Phi(0.7)-greedy rule, its seed from the run seed and the step.

Reference semantics kept (the quirks of the JAX module):

* self-play with one net for both seats; the opponent sees
  ``state[k:] + state[:k]``, a LEFT rotation by ``opponent_roll`` (the
  reference rolls by 3, ranbowdqn.py:669, a bug; the default 5 is the
  correct half-swap);
* the action is the argmax of E[Z] under the *current* noise, with no
  epsilon (ranbowdqn.py:543-548); noise is resampled for both nets only on
  steps where the learner ran (ranbowdqn.py:606-607);
* C51 with the support-weighted mass quirk (``faithful_c51``); the CE on
  the action's distribution clamped to [0.01, 0.99] (ranbowdqn.py:595-600);
* Adam(1e-3), batch 32, a 10,000-slot ring sampled uniformly over the
  fill, learning once fill > batch (ranbowdqn.py:645-653, 322, 682);
* hard target sync every 20 *episodes* (ranbowdqn.py:690-691), by the
  episode counter divided as integers;
* ``won`` read from the pre-step obs;
* extensions: PER (``per``), n-step returns (``n_step``), the optional
  Phi(eps)-greedy wrap (``epsilon``) and L0 / frozen-MLP opponents.

Data-parallel training (``pmean_axis="data"``, ``parallel.spmd.
spmd_rainbow_chunk``): a step given the mesh's data group as ``axis``
gates the learner on the group minimum of the ring fills, averages the
gradients and the loss over the group before Adam, takes the group
maximum of PER's running max priority after its write-back, sums the
metric increments, so the episodic target sync is a global decision, and
keeps the noise replicated: every rank takes the group's first rank's
fresh draw (the JAX step draws it from ``noise_key``, a stream that every
device shares).  The learn is computed on every step and kept with
``torch.where``, so every rank reaches every collective whether its gate
is open or not.
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
from merging_gym_tpu_torch.nn.rainbow_net import (NUM_ATOMS, rainbow_apply,
                                                  rainbow_init,
                                                  rainbow_q_values,
                                                  rainbow_sample_noise,
                                                  support)
from merging_gym_tpu_torch.ops import per as per_ops
from merging_gym_tpu_torch.ops import replay as rp
from merging_gym_tpu_torch.ops.collectives import (broadcast, pmax, pmean,
                                                   pmin)
from merging_gym_tpu_torch.ops.fused_actor import fused_eps_greedy_actions
from merging_gym_tpu_torch.ops.nstep import (NStepState, nstep_init,
                                             nstep_update)
from merging_gym_tpu_torch.ops.projection import categorical_projection


@dataclass(frozen=True)
class RainbowConfig:
    """Hyper-parameters, with the fields and defaults of the JAX
    ``RainbowConfig``."""

    batch_size: int = 32
    lr: float = 1e-3
    gamma: float = 0.99
    memory_capacity: int = 10000
    target_sync_episodes: int = 20
    num_atoms: int = NUM_ATOMS
    obs_dim: int = C.OBS_DIM
    num_actions: int = C.NUM_ACTIONS
    opponent_roll: int = 5
    faithful_c51: bool = True
    per: bool = False
    per_alpha: float = 0.6
    per_beta: float = 0.4
    n_step: int = 1
    opponent: str = D.OPP_SELFPLAY
    # Phi(eps)-greedy on top of NoisyNet for the learning seat(s); None is
    # the reference's pure noisy-greedy actor.
    epsilon: float | None = None
    # Input normalisation (None = the reference's raw observations).
    obs_scale: float | None = None
    # Data-parallel training: "data" marks a config whose steps take the
    # mesh's data group as ``axis`` (``parallel.spmd.spmd_rainbow_chunk``).
    pmean_axis: str | None = None

    def replace(self, **changes) -> "RainbowConfig":
        return dataclasses.replace(self, **changes)


@dataclass
class RainbowCarry:
    env_state: core_env.EnvState
    obs: torch.Tensor            # f32[num_envs, 10]
    ep_reward: torch.Tensor      # f32[num_envs]
    params: dict
    target_params: dict
    opt_state: D.AdamState
    noise: dict
    target_noise: dict
    replay: Any                  # rp.ReplayState or per_ops.PERState
    nstep: NStepState
    sync_chunks: torch.Tensor    # i64 0-d: completed-episode // sync chunks
    last_loss: torch.Tensor      # f32 0-d
    generator: torch.Generator   # replay draws, noise, exploration, starts
    seed: int                    # run seed: the frozen opponent's K4 keys
    step: int
    metrics: D.Metrics
    opp_params: Any = None       # frozen-opponent MLP Q-net


def rainbow_train_init(seed: int, cfg: RainbowConfig, env_params: EnvParams,
                       num_envs: int, opp_params=None,
                       device=None) -> RainbowCarry:
    """Fresh envs, nets, noise, replay and counters for a run with
    ``seed``; the target starts equal to the online net (ranbowdqn.py:648)."""
    if (cfg.opponent == D.OPP_FROZEN) != (opp_params is not None):
        raise ValueError("opp_params must be given exactly when "
                         f"opponent='frozen' (got opponent={cfg.opponent!r})")
    dev = resolve_device(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    env_state = reset_batch(env_params, generator, num_envs, device=dev)
    params = rainbow_init(generator, cfg.obs_dim, cfg.num_actions,
                          cfg.num_atoms)
    example = D.transition_example(
        D.DQNConfig(obs_dim=cfg.obs_dim, num_actions=cfg.num_actions), dev)
    replay = (per_ops.per_init(cfg.memory_capacity, example, cfg.per_alpha)
              if cfg.per else rp.replay_init(cfg.memory_capacity, example))
    zeros = D._tree_map(torch.zeros_like, params)
    return RainbowCarry(
        env_state=env_state, obs=core_env.observe(env_state),
        ep_reward=torch.zeros(num_envs, dtype=torch.float32, device=dev),
        params=params, target_params=params,
        opt_state=D.AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                              zeros, D._tree_map(torch.zeros_like, params)),
        noise=rainbow_sample_noise(generator, cfg.num_actions, cfg.num_atoms),
        target_noise=rainbow_sample_noise(generator, cfg.num_actions,
                                          cfg.num_atoms),
        replay=replay, nstep=nstep_init(cfg.n_step, num_envs, cfg.obs_dim,
                                        dev),
        sync_chunks=torch.zeros((), dtype=torch.int64, device=dev),
        last_loss=torch.zeros((), dtype=torch.float32, device=dev),
        generator=generator, seed=seed, step=0, metrics=D.Metrics.zero(dev),
        opp_params=opp_params)


def _scaled(x, cfg: RainbowConfig):
    return x if cfg.obs_scale is None else x * cfg.obs_scale


def _act(params, noise, obs, cfg: RainbowConfig):
    dist = rainbow_apply(params, _scaled(obs, cfg), noise, cfg.num_actions,
                         cfg.num_atoms)
    return torch.argmax(rainbow_q_values(dist), dim=-1).to(torch.int32)


def _select_action(dist, action):
    return torch.gather(dist, -2, action.long()[:, None, None].expand(
        -1, 1, dist.shape[-1]))[:, 0, :]


def rainbow_loss(params, target_params, noise, target_noise, batch, weights,
                 cfg: RainbowConfig):
    """``(loss, ce)``: the weighted mean CE and the per-item unweighted CE
    (which feeds ``per_update_priorities``); differentiable in ``params``
    only.  Selection and evaluation of the next action both go through the
    target net (ranbowdqn.py:554-563)."""
    sup = support(device=batch["obs"].device)
    with torch.no_grad():
        next_dist = rainbow_apply(target_params,
                                  _scaled(batch["next_obs"], cfg),
                                  target_noise, cfg.num_actions, cfg.num_atoms)
        a_star = torch.argmax(rainbow_q_values(next_dist, sup), dim=-1)
        proj = categorical_projection(
            _select_action(next_dist, a_star), batch["reward"], batch["done"],
            sup, cfg.gamma ** cfg.n_step, cfg.faithful_c51)
    dist = rainbow_apply(params, _scaled(batch["obs"], cfg), noise,
                         cfg.num_actions, cfg.num_atoms)
    dist = torch.clamp(_select_action(dist, batch["action"]), 0.01, 0.99)
    ce = -torch.sum(proj * torch.log(dist), dim=-1)
    return torch.mean(ce * weights), ce


def _where_tree(gate, new, old):
    return D._tree_map(lambda a, b: torch.where(gate, a, b), new, old)


def _learn(carry: RainbowCarry, replay, cfg: RainbowConfig, axis=None):
    """One learn on a draw from ``replay``; returns ``(params, opt_state,
    replay, loss)`` (the replay with updated priorities under PER).  Given
    a process group ``axis``, the gradients and the loss are averaged over
    it before Adam and the running max priority is the group's maximum;
    the priorities written back are this rank's own."""
    if cfg.per:
        batch, idx, weights = per_ops.per_sample(
            replay, carry.generator, cfg.batch_size, cfg.per_beta)
    else:
        batch, idx = rp.sample_valid(replay, carry.generator, cfg.batch_size)
        weights = torch.ones(cfg.batch_size, dtype=torch.float32,
                             device=carry.obs.device)
    with torch.enable_grad():
        params = D._tree_map(lambda p: p.detach().requires_grad_(True),
                             carry.params)
        loss, ce = rainbow_loss(params, carry.target_params, carry.noise,
                                carry.target_noise, batch, weights, cfg)
        flat = torch.autograd.grad(loss, D._leaves(params))
    loss = loss.detach()
    if axis is not None:
        *flat, loss = pmean([*flat, loss], axis)
    it = iter(flat)
    grads = D._tree_map(lambda _: next(it), params)
    new_params, opt = D._adam(carry.params, grads, carry.opt_state, cfg.lr)
    if cfg.per:
        replay = per_ops.per_update_priorities(replay, idx,
                                               ce.detach() + 1e-5)
        if axis is not None:
            replay = dataclasses.replace(
                replay, max_priority=pmax(replay.max_priority, axis))
    return new_params, opt, replay, loss.to(torch.float32)


def _explore(a, generator, epsilon, num_actions):
    """Phi(eps)-greedy over the noisy-greedy action, one draw per env."""
    n = a.shape[0]
    keep = torch.randn(n, generator=generator, device=a.device) <= epsilon
    rand = torch.randint(0, num_actions, (n,), generator=generator,
                         dtype=torch.int32, device=a.device)
    return torch.where(keep, a, rand)


def rainbow_train_step(cfg: RainbowConfig, env_params: EnvParams,
                       carry: RainbowCarry, axis=None) -> RainbowCarry:
    """One lockstep actor + replay + learner step over all envs.
    ``axis``: the mesh's data group, given with ``cfg.pmean_axis``."""
    D.check_axis(cfg.pmean_axis, axis, "spmd_rainbow_chunk")
    obs, gen = carry.obs, carry.generator
    a1 = _act(carry.params, carry.noise, obs, cfg)
    if cfg.opponent == D.OPP_L0:
        a2 = torch.full_like(a1, C.ACTION_NONE)
    elif cfg.opponent == D.OPP_FROZEN:
        a2 = fused_eps_greedy_actions(
            carry.opp_params, swap_obs(obs),
            D.actor_seed(carry.seed, carry.step, 1), EPSILON)
    else:
        k = cfg.opponent_roll
        a2 = _act(carry.params, carry.noise,
                  torch.cat([obs[:, k:], obs[:, :k]], dim=-1), cfg)
    if cfg.epsilon is not None:
        a1 = _explore(a1, gen, cfg.epsilon, cfg.num_actions)
        if cfg.opponent == D.OPP_SELFPLAY:
            a2 = _explore(a2, gen, cfg.epsilon, cfg.num_actions)
    env_state, ts = autoreset_step(env_params, carry.env_state,
                                   torch.stack([a1, a2], dim=-1), gen)
    next_obs = observe_after_reset(env_params, env_state, ts)

    if cfg.n_step == 1:
        nstep = carry.nstep
        items = {"obs": obs.to(torch.float32), "action": a1,
                 "reward": ts.rewards[:, 0].to(torch.float32),
                 "next_obs": ts.obs.to(torch.float32), "done": ts.done}
        store_mask = None
    else:
        nstep, items, store_mask = nstep_update(
            carry.nstep, obs, a1, ts.rewards[:, 0], ts.done, ts.obs,
            cfg.gamma)
    if cfg.per:
        replay = per_ops.per_add_batch(carry.replay, items, store_mask)
        fill = replay.base.cursor
    else:
        replay = rp.add_batch(carry.replay, items, store_mask)
        fill = replay.cursor
    if axis is not None:
        # The n-step emit masks make the fills differ: the gate is global.
        fill = pmin(fill, axis)
    fill_ok = fill > cfg.batch_size

    # Learner, computed always and kept where the gate is open.
    params, opt, learned, loss = _learn(carry, replay, cfg, axis)
    params = _where_tree(fill_ok, params, carry.params)
    opt = D.AdamState(torch.where(fill_ok, opt.count, carry.opt_state.count),
                      _where_tree(fill_ok, opt.mu, carry.opt_state.mu),
                      _where_tree(fill_ok, opt.nu, carry.opt_state.nu))
    loss = torch.where(fill_ok, loss, carry.last_loss)
    if cfg.per:
        replay = dataclasses.replace(
            replay,
            priorities=torch.where(fill_ok, learned.priorities,
                                   replay.priorities),
            max_priority=torch.where(fill_ok, learned.max_priority,
                                     replay.max_priority))

    # Noise resampled only when the learner ran (ranbowdqn.py:606-607).
    fresh = rainbow_sample_noise(gen, cfg.num_actions, cfg.num_atoms)
    fresh_t = rainbow_sample_noise(gen, cfg.num_actions, cfg.num_atoms)
    if axis is not None:   # replicated noise: the first rank's draw
        it = iter(broadcast(D._leaves(fresh) + D._leaves(fresh_t), axis))
        fresh = D._tree_map(lambda _: next(it), fresh)
        fresh_t = D._tree_map(lambda _: next(it), fresh_t)
    noise = _where_tree(fill_ok, fresh, carry.noise)
    target_noise = _where_tree(fill_ok, fresh_t, carry.target_noise)

    # Metrics; the win is tested on the pre-step obs (main.py:225).  Under
    # a group the increments are summed, so the counters are global.
    done = ts.done
    ep_reward = carry.ep_reward + ts.rewards[:, 0]
    won = done & (obs[:, 8] > obs[:, 3])
    metrics = D.add_metrics(carry.metrics, done, ts.collision, won,
                            ep_reward, axis)

    # Hard target sync every target_sync_episodes episodes, post-update.
    chunks = metrics.episodes // cfg.target_sync_episodes
    sync = chunks > carry.sync_chunks
    return RainbowCarry(
        env_state=env_state, obs=next_obs,
        ep_reward=torch.where(done, 0.0, ep_reward), params=params,
        target_params=_where_tree(sync, params, carry.target_params),
        opt_state=opt, noise=noise, target_noise=target_noise, replay=replay,
        nstep=nstep, sync_chunks=chunks, last_loss=loss, generator=gen,
        seed=carry.seed, step=carry.step + 1, metrics=metrics,
        opp_params=carry.opp_params)


def rainbow_train_chunk(cfg: RainbowConfig, env_params: EnvParams,
                        carry: RainbowCarry, num_steps: int,
                        axis=None) -> RainbowCarry:
    for _ in range(num_steps):
        carry = rainbow_train_step(cfg, env_params, carry, axis)
    return carry
