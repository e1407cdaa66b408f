"""Double-DQN with level-k opponents: the step-loop trainer.

Counterpart of ``merging_gym_tpu/agents/dqn.py`` (the reference trainer
of scripts/main.py:76-245): thousands of vectorised envs, the on-device
ring replay and the learner advance in lockstep, one Python-loop step at
a time (the JAX ``lax.scan``).  Every step draws its actions from K4
(``ops.fused_actor``), once per learning seat; the learner is plain
PyTorch with autograd (``nn.mlp.qnet_apply_autograd``, ``torch.matmul``)
and a hand-written Adam with optax's formula, as the JAX learner
differentiates its plain ``qnet_apply`` and uses ``optax.adam``.

Nothing is read back from the card inside a chunk: the learn gate is a
device tensor (a gated-off learn is computed and discarded), replay
draws come from the carry's ``torch.Generator``, and the actor's seeds
come from the run seed and the step count on the host.  The actor's
Philox stream differs from the JAX actor's threefry stream; the two draw
from the same distribution.

Reference semantics preserved (the quirks of ``agents/dqn.py:9-23``):
* eval and target nets are *independently* initialised; the first learn
  syncs them (main.py:80,125-126), and every sync comes *before* the
  update;
* Double-DQN target with no terminal mask by default (``mask_terminal``);
* MSE loss, Adam(lr=0.01), target sync every 100 learns, batch 128 from a
  2000-slot ring sampled with replacement (main.py:13-18,96-97,130), with
  ``learns_per_step`` learns per env step and the ``sample_valid``
  corrected mode;
* epsilon-greedy via the Phi(0.7) normal-draw quirk (main.py:105);
* transitions are stored, and episode reward accumulated, only while the
  ego has not won (main.py:209-211); the win is tested on the pre-step
  obs (main.py:225);
* opponents: "L0" (no action), "selfplay" (live params), "frozen" params
  (main.py:161-168), acting on the half-swapped obs (main.py:199).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from merging_gym_tpu_torch.agents.policies import EPSILON
from merging_gym_tpu_torch.core import constants as C
from merging_gym_tpu_torch.core import env as core_env
from merging_gym_tpu_torch.core.env import EnvParams, swap_obs
from merging_gym_tpu_torch.core.vector import (autoreset_step,
                                               observe_after_reset,
                                               reset_batch)
from merging_gym_tpu_torch.device import resolve_device
from merging_gym_tpu_torch.nn.mlp import qnet_apply_autograd, qnet_init
from merging_gym_tpu_torch.ops import replay as rp
from merging_gym_tpu_torch.ops.collectives import pmean, psum
from merging_gym_tpu_torch.ops.fused_actor import fused_eps_greedy_actions
from merging_gym_tpu_torch.ops.fused_trainer import (ADAM_B1, ADAM_B2,
                                                     ADAM_EPS, OPP_FROZEN,
                                                     OPP_L0, OPP_SELFPLAY)


@dataclass(frozen=True)
class DQNConfig:
    """Hyper-parameters (main.py:13-18); the fields and defaults of the
    JAX ``DQNConfig``."""

    batch_size: int = 128
    lr: float = 0.01
    gamma: float = 0.90
    epsilon: float = EPSILON
    memory_capacity: int = 2000
    target_sync: int = 100
    obs_dim: int = C.OBS_DIM
    num_actions: int = C.NUM_ACTIONS
    hidden: tuple = (200, 100)
    mask_terminal: bool = False
    opponent: str = OPP_L0
    learns_per_step: int = 1
    # Corrected mode of the replay quirk pair (main.py:130,213-214):
    # sample over filled slots only and learn from one stored batch on.
    sample_valid: bool = False
    # Forward passes (actor and learner) in this dtype; master params,
    # gradients, Adam moments and the TD math stay f32.
    compute_dtype: str = "float32"

    def replace(self, **changes) -> "DQNConfig":
        return dataclasses.replace(self, **changes)


def _tree_map(fn, *trees):
    return {layer: {k: fn(*(t[layer][k] for t in trees))
                    for k in trees[0][layer]}
            for layer in trees[0]}


def _leaves(tree):
    return [tree[layer][k] for layer in tree for k in tree[layer]]


@dataclass
class AdamState:
    """optax ``ScaleByAdamState``: the update count and both moments."""

    count: torch.Tensor  # i32 0-d
    mu: dict
    nu: dict


@dataclass
class DQNState:
    """Learner state: the reference ``DQN`` object."""

    params: dict
    target_params: dict
    opt_state: AdamState
    learn_counter: torch.Tensor  # i32 0-d
    last_loss: torch.Tensor      # f32 0-d


def dqn_init(generator: torch.Generator, cfg: DQNConfig = DQNConfig(),
             device=None) -> DQNState:
    """Eval and target nets drawn one after the other from ``generator``
    (independent, main.py:80), zero Adam moments."""
    params = qnet_init(generator, cfg.obs_dim, cfg.num_actions, cfg.hidden,
                       device=device)
    target = qnet_init(generator, cfg.obs_dim, cfg.num_actions, cfg.hidden,
                       device=device)
    dev = params["fc0"]["w"].device
    zeros = _tree_map(torch.zeros_like, params)
    return DQNState(
        params=params, target_params=target,
        opt_state=AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                            zeros, _tree_map(torch.zeros_like, params)),
        learn_counter=torch.zeros((), dtype=torch.int32, device=dev),
        last_loss=torch.zeros((), dtype=torch.float32, device=dev))


def _qnet_fwd(params, x, cfg: DQNConfig):
    """Differentiable forward in the compute dtype, Q-values in f32."""
    return qnet_apply_autograd(params, x, cfg.compute_dtype)


def td_loss(params, target_params, batch, cfg: DQNConfig):
    """Double-DQN MSE loss (main.py:143-153); differentiable in
    ``params`` only."""
    q_eval = _qnet_fwd(params, batch["obs"], cfg)
    q_sel = q_eval.gather(-1, batch["action"].long()[:, None])[:, 0]
    with torch.no_grad():
        q_next_t = _qnet_fwd(target_params, batch["next_obs"], cfg)
        q_next_e = _qnet_fwd(params, batch["next_obs"], cfg)
        a_star = torch.argmax(q_next_e, dim=-1, keepdim=True)
        bootstrap = q_next_t.gather(-1, a_star)[:, 0]
        if cfg.mask_terminal:
            bootstrap = bootstrap * (1.0 - batch["done"].to(bootstrap.dtype))
        target = batch["reward"] + cfg.gamma * bootstrap
    return torch.mean((q_sel - target) ** 2)


def _adam(params, grads, opt: AdamState, lr: float):
    """optax.adam(lr) (torch defaults, eps_root 0): bias-corrected moments
    ``mu / (1 - b1**t)``, ``nu / (1 - b2**t)``, then
    ``p -= lr * mu_hat / (sqrt(nu_hat) + eps)``."""
    count = opt.count + 1
    t = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(t, ADAM_B1), t)
    bc2 = 1.0 - torch.pow(torch.full_like(t, ADAM_B2), t)
    mu = _tree_map(lambda g, m: (1.0 - ADAM_B1) * g + ADAM_B1 * m, grads,
                   opt.mu)
    nu = _tree_map(lambda g, v: (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * v,
                   grads, opt.nu)
    new = _tree_map(
        lambda p, m, v: p - lr * (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS),
        params, mu, nu)
    return new, AdamState(count, mu, nu)


def learn(state: DQNState, batch, cfg: DQNConfig, axis=None,
          loss_fn=td_loss) -> DQNState:
    """One SGD step, with the every-``target_sync``-learns target sync
    applied *before* the update, exactly as the reference (main.py:125-127).

    ``axis``: a process group (the mesh's ``data`` group); given one, the
    gradients and the loss are averaged over it before Adam, so that
    replicated params stay bitwise equal (the JAX ``axis``).  ``loss_fn``
    has :func:`td_loss`'s signature (``parallel.spmd`` passes its
    tensor-parallel loss)."""
    sync = state.learn_counter % cfg.target_sync == 0
    target = _tree_map(lambda e, t: torch.where(sync, e, t), state.params,
                       state.target_params)
    with torch.enable_grad():
        params = _tree_map(lambda p: p.detach().requires_grad_(True),
                           state.params)
        loss = loss_fn(params, target, batch, cfg)
        flat = torch.autograd.grad(loss, _leaves(params))
    if axis is not None:
        *flat, loss = pmean([*flat, loss.detach()], axis)
    it = iter(flat)
    grads = _tree_map(lambda _: next(it), params)
    new_params, opt = _adam(state.params, grads, state.opt_state, cfg.lr)
    return DQNState(params=new_params, target_params=target, opt_state=opt,
                    learn_counter=state.learn_counter + 1,
                    last_loss=loss.detach().to(torch.float32))


def check_axis(pmean_axis, axis, chunk: str) -> None:
    """A config's ``pmean_axis`` is set if and only if a process group is
    given as ``axis`` (``parallel.spmd``'s ``chunk`` passes the mesh's
    data group)."""
    if (pmean_axis is None) != (axis is None):
        raise ValueError(f"pmean_axis={pmean_axis!r} needs the data group "
                         f"that parallel.spmd.{chunk} passes as axis, and "
                         "axis needs pmean_axis='data'")


def _where_state(gate, new: DQNState, old: DQNState) -> DQNState:
    """``new`` where the 0-d bool ``gate`` holds, else ``old`` (no host
    read-back)."""
    def pick(a, b):
        return torch.where(gate, a, b)
    return DQNState(
        params=_tree_map(pick, new.params, old.params),
        target_params=_tree_map(pick, new.target_params, old.target_params),
        opt_state=AdamState(pick(new.opt_state.count, old.opt_state.count),
                            _tree_map(pick, new.opt_state.mu,
                                      old.opt_state.mu),
                            _tree_map(pick, new.opt_state.nu,
                                      old.opt_state.nu)),
        learn_counter=pick(new.learn_counter, old.learn_counter),
        last_loss=pick(new.last_loss, old.last_loss))


# ---------------------------------------------------------------------------
# Actor-learner training loop
# ---------------------------------------------------------------------------

@dataclass
class Metrics:
    """Running counters of the reference's episode metrics (main.py:
    186-237): collision rate, win rate (state[8] > state[3], main.py:225),
    episode reward gated on not-yet-won (main.py:209-211)."""

    env_steps: torch.Tensor
    episodes: torch.Tensor
    collisions: torch.Tensor
    wins: torch.Tensor
    sum_ep_reward: torch.Tensor

    @classmethod
    def zero(cls, device):
        def z():
            return torch.zeros((), dtype=torch.int64, device=device)
        return cls(env_steps=z(), episodes=z(), collisions=z(), wins=z(),
                   sum_ep_reward=torch.zeros((), dtype=torch.float32,
                                             device=device))


def add_metrics(m: Metrics, done, collision, won, ep_reward,
                axis=None) -> Metrics:
    """``m`` plus one step's increments; given a process group ``axis``,
    the increments are summed over it first, so every rank holds the
    global counters (the JAX ``psum`` of the increments)."""
    counts = torch.stack([torch.full_like(m.env_steps, done.shape[0]),
                          done.sum(), collision.sum(), won.sum()])
    reward = torch.where(done, ep_reward, 0.0).sum()
    if axis is not None:
        counts, reward = psum(counts, axis), psum(reward, axis)
    return Metrics(env_steps=m.env_steps + counts[0],
                   episodes=m.episodes + counts[1],
                   collisions=m.collisions + counts[2],
                   wins=m.wins + counts[3],
                   sum_ep_reward=m.sum_ep_reward + reward)


@dataclass
class TrainCarry:
    env_state: core_env.EnvState
    obs: torch.Tensor              # f32[num_envs, 10]
    ep_reward: torch.Tensor        # f32[num_envs] masked per-episode return
    dqn: DQNState
    opp_params: Any                # frozen opponent params (or dqn.params)
    replay: rp.ReplayState
    generator: torch.Generator     # replay draws and random starts
    seed: int                      # run seed: the actor's Philox keys
    step: int                      # steps taken
    metrics: Metrics


def transition_example(cfg: DQNConfig, device):
    return {
        "obs": torch.zeros(cfg.obs_dim, dtype=torch.float32, device=device),
        "action": torch.zeros((), dtype=torch.int32, device=device),
        "reward": torch.zeros((), dtype=torch.float32, device=device),
        "next_obs": torch.zeros(cfg.obs_dim, dtype=torch.float32,
                                device=device),
        "done": torch.zeros((), dtype=torch.bool, device=device),
    }


def train_init(seed: int, cfg: DQNConfig, env_params: EnvParams,
               num_envs: int, opp_params=None, device=None) -> TrainCarry:
    """Fresh envs, nets, replay and counters for a run with ``seed``
    (frozen opponents: ``opp_params`` on the same device)."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    env_state = reset_batch(env_params, generator, num_envs, device=dev)
    dqn = dqn_init(generator, cfg, dev)
    if cfg.opponent == OPP_FROZEN:
        if opp_params is None:
            raise ValueError("a frozen opponent needs opp_params")
    else:
        opp_params = dqn.params  # placeholder with the right structure
    return TrainCarry(
        env_state=env_state, obs=core_env.observe(env_state),
        ep_reward=torch.zeros(num_envs, dtype=torch.float32, device=dev),
        dqn=dqn, opp_params=opp_params,
        replay=rp.replay_init(cfg.memory_capacity,
                              transition_example(cfg, dev)),
        generator=generator, seed=seed, step=0, metrics=Metrics.zero(dev))


def actor_seed(run_seed: int, step: int, seat: int) -> int:
    """Philox key of seat ``seat``'s actor at ``step``: the run seed in the
    high word, ``2 * step + seat`` in the low one."""
    return ((run_seed & 0xFFFFFFFF) << 32) | ((2 * step + seat) & 0xFFFFFFFF)


def _choose_actions(carry: TrainCarry, cfg: DQNConfig) -> torch.Tensor:
    """Both seats' actions ``i32[N, 2]``, each seat one K4 launch."""
    obs = carry.obs
    a1 = fused_eps_greedy_actions(carry.dqn.params, obs,
                                  actor_seed(carry.seed, carry.step, 0),
                                  cfg.epsilon, cfg.compute_dtype)
    if cfg.opponent == OPP_L0:
        a2 = torch.full_like(a1, C.ACTION_NONE)
    else:
        opp = (carry.dqn.params if cfg.opponent == OPP_SELFPLAY
               else carry.opp_params)
        a2 = fused_eps_greedy_actions(opp, swap_obs(obs),
                                      actor_seed(carry.seed, carry.step, 1),
                                      cfg.epsilon, cfg.compute_dtype)
    return torch.stack([a1, a2], dim=-1)


def train_step(cfg: DQNConfig, env_params: EnvParams,
               carry: TrainCarry) -> TrainCarry:
    """One lockstep actor + replay + learner step over all envs."""
    actions = _choose_actions(carry, cfg)
    env_state, ts = autoreset_step(env_params, carry.env_state, actions,
                                   carry.generator)
    next_obs = observe_after_reset(env_params, env_state, ts)

    # Store-gating: drop transitions once the ego has won (main.py:209-210).
    store_mask = ts.winner != 1
    items = {
        "obs": carry.obs.to(torch.float32),
        "action": actions[:, 0],
        "reward": ts.rewards[:, 0].to(torch.float32),
        "next_obs": ts.obs.to(torch.float32),
        "done": ts.done,
    }
    replay = rp.add_batch(carry.replay, items, store_mask)

    # Learner: fires only once the ring has filled (main.py:213-214).
    gate = (rp.can_learn_valid(replay, cfg.batch_size) if cfg.sample_valid
            else rp.can_learn(replay))
    draw = rp.sample_valid if cfg.sample_valid else rp.sample
    dqn = carry.dqn
    for _ in range(cfg.learns_per_step):
        batch, _ = draw(replay, carry.generator, cfg.batch_size)
        dqn = _where_state(gate, learn(dqn, batch, cfg), dqn)

    # Metrics at episode boundaries; the win test uses the obs from
    # *before* the final step (main.py:225).
    done = ts.done
    ep_reward = carry.ep_reward + torch.where(store_mask, ts.rewards[:, 0],
                                              0.0)
    won = done & (carry.obs[:, 8] > carry.obs[:, 3])
    metrics = add_metrics(carry.metrics, done, ts.collision, won, ep_reward)
    return TrainCarry(env_state=env_state, obs=next_obs,
                      ep_reward=torch.where(done, 0.0, ep_reward), dqn=dqn,
                      opp_params=carry.opp_params, replay=replay,
                      generator=carry.generator, seed=carry.seed,
                      step=carry.step + 1, metrics=metrics)


def train_chunk(cfg: DQNConfig, env_params: EnvParams, carry: TrainCarry,
                num_steps: int) -> TrainCarry:
    """``num_steps`` actor + learner steps."""
    for _ in range(num_steps):
        carry = train_step(cfg, env_params, carry)
    return carry
