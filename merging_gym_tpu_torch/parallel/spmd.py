"""SPMD training over torch.distributed: the four trainer families.

Counterpart of ``merging_gym_tpu/parallel/spmd.py``: the data- and
tensor-parallel DQN step loop (``spmd_train_*``), the data-parallel
h-DQN, Rainbow and DRQN step loops (``spmd_hdqn_*``, ``spmd_rainbow_*``,
``spmd_drqn_*``) and the fused trainers K5, K7, K8 and K9 on every rank
under local SGD (``spmd_fused_dqn_*``, ``spmd_fused_hdqn_*``,
``spmd_fused_rainbow_*``, ``spmd_fused_drqn_*``).

One process per rank runs the same program on its own part of the work
and holds a rank-local carry: its env lanes, its replay rings and its
counters, beside replicas of the parameters and Adam moments.  The JAX
package's global arrays and its ``[dp]`` per-device ring cursors become
plain local ones.  On a ``(data, model)`` mesh (``parallel.mesh``):

* **data parallelism**: every rank steps its own envs, stores into its
  own ring and samples its own batch; the gradients and the loss are
  averaged over the ``data`` group before an identical Adam update
  (``agents.dqn.learn``'s ``axis``; the Rainbow and DRQN steps take the
  same ``axis``), the learn gate is the data-group minimum of the ring
  fills, PER's running max priority is the data-group maximum, and the
  metric increments are summed over ``data`` every step, so every rank
  holds the global counters (and Rainbow's episodic target sync is a
  global decision);
* **tensor parallelism** (the DQN step loop): fc0 column-parallel, fc1
  row-parallel with one sum over ``model`` on its partial products, fc2
  replicated.  The sum's backward passes the cotangent through
  unchanged (Megatron's "g"), so every shard receives the single-device
  gradient.  The JAX package's ``psum("model")`` under ``check_vma=False``
  transposes to another ``psum`` and hands the shards upstream of it
  ``tp`` times their gradient; the port does not copy that (ROADMAP.md,
  Queue 3);
* **local SGD** (the fused trainers): each rank runs the whole chunk on
  its lanes (K5, K7, K8 or K9 on the card, their plain versions on the
  CPU), then the ranks average the parameters, target parameters and
  both Adam moments, sum the metrics and average the loss; under PER,
  K8's running max priority (env row 13) is the ranks' maximum.

Streams.  Data rank ``d`` runs under ``data_seed(seed, d) = seed + d *
0x9E3779B9``: the step loops' generator (env resets, replay draws) and
their actors' Philox keys, and the fused chunks' Philox key and host
``rounds``/``cols`` generator (``seed ^ 0x5EED`` for K5, ``seed ^ 0x4D0``
and ``seed ^ 0xC01`` for K7, ``seed ^ 0x51C``, ``seed ^ 0xC01`` and
``seed ^ 0xBE7`` for K8's ``rounds``, ``cols`` and ``us``, ``seed ^
0xD7D7`` for K9, of the rank's seed).  Rank 0 keeps the
run's seed, so a world of one reproduces the single-device trainers bit
for bit; the increment is odd, so the low 32 bits, which the step loops'
actors key on, differ between any two data ranks.  The model ranks of one
data row share their seed, envs, samples and exploration draws.  The
nets are drawn from the run's seed on every rank, so replicas start
equal.

Rainbow's noise.  The step loop keeps it replicated, as the JAX step
does by drawing it from ``noise_key``, a stream that every device shares:
every rank starts from the noise of the run's seed and takes data rank
0's fresh draw (``agents.rainbow``).  K8 keeps it rank-local, as JAX
lane-shards it, never averaged (an average of factorised noise would
shrink it toward zero): rank ``d`` starts from the noise that a
single-chip ``fused_rainbow_init`` under ``data_seed(seed, d)`` draws,
beside the shared net, and redraws it under its own Philox key.  Rank 0's
noise is the single-device run's in both.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from merging_gym_tpu_torch.agents import dqn as D
from merging_gym_tpu_torch.agents import drqn as DR
from merging_gym_tpu_torch.agents import hdqn as H
from merging_gym_tpu_torch.agents import rainbow as RB
from merging_gym_tpu_torch.core import constants as C
from merging_gym_tpu_torch.core.env import EnvParams, swap_obs
from merging_gym_tpu_torch.core.vector import (autoreset_step,
                                               observe_after_reset)
from merging_gym_tpu_torch.ops import fused_drqn as FD
from merging_gym_tpu_torch.ops import fused_hdqn as FH
from merging_gym_tpu_torch.ops import fused_rainbow as FRB
from merging_gym_tpu_torch.ops import fused_trainer as FT
from merging_gym_tpu_torch.ops import replay as rp
from merging_gym_tpu_torch.ops.fused_actor import eps_greedy_pick
from merging_gym_tpu_torch.parallel.mesh import (axis_index, axis_size,
                                                 data_sharding, pmax, pmean,
                                                 pmin, psum)

SEED_STRIDE = 0x9E3779B9


def data_seed(seed: int, data_rank: int) -> int:
    """The seed that data rank ``data_rank`` runs under (see above)."""
    return seed + data_rank * SEED_STRIDE


class _Axes(NamedTuple):
    data: object   # process group of the data dimension
    model: object  # process group of the model dimension
    dp: int
    tp: int
    d: int         # this rank's data coordinate
    m: int         # and its model coordinate


def _axes(mesh) -> _Axes:
    return _Axes(mesh.get_group("data"), mesh.get_group("model"),
                 axis_size(mesh, "data"), axis_size(mesh, "model"),
                 axis_index(mesh, "data"), axis_index(mesh, "model"))


def _local_rows(obj, names, part, second_axis=False):
    """``obj`` (a dataclass) with its per-env fields ``names`` cut to this
    rank's rows; a dataclass or dict field is cut entry by entry.  With
    ``second_axis`` the envs of an array of more than one dimension lie on
    its second axis (the n-step history, the JAX ``P(None, "data")``)."""
    def cut(x):
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{
                f.name: cut(getattr(x, f.name))
                for f in dataclasses.fields(x)})
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if second_axis and x.ndim > 1:
            return x[:, part.rows(x.shape[1])].clone()
        return part.place(x).clone()
    return dataclasses.replace(obj, **{k: cut(getattr(obj, k))
                                       for k in names})


def _reseed(carry, seed: int, d: int):
    """Data rank ``d``'s streams (rank 0 keeps the run's): its generator,
    and its run seed where the carry keys an actor on one."""
    if d == 0:
        return carry
    carry.generator.manual_seed(data_seed(seed, d))
    if hasattr(carry, "seed"):
        carry = dataclasses.replace(carry, seed=data_seed(seed, d))
    return carry


def _data_ranks(mesh, num_envs: int, cfg, name: str) -> _Axes:
    """The mesh's axes, once ``num_envs`` divides over its data ranks and
    ``cfg`` (a ``name``) sets ``pmean_axis='data'``."""
    ax = _axes(mesh)
    if num_envs % ax.dp:
        raise ValueError(f"num_envs {num_envs} must divide over {ax.dp} "
                         "data ranks")
    if cfg.pmean_axis != "data":
        raise ValueError(f"set {name}(pmean_axis='data')")
    return ax


# ---------------------------------------------------------------------------
# Tensor-parallel Q-net
# ---------------------------------------------------------------------------

class _ModelSum(torch.autograd.Function):
    """Sum of partial products over the model group; the backward passes
    the cotangent through unchanged (each shard's own share)."""

    @staticmethod
    def forward(ctx, x, group):
        return psum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def qnet_shard(params: dict, model_rank: int, tp: int) -> dict:
    """Model rank ``model_rank``'s shard of a 3-layer Q-net: fc0's output
    columns and fc1's input rows ``[rank * h1 / tp, (rank + 1) * h1 /
    tp)``, fc1's bias and fc2 whole (the JAX ``qnet_pspecs``)."""
    h1 = params["fc0"]["w"].shape[1]
    if h1 % tp:
        raise ValueError(f"hidden width {h1} does not divide over {tp} "
                         "model ranks")
    k = h1 // tp
    c = slice(model_rank * k, (model_rank + 1) * k)
    return {"fc0": {"w": params["fc0"]["w"][:, c].contiguous(),
                    "b": params["fc0"]["b"][c].clone()},
            "fc1": {"w": params["fc1"]["w"][c].clone(),
                    "b": params["fc1"]["b"].clone()},
            "fc2": {k2: v.clone() for k2, v in params["fc2"].items()}}


def qnet_unshard(shards) -> dict:
    """The whole Q-net from the shards of model ranks ``0 .. tp - 1``."""
    return {"fc0": {"w": torch.cat([s["fc0"]["w"] for s in shards], 1),
                    "b": torch.cat([s["fc0"]["b"] for s in shards])},
            "fc1": {"w": torch.cat([s["fc1"]["w"] for s in shards]),
                    "b": shards[0]["fc1"]["b"]},
            "fc2": dict(shards[0]["fc2"])}


def qnet_apply_tp(params: dict, x: torch.Tensor, group) -> torch.Tensor:
    """Q-net forward on this rank's shard: fc1's contraction runs on the
    local rows and one sum over the model ``group`` completes it."""
    h = torch.relu(torch.matmul(x, params["fc0"]["w"]) + params["fc0"]["b"])
    h = _ModelSum.apply(torch.matmul(h, params["fc1"]["w"]), group)
    h = torch.relu(h + params["fc1"]["b"])
    return torch.matmul(h, params["fc2"]["w"]) + params["fc2"]["b"]


def _td_loss_tp(params, target_params, batch, cfg: D.DQNConfig, group):
    """``agents.dqn.td_loss`` on shards: the local batch's mean (the
    learner averages it over ``data``, giving the global-batch mean)."""
    q_eval = qnet_apply_tp(params, batch["obs"], group)
    q_sel = q_eval.gather(-1, batch["action"].long()[:, None])[:, 0]
    with torch.no_grad():
        q_next_t = qnet_apply_tp(target_params, batch["next_obs"], group)
        q_next_e = qnet_apply_tp(params, batch["next_obs"], group)
        a_star = torch.argmax(q_next_e, dim=-1, keepdim=True)
        bootstrap = q_next_t.gather(-1, a_star)[:, 0]
        if cfg.mask_terminal:
            bootstrap = bootstrap * (1.0 - batch["done"].to(bootstrap.dtype))
        target = batch["reward"] + cfg.gamma * bootstrap
    return torch.mean((q_sel - target) ** 2)


def _actions_tp(params, obs, seed: int, cfg: D.DQNConfig, group):
    """K4's pick (its draws and Phi-select) on the tensor-parallel
    Q-values."""
    with torch.no_grad():
        q = qnet_apply_tp(params, obs.to(torch.float32), group)
    return eps_greedy_pick(q, seed, cfg.epsilon)


# ---------------------------------------------------------------------------
# Data- and tensor-parallel DQN step loop
# ---------------------------------------------------------------------------

def _choose_actions(carry: D.TrainCarry, cfg: D.DQNConfig, ax: _Axes):
    if ax.tp == 1:
        return D._choose_actions(carry, cfg)
    obs = carry.obs
    a1 = _actions_tp(carry.dqn.params, obs,
                     D.actor_seed(carry.seed, carry.step, 0), cfg, ax.model)
    if cfg.opponent == D.OPP_L0:
        a2 = torch.full_like(a1, C.ACTION_NONE)
    else:
        opp = (carry.dqn.params if cfg.opponent == D.OPP_SELFPLAY
               else carry.opp_params)
        a2 = _actions_tp(opp, swap_obs(obs),
                         D.actor_seed(carry.seed, carry.step, 1), cfg,
                         ax.model)
    return torch.stack([a1, a2], dim=-1)


def _device_train_step(cfg: D.DQNConfig, env_params: EnvParams,
                       carry: D.TrainCarry, ax: _Axes) -> D.TrainCarry:
    """``agents.dqn.train_step`` on this rank's part, with the data-group
    learn gate, averaged learns and summed metric increments."""
    actions = _choose_actions(carry, cfg, ax)
    env_state, ts = autoreset_step(env_params, carry.env_state, actions,
                                   carry.generator)
    next_obs = observe_after_reset(env_params, env_state, ts)

    store_mask = ts.winner != 1
    items = {
        "obs": carry.obs.to(torch.float32),
        "action": actions[:, 0],
        "reward": ts.rewards[:, 0].to(torch.float32),
        "next_obs": ts.obs.to(torch.float32),
        "done": ts.done,
    }
    replay = rp.add_batch(carry.replay, items, store_mask)

    # Every rank takes the same gate: masked stores make the cursors
    # differ, so the gate reads the smallest fill.
    fill = pmin(replay.cursor, ax.data)
    gate = fill >= (cfg.batch_size if cfg.sample_valid
                    else rp.replay_capacity(replay))
    draw = rp.sample_valid if cfg.sample_valid else rp.sample
    loss_fn = (D.td_loss if ax.tp == 1
               else partial(_td_loss_tp, group=ax.model))
    dqn = carry.dqn
    for _ in range(cfg.learns_per_step):
        batch, _ = draw(replay, carry.generator, cfg.batch_size)
        dqn = D._where_state(gate, D.learn(dqn, batch, cfg, axis=ax.data,
                                           loss_fn=loss_fn), dqn)

    done = ts.done
    ep_reward = carry.ep_reward + torch.where(store_mask, ts.rewards[:, 0],
                                              0.0)
    won = done & (carry.obs[:, 8] > carry.obs[:, 3])
    metrics = D.add_metrics(carry.metrics, done, ts.collision, won,
                            ep_reward, ax.data)
    return D.TrainCarry(env_state=env_state, obs=next_obs,
                        ep_reward=torch.where(done, 0.0, ep_reward), dqn=dqn,
                        opp_params=carry.opp_params, replay=replay,
                        generator=carry.generator, seed=carry.seed,
                        step=carry.step + 1, metrics=metrics)


def _shard_state(dqn: D.DQNState, m: int, tp: int) -> D.DQNState:
    mu, nu = dqn.opt_state.mu, dqn.opt_state.nu
    return dataclasses.replace(
        dqn, params=qnet_shard(dqn.params, m, tp),
        target_params=qnet_shard(dqn.target_params, m, tp),
        opt_state=D.AdamState(dqn.opt_state.count, qnet_shard(mu, m, tp),
                              qnet_shard(nu, m, tp)))


def spmd_train_init(seed: int, cfg: D.DQNConfig, env_params: EnvParams,
                    num_envs: int, mesh, opp_params=None,
                    device=None) -> D.TrainCarry:
    """This rank's carry: its ``num_envs / data`` envs, a ring of
    ``cfg.memory_capacity`` (per rank), and its model shard of the nets
    (and of a frozen opponent's); ``num_envs`` is global."""
    ax = _axes(mesh)
    if num_envs % ax.dp:
        raise ValueError(f"num_envs {num_envs} must divide over {ax.dp} "
                         "data ranks")
    if ax.tp > 1 and cfg.compute_dtype != "float32":
        raise ValueError("the tensor-parallel Q-net runs in float32 only")
    carry = D.train_init(seed, cfg, env_params, num_envs, opp_params, device)
    carry = _local_rows(carry, ("env_state", "obs", "ep_reward"),
                        data_sharding(mesh))
    if ax.tp > 1:
        dqn = _shard_state(carry.dqn, ax.m, ax.tp)
        opp = (qnet_shard(carry.opp_params, ax.m, ax.tp)
               if cfg.opponent == D.OPP_FROZEN else dqn.params)
        carry = dataclasses.replace(carry, dqn=dqn, opp_params=opp)
    return _reseed(carry, seed, ax.d)


def spmd_train_chunk(mesh, cfg: D.DQNConfig, env_params: EnvParams,
                     carry: D.TrainCarry, num_steps: int) -> D.TrainCarry:
    """``num_steps`` SPMD actor + learner steps on every rank."""
    ax = _axes(mesh)
    for _ in range(num_steps):
        carry = _device_train_step(cfg, env_params, carry, ax)
    return carry


# ---------------------------------------------------------------------------
# Data-parallel h-DQN step loop
# ---------------------------------------------------------------------------

_HDQN_ROWS = ("env_state", "obs", "goal", "goal_op", "option_start_obs",
              "option_start", "extr_return", "ep_reward")


def spmd_hdqn_init(seed: int, cfg: H.HDQNConfig, env_params: EnvParams,
                   num_envs: int, mesh, opp_upper=None, opp_lower=None,
                   device=None) -> H.HDQNCarry:
    """This rank's h-DQN carry; both memory capacities are per rank and
    ``num_envs`` is global."""
    ax = _data_ranks(mesh, num_envs, cfg, "HDQNConfig")
    carry = H.hdqn_init(seed, cfg, env_params, num_envs, opp_upper,
                        opp_lower, device)
    carry = _local_rows(carry, _HDQN_ROWS, data_sharding(mesh))
    return _reseed(carry, seed, ax.d)


def spmd_hdqn_chunk(mesh, cfg: H.HDQNConfig, env_params: EnvParams,
                    carry: H.HDQNCarry, num_steps: int) -> H.HDQNCarry:
    """Hierarchical DQN data-parallel over the mesh's ``data`` group."""
    return H.hdqn_train_chunk(cfg, env_params, carry, num_steps,
                              axis=mesh.get_group("data"))


# ---------------------------------------------------------------------------
# Data-parallel Rainbow and DRQN step loops
# ---------------------------------------------------------------------------

def spmd_rainbow_init(seed: int, cfg: RB.RainbowConfig,
                      env_params: EnvParams, num_envs: int, mesh,
                      device=None) -> RB.RainbowCarry:
    """This rank's Rainbow carry: its ``num_envs / data`` envs and their
    n-step history, and a ring (with its PER state under ``cfg.per``) of
    ``cfg.memory_capacity`` per rank; ``num_envs`` is global.  Every rank
    starts from the run's net and noise, which stays replicated (see
    above).  Use ``env_params.random_start=True`` for vectorised
    self-play: with deterministic starts and no epsilon, noisy-greedy
    clones every env."""
    ax = _data_ranks(mesh, num_envs, cfg, "RainbowConfig")
    carry = RB.rainbow_train_init(seed, cfg, env_params, num_envs,
                                  device=device)
    part = data_sharding(mesh)
    carry = _local_rows(carry, ("env_state", "obs", "ep_reward"), part)
    carry = _local_rows(carry, ("nstep",), part, second_axis=True)
    return _reseed(carry, seed, ax.d)


def spmd_rainbow_chunk(mesh, cfg: RB.RainbowConfig, env_params: EnvParams,
                       carry: RB.RainbowCarry,
                       num_steps: int) -> RB.RainbowCarry:
    """Rainbow data-parallel over the mesh's ``data`` group: one averaged
    learner, a global learn gate and a global episodic target sync."""
    return RB.rainbow_train_chunk(cfg, env_params, carry, num_steps,
                                  axis=mesh.get_group("data"))


_DRQN_ROWS = ("env_state", "obs", "lstm_h", "lstm_c", "lstm_h2", "lstm_c2",
              "window", "window_len", "ep_reward")


def spmd_drqn_init(seed: int, cfg: DR.DRQNConfig, env_params: EnvParams,
                   num_envs: int, mesh, opp_params=None,
                   device=None) -> DR.DRQNCarry:
    """This rank's DRQN carry: its envs, both seats' LSTM states and its
    accumulating windows, and a sequence ring of ``cfg.memory_capacity``
    windows per rank, which must hold one flush of its ``num_envs /
    data`` windows; ``num_envs`` is global."""
    ax = _data_ranks(mesh, num_envs, cfg, "DRQNConfig")
    local = num_envs // ax.dp
    if cfg.memory_capacity < local:
        raise ValueError(f"per-rank memory_capacity={cfg.memory_capacity} "
                         f"< local envs {local}: each rank's sequence ring "
                         "must hold one synchronized flush")
    # drqn_train_init checks its ring against the global envs; the rank's
    # ring is checked above and built below.
    big = cfg.memory_capacity < num_envs
    carry = DR.drqn_train_init(
        seed, cfg.replace(memory_capacity=num_envs) if big else cfg,
        env_params, num_envs, opp_params, device)
    if big:
        carry = dataclasses.replace(carry, replay=rp.replay_init(
            cfg.memory_capacity,
            DR._window_example(cfg, carry.obs.device)))
    carry = _local_rows(carry, _DRQN_ROWS, data_sharding(mesh))
    return _reseed(carry, seed, ax.d)


def spmd_drqn_chunk(mesh, cfg: DR.DRQNConfig, env_params: EnvParams,
                    carry: DR.DRQNCarry, num_steps: int) -> DR.DRQNCarry:
    """Recurrent DQN data-parallel over the mesh's ``data`` group."""
    return DR.drqn_train_chunk(cfg, env_params, carry, num_steps,
                               axis=mesh.get_group("data"))


# ---------------------------------------------------------------------------
# Fused trainers (K5, K7, K8, K9) under local SGD
# ---------------------------------------------------------------------------

def _check_fused_launch(num_steps, env_params, greedy):
    """The single-chip chunks' own guards, checked before any rank
    launches: a chunk has at least one step, and random starts draw from
    the Philox streams that greedy mode skips."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    if env_params.random_start and greedy:
        raise ValueError("random starts need the on-chip PRNG, which "
                         "greedy mode skips; drop one of the two")


def _split_lanes(mesh, num_envs: int, capacities: dict) -> tuple:
    """``(ranks, lanes a rank)``; every capacity (global) must divide."""
    ndev = axis_size(mesh, "data")
    if num_envs % ndev:
        raise ValueError(f"num_envs {num_envs} must divide over {ndev} "
                         "data ranks")
    for name, cap in capacities.items():
        if cap % ndev:
            raise ValueError(f"{name} {cap} must divide over {ndev} data "
                             "ranks (it is a GLOBAL transition count, split "
                             "into per-rank rings)")
    return ndev, num_envs // ndev


def _fold_counts(new: dict, carry: dict, num_steps: int) -> dict:
    """The fold counted the local lanes' env-steps; count the global."""
    new["env_steps"] = carry["env_steps"] + num_steps * carry["n_global"]
    return new


def _reduce_chunk(st: dict, names, mesh):
    """The averaged sets ``names`` of a chunk's working state, its metrics
    summed and its loss averaged over the mesh's ``data`` group: the
    sets in one f32 sum, the metric sums (f64, as the single chip reads
    them) and the loss in one f64 sum and one read-back.  The mean loss
    is rounded to f32, so over one or two ranks it is the f32 mean."""
    group = mesh.get_group("data")
    sets = pmean([st[k] for k in names], group)
    tail = psum(torch.cat([st["met"].to(torch.float64).sum(dim=1),
                           st["loss"].to(torch.float64).reshape(1)]),
                group).tolist()
    return sets, tail[:4], float(np.float32(tail[4] /
                                            axis_size(mesh, "data")))


def spmd_fused_dqn_init(seed: int, cfg: D.DQNConfig, env_params: EnvParams,
                        num_envs: int, mesh, opp_params=None,
                        learn_batch=None, learn_rounds=1,
                        device=None) -> dict:
    """This rank's K5 carry: ``num_envs / data`` lanes and a ring of
    ``cfg.memory_capacity / data``, both of them global counts, so all of
    ``ops.fused_trainer``'s size rules apply per rank (``learn_batch`` is
    a per-rank batch).  Every rank starts from the same lanes, nets and
    moments (the JAX init tiles one rank's lanes)."""
    ndev, n_local = _split_lanes(mesh, num_envs,
                                 {"memory_capacity": cfg.memory_capacity})
    carry = FT.fused_dqn_init(
        seed, cfg.replace(memory_capacity=cfg.memory_capacity // ndev),
        env_params, n_local, opp_params, learn_batch=learn_batch,
        learn_rounds=learn_rounds, device=device)
    return {**carry, "n_local": n_local, "n_global": num_envs}


def spmd_fused_dqn_chunk(mesh, cfg: D.DQNConfig, env_params: EnvParams,
                         carry: dict, num_steps: int, seed: int, *,
                         greedy=False, rounds=None, cols=None) -> dict:
    """One K5 chunk on every rank under ``data_seed(seed, d)``, then the
    average of ``p``, ``tp``, ``m`` and ``v`` over ``data``, the metric
    sums and the mean loss.  ``rounds``/``cols``: this rank's own streams
    (default: drawn from its seed)."""
    _check_fused_launch(num_steps, env_params, greedy)
    st = FT.chunk_state(cfg, env_params, carry, num_steps,
                        data_seed(seed, axis_index(mesh, "data")),
                        greedy=greedy, rounds=rounds, cols=cols)
    names = ("p", "tp", "m", "v")
    sets, met, loss = _reduce_chunk(st, names, mesh)
    dims = FT._dims(carry["p"])
    out = {k: FT._transposed(a, dims) for k, a in zip(names, sets)}
    out["env"], out["ring"] = st["env"], st["ring"]
    return _fold_counts(FT.apply_chunk(carry, out, num_steps, met, loss),
                        carry, num_steps)


def spmd_fused_hdqn_init(seed: int, cfg: H.HDQNConfig, env_params: EnvParams,
                         num_envs: int, mesh, learn_batch=None,
                         device=None) -> dict:
    """This rank's K7 carry (cf. :func:`spmd_fused_dqn_init`): both
    capacities are global counts split over the data ranks."""
    ndev, n_local = _split_lanes(mesh, num_envs, {
        "memory_capacity": cfg.memory_capacity,
        "goal_memory_capacity": cfg.goal_memory_capacity})
    carry = FH.fused_hdqn_init(
        seed, cfg.replace(memory_capacity=cfg.memory_capacity // ndev,
                          goal_memory_capacity=cfg.goal_memory_capacity
                          // ndev),
        env_params, n_local, learn_batch=learn_batch, device=device)
    return {**carry, "n_local": n_local, "n_global": num_envs}


def spmd_fused_hdqn_chunk(mesh, cfg: H.HDQNConfig, env_params: EnvParams,
                          carry: dict, num_steps: int, seed: int, *,
                          greedy=False, lo_rounds=None, up_rounds=None,
                          cols=None) -> dict:
    """One K7 chunk on every rank under ``data_seed(seed, d)``, then the
    average of both learners' eight sets over ``data``, the metric sums
    and the mean loss."""
    _check_fused_launch(num_steps, env_params, greedy)
    st = FH.chunk_state(cfg, env_params, carry, num_steps,
                        data_seed(seed, axis_index(mesh, "data")),
                        greedy=greedy, lo_rounds=lo_rounds,
                        up_rounds=up_rounds, cols=cols)
    names = FH.SETS[:8]
    sets, met, loss = _reduce_chunk(st, names, mesh)
    du, dl = FT._dims(carry["u_p"]), FT._dims(carry["l_p"])
    groups = [FT._transposed(a, du if k.startswith("u_") else dl)
              for k, a in zip(names, sets)]
    new = FH.apply_hdqn_chunk(carry, groups, st["state"], st["lo_ring"],
                              st["up_ring"], num_steps, met, loss)
    return _fold_counts(new, carry, num_steps)


def spmd_fused_rainbow_init(seed: int, cfg: RB.RainbowConfig,
                            env_params: EnvParams, num_envs: int, mesh,
                            opp_params=None, learn_batch=None,
                            device=None) -> dict:
    """This rank's K8 carry (cf. :func:`spmd_fused_dqn_init`):
    ``num_envs / data`` lanes and a ring of ``cfg.memory_capacity /
    data``, both global counts.  Every rank starts from the same lanes,
    net and moments; rank ``d``'s noise (``eps``, ``teps``) is the noise
    that ``fused_rainbow_init`` under ``data_seed(seed, d)`` draws (rank
    0's is the run's)."""
    ndev, n_local = _split_lanes(mesh, num_envs,
                                 {"memory_capacity": cfg.memory_capacity})
    local = cfg.replace(memory_capacity=cfg.memory_capacity // ndev)

    def init(s):
        return FRB.fused_rainbow_init(s, local, env_params, n_local,
                                      opp_params, learn_batch=learn_batch,
                                      device=device)
    carry = init(seed)
    d = axis_index(mesh, "data")
    if d:
        own = init(data_seed(seed, d))
        carry["eps"], carry["teps"] = own["eps"], own["teps"]
    return {**carry, "n_local": n_local, "n_global": num_envs}


def spmd_fused_rainbow_chunk(mesh, cfg: RB.RainbowConfig,
                             env_params: EnvParams, carry: dict,
                             num_steps: int, seed: int, *, greedy=False,
                             rounds=None, cols=None, us=None) -> dict:
    """One K8 chunk on every rank under ``data_seed(seed, d)``, then the
    average of ``p``, ``tp``, ``m`` and ``v`` over ``data`` (the noise
    stays on its rank), the metric sums and the mean loss (0.0 when the
    chunk's last step did not learn, on every rank); under PER, env row
    13 (the running max priority) is the ranks' maximum.  The episodic
    target sync and rows 11-12 stay rank-local.  ``rounds``/``cols``/
    ``us``: this rank's own streams (default: drawn from its seed)."""
    _check_fused_launch(num_steps, env_params, greedy)
    st, learned = FRB.chunk_state(cfg, env_params, carry, num_steps,
                                  data_seed(seed, axis_index(mesh, "data")),
                                  greedy=greedy, rounds=rounds, cols=cols,
                                  us=us)
    if not learned:
        st["loss"] = torch.zeros_like(st["loss"])
    if cfg.per:
        st["env"][13] = pmax(st["env"][13], mesh.get_group("data"))
    names = ("p", "tp", "m", "v")
    sets, met, loss = _reduce_chunk(st, names, mesh)
    out = {k: st[k] for k in ("eps", "teps", "env", "ring")}
    out.update(zip(names, sets))
    new = FRB.apply_rainbow_chunk(carry, out, num_steps, met, loss,
                                  nwarm=cfg.n_step)
    return _fold_counts(new, carry, num_steps)


def spmd_fused_drqn_init(seed: int, cfg: DR.DRQNConfig,
                         env_params: EnvParams, num_envs: int, mesh,
                         opp_params=None, learn_batch=None,
                         device=None) -> dict:
    """This rank's K9 carry (cf. :func:`spmd_fused_dqn_init`): its lanes
    of the env rows (both seats' LSTM states among them), the window
    buffer and the sequence ring; ``cfg.memory_capacity`` is a global
    window count split over the data ranks."""
    ndev, n_local = _split_lanes(mesh, num_envs,
                                 {"memory_capacity": cfg.memory_capacity})
    carry = FD.fused_drqn_init(
        seed, cfg.replace(memory_capacity=cfg.memory_capacity // ndev),
        env_params, n_local, opp_params, learn_batch=learn_batch,
        device=device)
    return {**carry, "n_local": n_local, "n_global": num_envs}


def spmd_fused_drqn_chunk(mesh, cfg: DR.DRQNConfig, env_params: EnvParams,
                          carry: dict, num_steps: int, seed: int, *,
                          greedy=False, rounds=None, cols=None) -> dict:
    """One K9 chunk on every rank under ``data_seed(seed, d)``, then the
    average of the four parameter sets over ``data``, the metric sums and
    the mean loss."""
    _check_fused_launch(num_steps, env_params, greedy)
    st = FD.chunk_state(cfg, env_params, carry, num_steps,
                        data_seed(seed, axis_index(mesh, "data")),
                        greedy=greedy, rounds=rounds, cols=cols)
    names = ("p", "tp", "m", "v")
    sets, met, loss = _reduce_chunk(st, names, mesh)
    out = {k: st[k] for k in ("env", "win", "ring")}
    out.update(zip(names, sets))
    new = FD.apply_drqn_chunk(carry, out, num_steps, met, loss)
    return _fold_counts(new, carry, num_steps)


def _rank_lanes(carry: dict, rank: int, world: int, keys) -> tuple:
    n_global = int(carry["n"])
    n_local = int(carry.get("n_local", n_global // world))
    if n_local * world != n_global:
        raise ValueError(f"a carry of {n_global} lanes does not split into "
                         f"{world} ranks of {n_local}")
    lanes = slice(rank * n_local, (rank + 1) * n_local)
    local = dict(carry, n=n_local)
    for k in keys:
        local[k] = np.asarray(carry[k])[:, lanes]
    return local, n_local, n_global


def fused_carry_from_numpy(carry: dict, rank: int, world: int,
                           device=None) -> dict:
    """Rank ``rank``'s K5 carry from a JAX ``spmd_fused_dqn_init`` /
    ``spmd_fused_dqn_chunk`` carry (global lane-sharded ``env`` and
    ``ring``, lanes ``[rank * n_local, (rank + 1) * n_local)``)."""
    local, n_local, n_global = _rank_lanes(carry, rank, world,
                                           ("env", "ring"))
    out = FT.carry_from_numpy(local, device)
    return {**out, "n_local": n_local, "n_global": n_global}


def hdqn_fused_carry_from_numpy(carry: dict, rank: int, world: int,
                                device=None) -> dict:
    """Rank ``rank``'s K7 carry from a JAX ``spmd_fused_hdqn_*`` carry."""
    local, n_local, n_global = _rank_lanes(
        carry, rank, world, ("state", "lo_ring", "up_ring"))
    out = FH.hdqn_carry_from_numpy(local, device)
    return {**out, "n_local": n_local, "n_global": n_global}


def rainbow_fused_carry_from_numpy(carry: dict, rank: int, world: int,
                                   device=None) -> dict:
    """Rank ``rank``'s K8 carry from a JAX ``spmd_fused_rainbow_*`` carry:
    its lanes of ``env`` and ``ring`` and its block of the lane-sharded
    noise (``[464, 64 * world]`` and ``[464, world]``, block ``rank``)."""
    local, n_local, n_global = _rank_lanes(carry, rank, world,
                                           ("env", "ring"))
    for k in ("eps", "teps"):
        blocks = []
        for a in map(np.asarray, carry[k]):
            w = a.shape[1] // world
            blocks.append(a[:, rank * w:(rank + 1) * w])
        local[k] = tuple(blocks)
    out = FRB.rainbow_carry_from_numpy(local, device)
    return {**out, "n_local": n_local, "n_global": n_global}


def drqn_fused_carry_from_numpy(carry: dict, rank: int, world: int,
                                device=None) -> dict:
    """Rank ``rank``'s K9 carry from a JAX ``spmd_fused_drqn_*`` carry:
    its lanes of ``env``, ``win`` and ``ring``."""
    local, n_local, n_global = _rank_lanes(carry, rank, world,
                                           ("env", "win", "ring"))
    out = FD.drqn_carry_from_numpy(local, device)
    return {**out, "n_local": n_local, "n_global": n_global}
