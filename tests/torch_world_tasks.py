"""Rank-side tasks of the port's parallel tests (see ``tests/torch_world.py``).

Each task runs on every rank of a gloo world on the CPU, imports only
torch and the port, takes numpy inputs and returns numpy results (or
``None`` on a rank outside the mesh)."""

from __future__ import annotations

import dataclasses
import os
from functools import partial

import numpy as np
import torch

from merging_gym_tpu_torch.agents import dqn as D
from merging_gym_tpu_torch.agents import drqn as DR
from merging_gym_tpu_torch.agents import hdqn as H
from merging_gym_tpu_torch.agents import rainbow as RB
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.io.checkpoint import CheckpointManager, state_tree
from merging_gym_tpu_torch.nn.lstm import drqn_params_from_numpy
from merging_gym_tpu_torch.nn.rainbow_net import rainbow_params_from_numpy
from merging_gym_tpu_torch.ops import replay as rp
from merging_gym_tpu_torch.parallel import mesh as M
from merging_gym_tpu_torch.parallel import spmd

CPU = torch.device("cpu")


def to_numpy(tree):
    """A carry (or any tree of tensors) as nested numpy: ``state_tree``'s
    plain tree with every tensor a numpy array."""
    def go(x):
        if isinstance(x, torch.Tensor):
            return x.numpy()
        if isinstance(x, dict):
            return {k: go(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(go(v) for v in x)
        return x
    return go(state_tree(tree))


def _params(tree):
    return {layer: {k: torch.tensor(np.asarray(v, np.float32))
                    for k, v in p.items()} for layer, p in tree.items()}


def _batch(b, rows=slice(None)):
    return {"obs": torch.tensor(b["obs"][rows], dtype=torch.float32),
            "action": torch.tensor(b["action"][rows], dtype=torch.int32),
            "reward": torch.tensor(b["reward"][rows], dtype=torch.float32),
            "next_obs": torch.tensor(b["next_obs"][rows],
                                     dtype=torch.float32),
            "done": torch.tensor(b["done"][rows], dtype=torch.bool)}


def _mesh(data, model):
    mesh = M.make_mesh(data, model)
    return mesh if mesh.get_coordinate() is not None else None


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------

def tp_forward(data, model, params, x):
    """This rank's rows of the tensor-parallel forward."""
    mesh = _mesh(data, model)
    if mesh is None:
        return None
    d, m = M.axis_index(mesh, "data"), M.axis_index(mesh, "model")
    shard = spmd.qnet_shard(_params(params), m, model)
    rows = M.data_sharding(mesh).rows(len(x))
    q = spmd.qnet_apply_tp(shard, torch.tensor(x[rows]),
                           mesh.get_group("model"))
    return d, m, q.numpy()


def tp_grads(data, model, params, target, batch, cfg_kw):
    """This rank's shard of the gradients of the tensor-parallel TD loss
    on its data rows, averaged over ``data`` (the learner's gradient)."""
    mesh = _mesh(data, model)
    if mesh is None:
        return None
    d, m = M.axis_index(mesh, "data"), M.axis_index(mesh, "model")
    cfg = D.DQNConfig(**cfg_kw)
    p = spmd.qnet_shard(_params(params), m, model)
    t = spmd.qnet_shard(_params(target), m, model)
    rows = M.data_sharding(mesh).rows(len(batch["obs"]))
    with torch.enable_grad():
        p = D._tree_map(lambda a: a.requires_grad_(True), p)
        loss = spmd._td_loss_tp(p, t, _batch(batch, rows), cfg,
                                mesh.get_group("model"))
        flat = torch.autograd.grad(loss, D._leaves(p))
    flat = M.pmean(list(flat), mesh.get_group("data"))
    it = iter(flat)
    grads = D._tree_map(lambda _: next(it).numpy(), p)
    return d, m, grads


def tp_actions(data, model, params, obs, cfg_kw, seed):
    """The step loop's actions on this rank's rows of ``obs`` with the
    shards of ``params`` (``parallel.spmd._choose_actions``), beside
    ``agents.dqn._choose_actions`` (K4's plain version) on the whole
    net."""
    mesh = _mesh(data, model)
    if mesh is None:
        return None
    ax = spmd._axes(mesh)
    cfg = D.DQNConfig(**cfg_kw)
    carry = spmd.spmd_train_init(seed, cfg, EnvParams(), len(obs), mesh,
                                 device=CPU)
    full = _params(params)
    shard = spmd.qnet_shard(full, ax.m, ax.tp)
    rows = M.data_sharding(mesh).rows(len(obs))
    carry = dataclasses.replace(
        carry, obs=torch.tensor(obs[rows]), step=5, opp_params=shard,
        dqn=dataclasses.replace(carry.dqn, params=shard))
    got = spmd._choose_actions(carry, cfg, ax)
    whole = dataclasses.replace(
        carry, opp_params=full, dqn=dataclasses.replace(carry.dqn,
                                                        params=full))
    return ax.d, ax.m, (got.numpy(), D._choose_actions(whole, cfg).numpy())


def learn_step(data, model, params, target, batch, cfg_kw):
    """One ``agents.dqn.learn`` on this rank's rows of ``batch`` with the
    mesh's data group as ``axis`` (and the tensor-parallel loss on its
    shard when ``model > 1``), from ``params``/``target`` and fresh Adam
    moments at learn count 1 (no target sync)."""
    mesh = _mesh(data, model)
    if mesh is None:
        return None
    ax = spmd._axes(mesh)
    cfg = D.DQNConfig(**cfg_kw)
    st = D.dqn_init(torch.Generator().manual_seed(0), cfg, CPU)
    st = dataclasses.replace(st, params=_params(params),
                             target_params=_params(target),
                             learn_counter=torch.ones((), dtype=torch.int32))
    loss_fn = D.td_loss
    if ax.tp > 1:
        st = spmd._shard_state(st, ax.m, ax.tp)
        loss_fn = partial(spmd._td_loss_tp, group=ax.model)
    rows = M.data_sharding(mesh).rows(len(batch["obs"]))
    st = D.learn(st, _batch(batch, rows), cfg, axis=ax.data,
                 loss_fn=loss_fn)
    return ax.d, ax.m, to_numpy(st)


# ---------------------------------------------------------------------------
# Step loops
# ---------------------------------------------------------------------------

def train_loop(data, model, cfg_kw, num_envs, seed, chunks):
    """``spmd_train_chunk`` for each length in ``chunks``: the global
    env-step count after each, then the final learner state."""
    mesh = _mesh(data, model)
    if mesh is None:
        return None
    cfg = D.DQNConfig(**cfg_kw)
    ep = EnvParams()
    carry = spmd.spmd_train_init(seed, cfg, ep, num_envs, mesh, device=CPU)
    steps = []
    for T in chunks:
        carry = spmd.spmd_train_chunk(mesh, cfg, ep, carry, T)
        steps.append(int(carry.metrics.env_steps))
    return {"coord": mesh.get_coordinate(), "env_steps": steps,
            "dqn": to_numpy(carry.dqn), "metrics": to_numpy(carry.metrics),
            "cursor": int(carry.replay.cursor), "seed": carry.seed,
            "obs": carry.obs.numpy()}


def hdqn_loop(cfg_kw, num_envs, seed, chunks):
    mesh = M.make_mesh()
    cfg = H.HDQNConfig(pmean_axis="data", **cfg_kw)
    ep = EnvParams()
    carry = spmd.spmd_hdqn_init(seed, cfg, ep, num_envs, mesh, device=CPU)
    steps = []
    for T in chunks:
        carry = spmd.spmd_hdqn_chunk(mesh, cfg, ep, carry, T)
        steps.append(int(carry.metrics.env_steps))
    return {"env_steps": steps, "upper": to_numpy(carry.upper),
            "lower": to_numpy(carry.lower), "goal": carry.goal.numpy(),
            "metrics": to_numpy(carry.metrics),
            "upper_cursor": int(carry.upper_replay.cursor)}


# ---------------------------------------------------------------------------
# Fused trainers under local SGD
# ---------------------------------------------------------------------------

def fused_dqn(jax_carry, cfg_kw, ep_kw, T, seed, greedy, rounds, cols):
    """A JAX ``spmd_fused_dqn_init`` carry (numpy) -> this rank's carry ->
    one ``spmd_fused_dqn_chunk`` with this rank's streams."""
    mesh = M.make_mesh()
    r, w = M.axis_index(mesh, "data"), M.axis_size(mesh, "data")
    carry = spmd.fused_carry_from_numpy(jax_carry, r, w, device=CPU)
    carry = spmd.spmd_fused_dqn_chunk(
        mesh, D.DQNConfig(**cfg_kw), EnvParams(**ep_kw), carry, T, seed,
        greedy=greedy, rounds=None if rounds is None else rounds[r],
        cols=None if cols is None else cols[r])
    return to_numpy(carry)


def fused_hdqn(jax_carry, cfg_kw, ep_kw, T, seed, greedy, lo_rounds,
               up_rounds):
    mesh = M.make_mesh()
    r, w = M.axis_index(mesh, "data"), M.axis_size(mesh, "data")
    carry = spmd.hdqn_fused_carry_from_numpy(jax_carry, r, w, device=CPU)
    carry = spmd.spmd_fused_hdqn_chunk(
        mesh, H.HDQNConfig(**cfg_kw), EnvParams(**ep_kw), carry, T, seed,
        greedy=greedy, lo_rounds=None if lo_rounds is None else lo_rounds[r],
        up_rounds=None if up_rounds is None else up_rounds[r])
    return to_numpy(carry)


def fused_dqn_fresh(cfg_kw, ep_kw, num_envs, chunks):
    """``spmd_fused_dqn_init`` from seed 0, then a chunk per seed in
    ``chunks`` in random mode."""
    mesh = M.make_mesh()
    cfg, ep = D.DQNConfig(**cfg_kw), EnvParams(**ep_kw)
    carry = spmd.spmd_fused_dqn_init(0, cfg, ep, num_envs, mesh, device=CPU)
    for seed, T in chunks:
        carry = spmd.spmd_fused_dqn_chunk(mesh, cfg, ep, carry, T, seed)
    return to_numpy(carry)


def refusals(num_envs, capacity):
    """The messages of every refusal a two-rank world raises here."""
    mesh = M.make_mesh()
    out = {}
    cases = {
        "fused_dqn": lambda: spmd.spmd_fused_dqn_init(
            0, D.DQNConfig(memory_capacity=capacity), EnvParams(), num_envs,
            mesh, device=CPU),
        "fused_hdqn": lambda: spmd.spmd_fused_hdqn_init(
            0, H.HDQNConfig(memory_capacity=2 * num_envs,
                            goal_memory_capacity=capacity), EnvParams(),
            num_envs, mesh, device=CPU),
        "fused_envs": lambda: spmd.spmd_fused_dqn_init(
            0, D.DQNConfig(memory_capacity=2 * num_envs), EnvParams(),
            num_envs + 1, mesh, device=CPU),
        "loop_envs": lambda: spmd.spmd_train_init(
            0, D.DQNConfig(), EnvParams(), 3, mesh, device=CPU),
        "hdqn_axis": lambda: spmd.spmd_hdqn_init(
            0, H.HDQNConfig(), EnvParams(), 8, mesh, device=CPU),
    }
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def checkpoint_resume(directory, T):
    """Runs A (two chunks, a save after each), B (restored from A's first
    save, one chunk) and C (two chunks uninterrupted) of the fused DQN
    trainer and the DQN step loop; returns B's and C's carries, the steps
    held and a refused restore's message."""
    mesh = M.make_mesh()
    ep = EnvParams()
    fcfg = D.DQNConfig(memory_capacity=2 * 256, opponent=D.OPP_SELFPLAY)
    lcfg = D.DQNConfig(memory_capacity=32, batch_size=8,
                       opponent=D.OPP_SELFPLAY)

    def fused(carry, k):
        return spmd.spmd_fused_dqn_chunk(mesh, fcfg, ep, carry, T, seed=k)

    def loop(carry, k):
        return spmd.spmd_train_chunk(mesh, lcfg, ep, carry, T)

    runs = {"fused": (lambda: spmd.spmd_fused_dqn_init(
                3, fcfg, ep, 256, mesh, device=CPU), fused),
            "loop": (lambda: spmd.spmd_train_init(
                3, lcfg, ep, 16, mesh, device=CPU), loop)}
    out = {}
    for name, (init, chunk) in runs.items():
        mgr = CheckpointManager(os.path.join(directory, name))
        a = init()
        for k in (1, 2):
            a = chunk(a, k)
            assert mgr.save(k, a)
        b = chunk(mgr.restore(init(), step=1), 2)
        c = chunk(chunk(init(), 1), 2)
        out[name] = {"b": to_numpy(b), "c": to_numpy(c),
                     "steps": mgr.all_steps(), "a": to_numpy(a)}
    # A directory written by one process is refused by a world of two.
    single = os.path.join(directory, "single")
    try:
        CheckpointManager(single).restore(runs["fused"][0]())
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    return out



def checkpoint_cut_between_ranks(directory):
    """Saves steps 1 and 2 on every rank, then removes step 2's commit
    marker and the last rank's file of it (a run killed after rank 0's
    rename of step 2 and before the last rank's): every rank must then
    hold, skip and restore the same steps.  Returns what this rank saw."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()

    def state(step):
        return {"step": step, "rank": rank,
                "x": torch.full((3,), 10.0 * step + rank)}
    mgr = CheckpointManager(directory)
    saved = [mgr.save(k, state(k)) for k in (1, 2)]
    if rank == 0:
        os.remove(mgr.commit_path(2))
    if rank == world - 1:
        os.remove(mgr.step_path(2))
    dist.barrier()
    out = {"saved": saved, "steps": mgr.all_steps(),
           "latest": mgr.latest_step(),
           "restored": to_numpy(mgr.restore(state(0)))}
    dist.barrier()
    # The step that not every rank wrote is written again, by all.
    out["resaved"] = mgr.save(2, state(2))
    out["steps_after"] = mgr.all_steps()
    out["restored_after"] = to_numpy(mgr.restore(state(0)))
    return out


# ---------------------------------------------------------------------------
# Rainbow and DRQN step loops
# ---------------------------------------------------------------------------

def collectives_rb():
    """``pmax`` and ``broadcast`` over the data group."""
    mesh = M.make_mesh()
    g, r = mesh.get_group("data"), float(M.axis_index(mesh, "data"))
    x = torch.tensor([r, -r, 2.5])
    return {"max": M.pmax(x, g).numpy(),
            "bcast": [t.numpy() for t in M.broadcast(
                [x + 10.0, torch.full((2,), r)], g)]}


def _rb_cfg(cfg_kw):
    return RB.RainbowConfig(pmean_axis="data", **cfg_kw)


def _dr_cfg(cfg_kw):
    return DR.DRQNConfig(pmean_axis="data", **cfg_kw)


def rainbow_loop(cfg_kw, ep_kw, num_envs, seed, chunks):
    """``spmd_rainbow_chunk`` for each length in ``chunks``: the global
    env-step count after each, then the learner, noise and counters."""
    mesh = M.make_mesh()
    cfg, ep = _rb_cfg(cfg_kw), EnvParams(**ep_kw)
    carry = spmd.spmd_rainbow_init(seed, cfg, ep, num_envs, mesh, device=CPU)
    noise0 = to_numpy(carry.noise)
    steps = []
    for T in chunks:
        carry = spmd.spmd_rainbow_chunk(mesh, cfg, ep, carry, T)
        steps.append(int(carry.metrics.env_steps))
    replay = carry.replay.base if cfg.per else carry.replay
    return {"env_steps": steps, "seed": carry.seed,
            "learner": to_numpy({"params": carry.params,
                                 "target": carry.target_params,
                                 "opt": carry.opt_state,
                                 "sync_chunks": carry.sync_chunks,
                                 "loss": carry.last_loss}),
            "noise": to_numpy(carry.noise), "noise0": noise0,
            "metrics": to_numpy(carry.metrics),
            "max_priority": (float(carry.replay.max_priority) if cfg.per
                             else None),
            "cursor": int(replay.cursor), "obs": carry.obs.numpy()}


def drqn_loop(cfg_kw, ep_kw, num_envs, seed, chunks):
    mesh = M.make_mesh()
    cfg, ep = _dr_cfg(cfg_kw), EnvParams(**ep_kw)
    carry = spmd.spmd_drqn_init(seed, cfg, ep, num_envs, mesh, device=CPU)
    steps = []
    for T in chunks:
        carry = spmd.spmd_drqn_chunk(mesh, cfg, ep, carry, T)
        steps.append(int(carry.metrics.env_steps))
    return {"env_steps": steps,
            "learner": to_numpy({"params": carry.params,
                                 "target": carry.target_params,
                                 "opt": carry.opt_state,
                                 "count": carry.learn_counter,
                                 "loss": carry.last_loss}),
            "metrics": to_numpy(carry.metrics),
            "capacity": rp.replay_capacity(carry.replay),
            "cursor": int(carry.replay.cursor), "obs": carry.obs.numpy()}


def _prefilled(replay, fill):
    """``replay`` with its cursor at ``fill`` (as if that many zero items
    had been stored)."""
    base = replay.base if hasattr(replay, "base") else replay
    base = dataclasses.replace(base, cursor=torch.tensor(fill))
    if hasattr(replay, "base"):
        return dataclasses.replace(replay, base=base)
    return base


def rainbow_gate(cfg_kw, num_envs, fills, steps):
    """Rank ``r``'s ring starts at ``fills[r]`` items; after each of
    ``steps`` steps, this rank's Adam count and fill, and what a
    single-device step from the same carry would count."""
    mesh = M.make_mesh()
    r = M.axis_index(mesh, "data")
    cfg, ep = _rb_cfg(cfg_kw), EnvParams()
    carry = spmd.spmd_rainbow_init(0, cfg, ep, num_envs, mesh, device=CPU)
    carry = dataclasses.replace(carry,
                                replay=_prefilled(carry.replay, fills[r]))
    out = []
    for _ in range(steps):
        alone = RB.rainbow_train_step(cfg.replace(pmean_axis=None), ep,
                                      _fork(carry))
        carry = spmd.spmd_rainbow_chunk(mesh, cfg, ep, carry, 1)
        out.append((int(carry.opt_state.count),
                    int(alone.opt_state.count),
                    int((carry.replay.base if cfg.per
                         else carry.replay).cursor)))
    return out


def drqn_gate(cfg_kw, num_envs, fills, steps):
    mesh = M.make_mesh()
    r = M.axis_index(mesh, "data")
    cfg, ep = _dr_cfg(cfg_kw), EnvParams()
    carry = spmd.spmd_drqn_init(0, cfg, ep, num_envs, mesh, device=CPU)
    carry = dataclasses.replace(carry,
                                replay=_prefilled(carry.replay, fills[r]))
    out = []
    for _ in range(steps):
        alone = DR.drqn_train_step(cfg.replace(pmean_axis=None), ep,
                                   _fork(carry))
        carry = spmd.spmd_drqn_chunk(mesh, cfg, ep, carry, 1)
        out.append((int(carry.learn_counter), int(alone.learn_counter),
                    int(carry.replay.cursor)))
    return out


def _fork(carry):
    """``carry`` with a copy of its generator (the copy advances alone)."""
    g = torch.Generator()
    g.set_state(carry.generator.get_state())
    return dataclasses.replace(carry, generator=g)


def rainbow_learn(params, target, noise, target_noise, items, cfg_kw):
    """One ``agents.rainbow._learn`` over the data group from ``params``
    / ``target`` and fresh moments, on this rank's noise (``noise[r]``)
    and a uniform draw from a ring holding ``items[r]``: the batch drawn,
    the new params and moments and the loss."""
    mesh = M.make_mesh()
    r = M.axis_index(mesh, "data")
    cfg = _rb_cfg(cfg_kw)
    mine = {k: torch.tensor(v) for k, v in items[r].items()}
    n = len(mine["obs"])
    carry = RB.rainbow_train_init(r, cfg.replace(memory_capacity=n),
                                  EnvParams(), 8, device=CPU)
    carry = dataclasses.replace(
        carry, params=rainbow_params_from_numpy(params, CPU),
        target_params=rainbow_params_from_numpy(target, CPU),
        noise=rainbow_params_from_numpy(noise[r], CPU),
        target_noise=rainbow_params_from_numpy(target_noise[r], CPU))
    replay = rp.add_batch(carry.replay, mine)
    batch, _ = rp.sample_valid(replay, _fork(carry).generator,
                               cfg.batch_size)
    p, opt, _, loss = RB._learn(carry, replay, cfg, mesh.get_group("data"))
    return to_numpy({"batch": batch, "params": p, "mu": opt.mu,
                     "loss": loss})


def drqn_learn(params, target, batches, cfg_kw):
    """One ``agents.drqn._learn`` over the data group on ``batches[r]``
    from ``params`` / ``target`` at learn count 1 (no target sync) and
    fresh moments."""
    mesh = M.make_mesh()
    r = M.axis_index(mesh, "data")
    cfg = _dr_cfg(cfg_kw)
    carry = DR.drqn_train_init(0, cfg.replace(memory_capacity=8),
                               EnvParams(), 8, device=CPU)
    carry = dataclasses.replace(
        carry, params=drqn_params_from_numpy(params, CPU),
        target_params=drqn_params_from_numpy(target, CPU),
        learn_counter=torch.ones((), dtype=torch.int32))
    batch = {k: torch.tensor(v) for k, v in batches[r].items()}
    p, _, opt, loss = DR._learn(carry, batch, cfg, mesh.get_group("data"))
    return to_numpy({"params": p, "mu": opt.mu, "loss": loss})


# ---------------------------------------------------------------------------
# K8 and K9 under local SGD
# ---------------------------------------------------------------------------

def fused_rainbow(jax_carry, cfg_kw, ep_kw, T, seed, greedy, rounds, cols,
                  us):
    """A JAX ``spmd_fused_rainbow_init`` carry (numpy) -> this rank's
    carry -> one ``spmd_fused_rainbow_chunk`` with this rank's streams."""
    mesh = M.make_mesh()
    r, w = M.axis_index(mesh, "data"), M.axis_size(mesh, "data")
    carry = spmd.rainbow_fused_carry_from_numpy(jax_carry, r, w, device=CPU)
    carry = spmd.spmd_fused_rainbow_chunk(
        mesh, RB.RainbowConfig(**cfg_kw), EnvParams(**ep_kw), carry, T,
        seed, greedy=greedy, rounds=rounds[r], cols=cols[r], us=us[r])
    return to_numpy(carry)


def fused_drqn(jax_carry, cfg_kw, ep_kw, T, seed, greedy, rounds, cols):
    mesh = M.make_mesh()
    r, w = M.axis_index(mesh, "data"), M.axis_size(mesh, "data")
    carry = spmd.drqn_fused_carry_from_numpy(jax_carry, r, w, device=CPU)
    carry = spmd.spmd_fused_drqn_chunk(
        mesh, DR.DRQNConfig(**cfg_kw), EnvParams(**ep_kw), carry, T, seed,
        greedy=greedy, rounds=rounds[r], cols=cols[r])
    return to_numpy(carry)


def fused_rb_fresh(family, cfg_kw, ep_kw, num_envs, chunks):
    """``spmd_fused_{rainbow,drqn}_init`` from seed 0, then a chunk per
    ``(seed, steps)`` in ``chunks`` in random mode."""
    mesh = M.make_mesh()
    ep = EnvParams(**ep_kw)
    if family == "rainbow":
        cfg = RB.RainbowConfig(**cfg_kw)
        init, chunk = spmd.spmd_fused_rainbow_init, \
            spmd.spmd_fused_rainbow_chunk
    else:
        cfg = DR.DRQNConfig(**cfg_kw)
        init, chunk = spmd.spmd_fused_drqn_init, spmd.spmd_fused_drqn_chunk
    carry = init(0, cfg, ep, num_envs, mesh, device=CPU)
    for seed, T in chunks:
        carry = chunk(mesh, cfg, ep, carry, T, seed)
    return to_numpy(carry)


def refusals_rb(num_envs):
    """The messages of the Rainbow and DRQN refusals of a two-rank
    world."""
    mesh = M.make_mesh()
    ep = EnvParams()
    cases = {
        "fused_rainbow_capacity": lambda: spmd.spmd_fused_rainbow_init(
            0, RB.RainbowConfig(memory_capacity=2 * num_envs + 1), ep,
            num_envs, mesh, device=CPU),
        "fused_rainbow_envs": lambda: spmd.spmd_fused_rainbow_init(
            0, RB.RainbowConfig(memory_capacity=2 * num_envs), ep,
            num_envs + 1, mesh, device=CPU),
        "fused_drqn_capacity": lambda: spmd.spmd_fused_drqn_init(
            0, DR.DRQNConfig(memory_capacity=2 * num_envs + 1), ep,
            num_envs, mesh, device=CPU),
        "rainbow_axis": lambda: spmd.spmd_rainbow_init(
            0, RB.RainbowConfig(), ep, 8, mesh, device=CPU),
        "rainbow_envs": lambda: spmd.spmd_rainbow_init(
            0, _rb_cfg({}), ep, 7, mesh, device=CPU),
        "drqn_axis": lambda: spmd.spmd_drqn_init(
            0, DR.DRQNConfig(), ep, 8, mesh, device=CPU),
        "drqn_envs": lambda: spmd.spmd_drqn_init(
            0, _dr_cfg({}), ep, 7, mesh, device=CPU),
        "drqn_ring": lambda: spmd.spmd_drqn_init(
            0, _dr_cfg({"memory_capacity": 3}), ep, 8, mesh, device=CPU),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def checkpoint_resume_rb(directory, T):
    """Runs A, B and C (see :func:`checkpoint_resume`) of K8 (PER 3-step)
    and K9 under local SGD and of the Rainbow and DRQN step loops."""
    mesh = M.make_mesh()
    ep = EnvParams(random_start=True)
    k8 = RB.RainbowConfig(memory_capacity=2 * 4 * 128, per=True, n_step=3,
                          batch_size=16, obs_scale=0.01,
                          opponent=D.OPP_SELFPLAY)
    k9 = DR.DRQNConfig(memory_capacity=2 * 2 * 128, seq_len=3, burn_in=1,
                       opponent=D.OPP_SELFPLAY)
    lrb = _rb_cfg(dict(memory_capacity=32, batch_size=4))
    ldr = _dr_cfg(dict(memory_capacity=8, batch_size=2, seq_len=2))
    runs = {
        "k8": (lambda: spmd.spmd_fused_rainbow_init(3, k8, ep, 256, mesh,
                                                    device=CPU),
               lambda c, k: spmd.spmd_fused_rainbow_chunk(mesh, k8, ep, c,
                                                          T, seed=k)),
        "k9": (lambda: spmd.spmd_fused_drqn_init(3, k9, ep, 256, mesh,
                                                 device=CPU),
               lambda c, k: spmd.spmd_fused_drqn_chunk(mesh, k9, ep, c, T,
                                                       seed=k)),
        "rainbow_loop": (lambda: spmd.spmd_rainbow_init(3, lrb, ep, 8, mesh,
                                                        device=CPU),
                         lambda c, k: spmd.spmd_rainbow_chunk(mesh, lrb, ep,
                                                              c, T)),
        "drqn_loop": (lambda: spmd.spmd_drqn_init(3, ldr, ep, 8, mesh,
                                                  device=CPU),
                      lambda c, k: spmd.spmd_drqn_chunk(mesh, ldr, ep, c,
                                                        T)),
    }
    out = {}
    for name, (init, chunk) in runs.items():
        mgr = CheckpointManager(os.path.join(directory, name))
        a = init()
        for k in (1, 2):
            a = chunk(a, k)
            assert mgr.save(k, a)
        b = chunk(mgr.restore(init(), step=1), 2)
        c = chunk(chunk(init(), 1), 2)
        out[name] = {"b": to_numpy(b), "c": to_numpy(c),
                     "steps": mgr.all_steps()}
    return out
