"""Hyper-parameter sweeps: one independent DQN run per ``EnvParams``.

Counterpart of ``merging_gym_tpu/parallel/sweep.py``.  The JAX package
``vmap``s the step loop over stacked reward parameters; the port's step
loop draws its actions from K4, a kernel launch that does not batch over
a sweep axis, so the entries run one after another on the host, each
exactly the single run it stands for.  Batching the entries into one
launch is speed work for later.

Entry ``i`` runs under ``seed + i * 0x9E3779B9`` (``spmd.data_seed``'s
rule): entry 0 is the plain run with ``seed``.  Static fields
(``random_start``, ``max_steps``) must agree; the reward parameters may
differ.
"""

from __future__ import annotations

from merging_gym_tpu_torch.agents import dqn as D
from merging_gym_tpu_torch.parallel.spmd import data_seed


def stack_env_params(param_list) -> tuple:
    """The sweep axis: a tuple of ``EnvParams`` whose static fields
    agree."""
    first = param_list[0]
    assert all(p.random_start == first.random_start
               and p.max_steps == first.max_steps for p in param_list)
    return tuple(param_list)


def sweep_train_init(seed: int, cfg: D.DQNConfig, stacked_params: tuple,
                     num_envs: int, device=None) -> list:
    """One independent ``TrainCarry`` per entry: distinct nets, env
    batches, replays and streams."""
    return [D.train_init(data_seed(seed, i), cfg, p, num_envs, device=device)
            for i, p in enumerate(stacked_params)]


def sweep_train_chunk(cfg: D.DQNConfig, stacked_params: tuple, carries,
                      num_steps: int) -> list:
    """Advance every entry ``num_steps`` steps of ``agents.dqn.train_step``."""
    return [D.train_chunk(cfg, p, c, num_steps)
            for p, c in zip(stacked_params, carries)]
