"""Prioritised experience replay on the device, pointer-free.

Counterpart of ``merging_gym_tpu/ops/per.py``.  The reference defines a
PER buffer over segment trees (scripts/ranbowdqn.py:326-437) but never
instantiates it; here priorities are a flat f32 tensor beside the uniform
ring of ``ops.replay``, and proportional sampling is stratified inverse
CDF over a cumulative sum (``searchsorted``), equal in distribution to the
reference's ``find_prefixsum_idx`` (ranbowdqn.py:225-248).

Reference semantics kept: alpha-powered priorities, new items at
``max_priority ** alpha`` (ranbowdqn.py:353-358), importance weights
normalised by the largest weight over the buffer (ranbowdqn.py:405-413),
and ``update_priorities`` tracking the running max (ranbowdqn.py:431-437).
Functions return a new :class:`PERState` and leave their input as it was.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from merging_gym_tpu_torch.ops import replay as rp


@dataclass
class PERState:
    base: rp.ReplayState
    priorities: torch.Tensor    # f32[capacity], already alpha-powered
    max_priority: torch.Tensor  # f32 0-d (pre-alpha, like the reference)
    alpha: float = 0.6


def per_init(capacity: int, example_item: dict, alpha: float = 0.6,
             device=None) -> PERState:
    base = rp.replay_init(capacity, example_item, device)
    dev = base.cursor.device
    return PERState(base=base,
                    priorities=torch.zeros(capacity, dtype=torch.float32,
                                           device=dev),
                    max_priority=torch.ones((), dtype=torch.float32,
                                            device=dev),
                    alpha=alpha)


def per_add_batch(state: PERState, items: dict, mask=None) -> PERState:
    """Append items with priority ``max_priority ** alpha``."""
    cap = rp.replay_capacity(state.base)
    n = next(iter(items.values())).shape[0]
    dev = state.priorities.device
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    slots = torch.where(mask, (state.base.cursor + rank) % cap, cap)
    ext = torch.cat([state.priorities, state.priorities[:1]])
    ext[slots] = (state.max_priority ** state.alpha).expand(n)
    return replace(state, base=rp.add_batch(state.base, items, mask),
                   priorities=ext[:cap])


def per_sample(state: PERState, generator: torch.Generator, batch_size: int,
               beta: float):
    """Stratified proportional sampling and importance weights; returns
    ``(batch, idx, weights)``.  The B uniforms come from ``generator``."""
    cap = rp.replay_capacity(state.base)
    dev = state.priorities.device
    filled = torch.clamp(state.base.cursor, max=cap)
    valid = torch.arange(cap, device=dev) < filled
    p = torch.where(valid, state.priorities, 0.0)
    total = torch.sum(p)
    cdf = torch.cumsum(p, 0)
    u = (torch.arange(batch_size, dtype=torch.float32, device=dev)
         + torch.rand(batch_size, generator=generator, device=dev)
         ) / batch_size * total
    idx = torch.clamp(torch.searchsorted(cdf, u, right=True), 0, cap - 1)
    probs = p[idx] / total
    n = filled.to(torch.float32)
    weights = (probs * n) ** (-beta)
    p_min = torch.min(torch.where(valid, p, torch.inf)) / total
    weights = weights / (p_min * n) ** (-beta)
    return rp.gather(state.base, idx), idx, weights.to(torch.float32)


def per_update_priorities(state: PERState, idx: torch.Tensor,
                          priorities: torch.Tensor) -> PERState:
    """Set new (pre-alpha) priorities at ``idx`` (ranbowdqn.py:417-437);
    with repeated indices one of the writes wins, as in JAX."""
    priorities = torch.clamp(priorities.to(torch.float32), min=1e-8)
    new = state.priorities.clone()
    new[idx] = priorities ** state.alpha
    return replace(state, priorities=new,
                   max_priority=torch.maximum(state.max_priority,
                                              torch.max(priorities)))


def per_can_learn(state: PERState, min_fill: int) -> torch.Tensor:
    return state.base.cursor > min_fill
