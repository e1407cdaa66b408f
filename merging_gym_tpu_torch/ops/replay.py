"""Uniform replay: a fixed-shape ring buffer of tensors on the device.

Counterpart of ``merging_gym_tpu/ops/replay.py``.  The reference's
host-side numpy ring (main.py:92,115-119) becomes device tensors updated
by masked scatters, so actor -> replay -> learner never leaves the card
and nothing is read back to decide a write.

Reference semantics preserved:
* ring overwrite at ``cursor % capacity`` (main.py:117-118);
* sampling uniform *with replacement over the full capacity* regardless
  of fill (main.py:130), safe because learning starts only once the
  buffer is full (:func:`can_learn`, main.py:213);
* the store-gating mask (transitions dropped once the ego has won,
  main.py:209-210) is the ``mask`` argument of :func:`add_batch`.

Functions return a new :class:`ReplayState` and leave their input as it
was, as the JAX functions do.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class ReplayState:
    data: dict             # field -> [capacity, ...] tensor
    cursor: torch.Tensor   # int64 0-d: number of accepted writes


def replay_init(capacity: int, example_item: dict, device=None) -> ReplayState:
    """A zeroed buffer of ``capacity`` items shaped like ``example_item``
    (a dict of tensors), on ``device`` (default: the items' device)."""
    data = {}
    for k, x in example_item.items():
        x = torch.as_tensor(x)
        data[k] = torch.zeros((capacity,) + tuple(x.shape), dtype=x.dtype,
                              device=device or x.device)
    dev = next(iter(data.values())).device
    return ReplayState(data=data,
                       cursor=torch.zeros((), dtype=torch.int64, device=dev))


def replay_capacity(state: ReplayState) -> int:
    return next(iter(state.data.values())).shape[0]


def add_batch(state: ReplayState, items: dict, mask=None) -> ReplayState:
    """Append a batch (leading axis = batch), optionally masked.

    Masked-out items are dropped without consuming a slot
    (main.py:209-210); kept items take slots ``cursor + rank`` modulo the
    capacity, ``rank = cumsum(mask) - 1``, in batch order.
    """
    cap = replay_capacity(state)
    n = next(iter(items.values())).shape[0]
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=state.cursor.device)
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    # Dropped items go to a spare row ``cap`` that is cut off afterwards.
    slots = torch.where(mask, (state.cursor + rank) % cap, cap)
    data = {}
    for k, buf in state.data.items():
        ext = torch.cat([buf, buf[:1]])
        ext[slots] = items[k].to(buf.dtype)
        data[k] = ext[:cap]
    return ReplayState(data=data, cursor=state.cursor + mask.sum())


def can_learn(state: ReplayState) -> torch.Tensor:
    """Learning gate: buffer filled once (main.py:213-214)."""
    return state.cursor >= replay_capacity(state)


def can_learn_valid(state: ReplayState, batch_size: int) -> torch.Tensor:
    """Corrected-mode gate: learn as soon as one batch is stored."""
    return state.cursor >= batch_size


def gather(state: ReplayState, idx: torch.Tensor) -> dict:
    """The items at slots ``idx``."""
    return {k: buf[idx] for k, buf in state.data.items()}


def sample(state: ReplayState, generator: torch.Generator,
           batch_size: int):
    """Uniform with replacement over the full capacity (main.py:130).
    Returns ``(batch, idx)``; draws from ``generator`` (on the buffer's
    device)."""
    idx = torch.randint(0, replay_capacity(state), (batch_size,),
                        generator=generator, device=state.cursor.device)
    return gather(state, idx), idx


def sample_valid(state: ReplayState, generator: torch.Generator,
                 batch_size: int):
    """Uniform over the filled slots (the correctness-minded variant; the
    reference's Rainbow buffer samples this way, ranbowdqn.py:322)."""
    filled = torch.clamp(state.cursor, 1, replay_capacity(state))
    u = torch.rand(batch_size, generator=generator, dtype=torch.float64,
                   device=state.cursor.device)
    idx = torch.minimum((u * filled).to(torch.int64), filled - 1)
    return gather(state, idx), idx
