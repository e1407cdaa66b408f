"""Array-backed segment trees (sum / min).

Counterpart of ``merging_gym_tpu/ops/segment_tree.py``: the reference's
pointer-walking trees for PER (scripts/ranbowdqn.py:130-262) become one
f32 tensor of ``2 * capacity`` entries (leaves at ``[capacity, 2 *
capacity)``).  Updates are batched: scatter the leaves, then rebuild the
ancestor levels by pairwise reductions.  ``find_prefixsum_idx`` walks a
whole batch of queries down the tree at once, with the reference's
strict ``>`` rule for going left (ranbowdqn.py:240-248).  No runtime path
uses it: ``ops.per`` samples by cumulative sum, with the same
distribution.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def _levels(capacity: int) -> int:
    if capacity <= 0 or capacity & (capacity - 1):
        raise ValueError("capacity must be a power of 2")  # ranbowdqn.py:154
    return capacity.bit_length() - 1


@dataclass
class SegmentTreeState:
    tree: torch.Tensor   # f32[2 * capacity]
    op: str = "sum"

    @property
    def capacity(self) -> int:
        return self.tree.shape[0] // 2

    def leaves(self) -> torch.Tensor:
        return self.tree[self.capacity:]


def tree_init(capacity: int, op: str = "sum", device=None) -> SegmentTreeState:
    neutral = 0.0 if op == "sum" else float("inf")
    return SegmentTreeState(
        tree=torch.full((2 * capacity,), neutral, dtype=torch.float32,
                        device=device), op=op)


def _combine(op: str, a, b):
    return a + b if op == "sum" else torch.minimum(a, b)


def tree_set(state: SegmentTreeState, idx, values) -> SegmentTreeState:
    """Batched leaf update and ancestor rebuild (cf. ranbowdqn.py:196-206);
    indices outside the leaves are dropped."""
    cap = state.capacity
    idx = torch.as_tensor(idx, dtype=torch.int64, device=state.tree.device)
    values = torch.as_tensor(values, dtype=torch.float32,
                             device=state.tree.device).expand(idx.shape)
    keep = (idx >= 0) & (idx < cap)
    tree = state.tree.clone()
    tree[cap + idx[keep]] = values[keep]
    level, pos = tree[cap:], cap
    while pos > 1:
        level = _combine(state.op, level[0::2], level[1::2])
        pos //= 2
        tree[pos:2 * pos] = level
    return SegmentTreeState(tree=tree, op=state.op)


def tree_total(state: SegmentTreeState) -> torch.Tensor:
    """Root reduction over all leaves (ranbowdqn.py:221-223, 259-262)."""
    return state.tree[1]


def find_prefixsum_idx(state: SegmentTreeState, prefixsum) -> torch.Tensor:
    """For each query mass, the highest leaf index whose prefix sum is <=
    the mass (ranbowdqn.py:240-248)."""
    if state.op != "sum":
        raise ValueError("find_prefixsum_idx needs a sum tree")
    mass = torch.atleast_1d(torch.as_tensor(
        prefixsum, dtype=torch.float32, device=state.tree.device))
    idx = torch.ones_like(mass, dtype=torch.int64)
    for _ in range(_levels(state.capacity)):
        left = state.tree[2 * idx]
        go_left = left > mass
        idx = torch.where(go_left, 2 * idx, 2 * idx + 1)
        mass = torch.where(go_left, mass, mass - left)
    return (idx - state.capacity).to(torch.int32)
