"""Sums, means and minimums over a process group, the JAX package's
``psum`` / ``pmean`` / ``pmin`` over one mesh axis inside ``shard_map``.

Each is one ``torch.distributed.all_reduce`` of the tensors as a flat
buffer, on the tensors' device with no read-back.  A mean is a sum
divided by the group's size, never the backend's own average, which gloo
and NCCL compute differently; every rank receives the same reduced bits,
so replicas stay bitwise equal, and over a group of one rank each is the
identity.  The learners (``agents.dqn.learn``, ``agents.hdqn``) take a
group from ``parallel.spmd``; ``parallel.mesh`` re-exports these.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _reduce(tensors, group, op):
    """All-reduce same-dtype tensors as one flat buffer; new tensors."""
    single = isinstance(tensors, torch.Tensor)
    ts = [tensors] if single else list(tensors)
    flat = torch.cat([t.detach().reshape(-1) for t in ts])
    dist.all_reduce(flat, op=op, group=group)
    out, i = [], 0
    for t in ts:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out[0] if single else out


def psum(tensors, group):
    """Sum over ``group`` of a tensor or a list of same-dtype tensors."""
    return _reduce(tensors, group, dist.ReduceOp.SUM)


def pmean(tensors, group):
    """Mean over ``group``: the sum divided by the group's size."""
    size = dist.get_world_size(group)
    out = psum(tensors, group)
    if isinstance(out, torch.Tensor):
        return out / size
    return [t / size for t in out]


def pmin(tensor, group):
    return _reduce(tensor, group, dist.ReduceOp.MIN)
