"""Sums, means, minimums and maximums over a process group, the JAX
package's ``psum`` / ``pmean`` / ``pmin`` / ``pmax`` over one mesh axis
inside ``shard_map``, and a broadcast from the group's first rank (where
the JAX package keeps a value replicated by drawing it from a stream
that every device shares).

Each is one ``torch.distributed.all_reduce`` (or ``broadcast``) of the
tensors as a flat buffer, on the tensors' device with no read-back.  A
mean is a sum divided by the group's size, never the backend's own
average, which gloo and NCCL compute differently; every rank receives the
same reduced bits, so replicas stay bitwise equal, and over a group of
one rank each is the identity.  The learners (``agents.dqn.learn``,
``agents.hdqn``, ``agents.rainbow``, ``agents.drqn``) take a group from
``parallel.spmd``; ``parallel.mesh`` re-exports these.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _flat(tensors, collective):
    """``collective`` on same-dtype tensors as one flat buffer; new
    tensors."""
    single = isinstance(tensors, torch.Tensor)
    ts = [tensors] if single else list(tensors)
    flat = torch.cat([t.detach().reshape(-1) for t in ts])
    collective(flat)
    out, i = [], 0
    for t in ts:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out[0] if single else out


def _reduce(tensors, group, op):
    return _flat(tensors, lambda flat: dist.all_reduce(flat, op=op,
                                                       group=group))


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


def pmax(tensor, group):
    return _reduce(tensor, group, dist.ReduceOp.MAX)


def broadcast(tensors, group):
    """The tensors of ``group``'s first rank, on every rank of it (a tensor
    or a list of same-dtype tensors)."""
    src = dist.get_global_rank(group, 0)
    return _flat(tensors, lambda flat: dist.broadcast(flat, src=src,
                                                      group=group))
