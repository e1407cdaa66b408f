"""The (data, model) device mesh and its collectives, over torch.distributed.

Counterpart of ``merging_gym_tpu/parallel/mesh.py``.  The JAX package
runs one controller over global arrays; here every rank is a process
that holds only its own part, so a "sharding" is the part of an axis
that this rank keeps, and a collective is an explicit
``torch.distributed.all_reduce`` over one dimension's process group, as
the JAX package's ``psum`` / ``pmean`` / ``pmin`` / ``pmax`` run over one
mesh axis inside ``shard_map``.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the dims
``("data", "model")``; ``mesh.get_group("data")`` and
``mesh.get_group("model")`` carry the collectives.  Ranks ``0 .. data *
model - 1`` form it, row-major (rank ``d * model + m`` sits at ``(d,
m)``), as JAX reshapes its device list.  Importing this module starts no
process group: :func:`merging_gym_tpu_torch.parallel.multihost.initialize`
does.

The collectives are ``ops.collectives``' (re-exported here).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from merging_gym_tpu_torch.ops.collectives import (  # noqa: F401
    broadcast, pmax, pmean, pmin, psum)

DIMS = ("data", "model")


def world_size() -> int:
    """Ranks in the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(data: int | None = None, model: int = 1):
    """A ``(data, model)`` mesh over the current world; ``data`` defaults
    to world size // model.  Its device type is ``cuda`` under NCCL and
    ``cpu`` under gloo (which reduces CUDA tensors as well)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "parallel.multihost.initialize() first")
    world = dist.get_world_size()
    if data is None:
        data = world // model
    assert data * model <= world, (data, model, world)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(data * model).reshape(data, model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=DIMS)


def axis_size(mesh, dim: str) -> int:
    return mesh.size(DIMS.index(dim))


def axis_index(mesh, dim: str) -> int:
    """This rank's coordinate along ``dim`` (the JAX ``axis_index``)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError(f"rank {dist.get_rank()} is not in the mesh")
    return coord[DIMS.index(dim)]


class Sharding(NamedTuple):
    """The part ``index`` of ``parts`` equal parts of a leading axis that
    this rank holds (``parts == 1``: the whole axis, replicated)."""

    index: int
    parts: int

    def rows(self, n: int) -> slice:
        if n % self.parts:
            raise ValueError(f"a leading axis of {n} does not divide over "
                             f"{self.parts} ranks")
        k = n // self.parts
        return slice(self.index * k, (self.index + 1) * k)

    def place(self, x):
        return x[self.rows(x.shape[0])]


def data_sharding(mesh) -> Sharding:
    """Leading axis split over ``data`` (env batch, replay)."""
    return Sharding(axis_index(mesh, "data"), axis_size(mesh, "data"))


def replicated(mesh) -> Sharding:
    return Sharding(0, 1)


def shard_batch(mesh, tree):
    """This rank's rows of every tensor in ``tree`` (a tensor, or dicts,
    tuples and lists of them), whose leading axis is global."""
    part = data_sharding(mesh)

    def go(x):
        if isinstance(x, torch.Tensor):
            return part.place(x)
        if isinstance(x, dict):
            return {k: go(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(go(v) for v in x)
        return x
    return go(tree)
