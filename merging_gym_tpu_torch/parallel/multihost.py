"""Process setup for a run over several ranks.

Counterpart of ``merging_gym_tpu/parallel/multihost.py``.  Every rank is
one process running the same program on its own part of the work
(``parallel.spmd``); :func:`initialize` joins it to the others with
``torch.distributed.init_process_group``.  Nothing else changes per
rank: env lanes, replay rings and the metric sums are already expressed
over the ``data`` dimension of the mesh.

Backends: NCCL for a CUDA device, gloo for the CPU.  Without arguments a
rank runs on ``cuda:<LOCAL_RANK>`` under NCCL, and raises where CUDA is
not available: nothing falls back to the CPU or to gloo.  NCCL refuses
two ranks on one card, so a world of several ranks on one card passes
``backend="gloo"`` (gloo reduces CUDA tensors too).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from merging_gym_tpu_torch.device import resolve_device
from merging_gym_tpu_torch.parallel.mesh import make_mesh, world_size


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device=None,
               backend: str | None = None,
               timeout: datetime.timedelta | None = None) -> torch.device:
    """Join this process to the run; returns the rank's device.

    Without ``coordinator_address`` the rank, world size and rendezvous
    come from the environment that ``torchrun`` sets (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``).
    With it, ``host:port`` rendezvous over ``tcp://`` (an address with a
    scheme, such as ``file:///path``, is used as given) with
    ``num_processes`` ranks, this one ``process_id``.  ``device``:
    default ``cuda:<LOCAL_RANK>``, also for a bare ``cuda``; ``backend``:
    default NCCL on CUDA, gloo on the CPU; ``timeout``: how long a
    collective waits for the other ranks (the backend's default if None).
    Call it once per process, before the first collective.
    """
    local = int(os.environ.get("LOCAL_RANK", 0))
    dev = resolve_device(f"cuda:{local}" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL needs a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {} if timeout is None else {"timeout": timeout}
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator_address needs "
                             "num_processes and process_id")
        method = (coordinator_address if "://" in coordinator_address
                  else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=method,
                                world_size=num_processes, rank=process_id,
                                **kw)
    return dev


def is_coordinator() -> bool:
    """True on the rank that owns the writers (metrics, plots): rank 0."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_mesh(model: int = 1):
    """The ``(data, model)`` mesh over every rank of the run."""
    return make_mesh(model=model)


def envs_per_host(num_envs_global: int) -> int:
    """Envs this rank materialises: the global count split over the
    ranks (one device each), the JAX function's rule."""
    n = world_size()
    assert num_envs_global % n == 0, (num_envs_global, n)
    return num_envs_global // n if n > 1 else num_envs_global
