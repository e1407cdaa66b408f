"""A run over several processes: every trainer family of ``parallel.spmd``
and a checkpoint round trip, one OS process per rank.

Counterpart of ``examples/multiprocess_dryrun.py``.  Start one process
per rank on one host, all with the same ``WORLD`` and ``PORT``::

    python -m merging_gym_tpu_torch.parallel.dryrun RANK WORLD PORT [--cpu]

Each rank joins the run through ``parallel.multihost.initialize`` at
``localhost:PORT``: on the card ``cuda:<rank % cards>`` under NCCL, or
gloo on ``cuda:0`` where there are more ranks than cards (NCCL refuses a
second rank on a card); with ``--cpu``, gloo on the CPU and the kernels'
plain versions.  Without a card and without ``--cpu`` it raises: nothing
falls back.  The sections, in the JAX example's order and with its tags:

* ``OK``: the ``(data, model)`` DQN step loop (``model`` 2 for an even
  world), 3 chunks of 3 steps at 4 envs a data rank;
* ``FUSED``, ``RAINBOW``, ``HDQN``, ``DRQN``: K5, K8, K7 and K9 under
  local SGD, a few greedy steps at 128 lanes a rank;
* ``CKPT``: the step loop's carry saved (a file a rank, committed by rank
  0), continued for 2 chunks, restored and continued again; the two runs
  must agree bit for bit.

Each section prints ``PROC<rank> <TAG> env_steps=<n>
params_checksum=<x>``: the global env-steps and the sum of the absolute
values of the replicated (for the fused trainers, the averaged)
parameters, which every rank must print alike.  Last, ``PROC<rank>
LAUNCHES {...}``: the rank's kernel launches (all 0 with ``--cpu``).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import shutil
import sys
import tempfile

import torch
import torch.distributed as dist

from merging_gym_tpu_torch import kernels
from merging_gym_tpu_torch.agents import dqn as D
from merging_gym_tpu_torch.agents.drqn import DRQNConfig
from merging_gym_tpu_torch.agents.hdqn import HDQNConfig
from merging_gym_tpu_torch.agents.rainbow import RainbowConfig
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.io.checkpoint import CheckpointManager, state_tree
from merging_gym_tpu_torch.parallel import mesh as M
from merging_gym_tpu_torch.parallel import multihost, spmd

LANES = 128        # lanes a rank of the fused trainers
LOOP_ENVS = 4      # envs a data rank of the step loop
TAGS = ("OK", "FUSED OK", "RAINBOW OK", "HDQN OK", "DRQN OK", "CKPT OK")


def place(rank: int, world: int, cpu: bool) -> tuple:
    """``(device, backend)`` of ``rank`` in a world of ``world`` ranks on
    this host."""
    if cpu:
        return "cpu", "gloo"
    cards = torch.cuda.device_count()
    if world > cards:
        return "cuda:0", "gloo"
    return f"cuda:{rank}", "nccl"


def checksum(tensors, group=None) -> float:
    """The sum of ``|x|`` over ``tensors`` in f64, each tensor's sum taken
    over ``group`` first (the shards of a tensor-parallel layer)."""
    sums = torch.stack([t.detach().abs().to(torch.float64).sum()
                        for t in tensors])
    if group is not None:
        sums = M.psum(sums, group)
    return float(sums.sum())


def tree_equal(a, b, path="carry") -> None:
    """Raise unless two :func:`state_tree` trees agree bit for bit."""
    if isinstance(a, torch.Tensor):
        if not (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b)):
            raise AssertionError(f"{path}: restored run differs")
    elif isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"{path}: keys differ")
        for k in a:
            tree_equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            tree_equal(x, y, f"{path}[{i}]")
    elif a != b:
        raise AssertionError(f"{path}: {a} != {b}")


def loop_checksum(carry, mesh) -> float:
    """The step loop's params: fc0 and fc1's weight are split over the
    model ranks, the rest replicated."""
    leaves = D._leaves(carry.dqn.params)
    if M.axis_size(mesh, "model") == 1:
        return checksum(leaves)
    return checksum(leaves[:3], mesh.get_group("model")) + checksum(
        leaves[3:])


def run(rank: int, world: int, port: int, cpu: bool = False,
        ckpt_root: str | None = None) -> None:
    """Every section on this rank, each printing its line."""
    # Every rank is on this host: gloo's pairs over the loopback.
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    device, backend = place(rank, world, cpu)
    dev = multihost.initialize(f"localhost:{port}", world, rank,
                               device=device, backend=backend,
                               timeout=datetime.timedelta(seconds=300))

    def report(tag, steps, csum):
        print(f"PROC{rank} {tag} env_steps={steps} "
              f"params_checksum={csum:.6f}", flush=True)

    try:
        ep = EnvParams()
        tp = 2 if world % 2 == 0 else 1
        mesh = M.make_mesh(model=tp)
        dp = M.axis_size(mesh, "data")
        cfg = D.DQNConfig(memory_capacity=16, batch_size=8,
                          opponent=D.OPP_SELFPLAY)
        carry = spmd.spmd_train_init(0, cfg, ep, dp * LOOP_ENVS, mesh,
                                     device=dev)
        for _ in range(3):
            carry = spmd.spmd_train_chunk(mesh, cfg, ep, carry, 3)
        steps = int(carry.metrics.env_steps)
        assert steps == 9 * dp * LOOP_ENVS, steps
        report(TAGS[0], steps, loop_checksum(carry, mesh))

        dmesh = M.make_mesh(data=world, model=1)
        n, cap = world * LANES, 2 * world * LANES
        fcfg = D.DQNConfig(memory_capacity=cap, opponent=D.OPP_SELFPLAY)
        fc = spmd.spmd_fused_dqn_init(3, fcfg, ep, n, dmesh, device=dev)
        for s in range(2):
            fc = spmd.spmd_fused_dqn_chunk(dmesh, fcfg, ep, fc, 3, seed=s,
                                           greedy=True)
        assert fc["env_steps"] == 6 * n, fc["env_steps"]
        report(TAGS[1], fc["env_steps"], checksum(fc["p"]))

        rcfg = RainbowConfig(memory_capacity=cap, obs_scale=0.01,
                             opponent=D.OPP_SELFPLAY)
        rc = spmd.spmd_fused_rainbow_init(5, rcfg, ep, n, dmesh, device=dev)
        rc = spmd.spmd_fused_rainbow_chunk(dmesh, rcfg, ep, rc, 3, seed=0,
                                           greedy=True)
        assert rc["env_steps"] == 3 * n, rc["env_steps"]
        report(TAGS[2], rc["env_steps"], checksum([rc["p"]]))

        hcfg = HDQNConfig(memory_capacity=cap, goal_memory_capacity=cap,
                          opponent=D.OPP_SELFPLAY)
        hc = spmd.spmd_fused_hdqn_init(7, hcfg, ep, n, dmesh, device=dev)
        hc = spmd.spmd_fused_hdqn_chunk(dmesh, hcfg, ep, hc, 3, seed=0,
                                        greedy=True)
        assert hc["env_steps"] == 3 * n, hc["env_steps"]
        report(TAGS[3], hc["env_steps"],
               checksum(list(hc["u_p"]) + list(hc["l_p"])))

        dcfg = DRQNConfig(memory_capacity=cap, seq_len=3, burn_in=1,
                          opponent=D.OPP_SELFPLAY)
        dc = spmd.spmd_fused_drqn_init(9, dcfg, ep, n, dmesh, device=dev)
        dc = spmd.spmd_fused_drqn_chunk(dmesh, dcfg, ep, dc, 6, seed=0,
                                        greedy=True)
        assert dc["env_steps"] == 6 * n, dc["env_steps"]
        report(TAGS[4], dc["env_steps"], checksum([dc["p"]]))

        # The step loop's carry saved, continued, restored and continued.
        directory = os.path.join(ckpt_root or tempfile.gettempdir(),
                                 f"mgt_torch_dryrun_{port}")
        if rank == 0:
            shutil.rmtree(directory, ignore_errors=True)
        dist.barrier()
        mgr = CheckpointManager(directory, max_to_keep=1)
        assert mgr.save(0, carry)
        cont = carry
        for _ in range(2):
            cont = spmd.spmd_train_chunk(mesh, cfg, ep, cont, 3)
        want = state_tree(cont)
        restored = mgr.restore(carry)
        for _ in range(2):
            restored = spmd.spmd_train_chunk(mesh, cfg, ep, restored, 3)
        tree_equal(state_tree(restored), want)
        mgr.close()
        dist.barrier()
        if rank == 0:
            shutil.rmtree(directory, ignore_errors=True)
        report(TAGS[5], int(restored.metrics.env_steps),
               loop_checksum(restored, mesh))
        print(f"PROC{rank} LAUNCHES {json.dumps(kernels.launch_counts)}",
              flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m merging_gym_tpu_torch.parallel.dryrun",
        description="One rank of a run of every parallel trainer.")
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port", type=int, nargs="?", default=13557)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo on the CPU, the kernels' plain versions")
    ap.add_argument("--ckpt-dir", default=None,
                    help="where the CKPT section writes (default: the "
                         "temporary directory)")
    args = ap.parse_args(argv)
    run(args.rank, args.world, args.port, args.cpu, args.ckpt_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
