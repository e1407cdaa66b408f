"""A world of gloo ranks on the CPU for the port's parallel tests.

A test module starts one :class:`World` (a module-scoped fixture) and
hands it tasks by name; every rank runs the task and returns its result,
and ``World.run`` gives the results in rank order.  Ranks are spawned
processes that import only torch and the port (never JAX), rendezvous
through a ``FileStore`` in the test's temporary directory (no port to
race for under xdist), and run with one torch thread.  A rank that raises
fails the test with its traceback, and the world is restarted for the
next one: the other ranks may be blocked in a collective.

The rank-side tasks live in ``tests/torch_world_tasks.py``.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import traceback

TASKS = "tests.torch_world_tasks"
COLLECTIVE_TIMEOUT_S = 60


def _serve(rank, world, init_file, tasks, results):
    os.environ["OMP_NUM_THREADS"] = "1"
    import datetime
    import importlib

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from merging_gym_tpu_torch.parallel import multihost

    multihost.initialize(
        "file://" + init_file, world, rank, device="cpu",
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    module = importlib.import_module(TASKS)
    while True:
        job = tasks.get()
        if job is None:
            break
        name, args = job
        try:
            results.put((rank, None, getattr(module, name)(*args)))
        except Exception:
            results.put((rank, traceback.format_exc(), None))
    dist.destroy_process_group()


class World:
    """``size`` spawned gloo ranks, fed tasks of ``torch_world_tasks``."""

    def __init__(self, size: int, directory):
        self.size = size
        self.directory = str(directory)
        self.starts = 0
        self._start()

    def _start(self):
        ctx = multiprocessing.get_context("spawn")
        self.starts += 1
        init_file = os.path.join(self.directory, f"store{self.starts}")
        self.tasks = [ctx.Queue() for _ in range(self.size)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, self.size, init_file,
                                        self.tasks[r], self.results))
                      for r in range(self.size)]
        for p in self.procs:
            p.start()
        self.broken = False

    def run(self, name: str, *args, timeout: float = 180.0) -> list:
        """Run task ``name(*args)`` on every rank; results in rank order."""
        if self.broken:
            self.close()
            self._start()
        for q in self.tasks:
            q.put((name, args))
        out, errors = [None] * self.size, []
        try:
            for _ in range(self.size):
                rank, err, res = self.results.get(timeout=timeout)
                if err is not None:
                    errors.append(f"rank {rank}:\n{err}")
                out[rank] = res
        except queue.Empty:
            errors.append(f"{name}: no answer from every rank in {timeout} "
                          "s\n" + "".join(traceback.format_stack(limit=3)))
        if errors:
            self.broken = True
            raise AssertionError("\n".join(errors))
        return out

    def close(self):
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=10 if not self.broken else 0.1)
            if p.is_alive():
                p.kill()
                p.join()


def assert_results_equal(a, b, path="result"):
    """Two results of :meth:`World.run` (dicts, tuples, lists, numpy
    arrays and scalars) bit for bit."""
    import numpy as np

    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_results_equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_results_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, path)
    else:
        assert a == b, path
