"""Tracing / profiling utilities.

Counterpart of ``merging_gym_tpu/utils/profiling.py``.  The reference has
no profiling at all (SURVEY.md section 5) -- its only timing construct is
the 50 ms render pacing.  Here:

* :func:`trace` -- context manager around ``torch.profiler`` writing a
  TensorBoard-viewable trace (``*.pt.trace.json``: host ops and, once
  CUDA is initialised, the card's kernels);
* :class:`ThroughputTimer` -- items/s over intervals fenced by
  synchronising the devices of the given tensors;
* :func:`time_fn` -- warm-up-then-time helper, on CUDA events where the
  output lies on the card;
* :func:`span` -- a named ``record_function`` span of the program's own
  host phases, entered only while a ``torch.profiler`` runs (the
  profiler is the switch: no flag or setting turns spans on), so it
  lands in the profiler's trace on the clock of the card's intervals.

Span names: ``mgt.<layer>.<phase>`` for a phase of a layer's host path
(``mgt.chunk.prologue``, ``mgt.chunk.issue`` and ``mgt.chunk.fold`` of
the fused trainers K5, K8 and K9, and ``mgt.chunk.graph`` inside K5's issue
around each replay of its chunk graph; ``mgt.eval.prologue``,
``mgt.eval.rollout`` and ``mgt.eval.outcomes`` of
``agents.evaluate.evaluate_fused``), and two names without a layer, one
span per transfer, nested in the phase that makes it: ``mgt.readback``
around each blocking read of the card into host memory (``.tolist()``,
``.item()``, ``float`` of a tensor) and ``mgt.upload`` around each copy
from host memory to the card.  No span wraps a single kernel launch:
``kernels.launch_counts`` counts those.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch import profiler


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace into ``log_dir`` (view with
    TensorBoard's profile plugin or chrome://tracing); yields the
    profiler, whose ``key_averages()`` sums the events by name."""
    activities = [profiler.ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        activities.append(profiler.ProfilerActivity.CUDA)
    with profiler.profile(
            activities=activities,
            on_trace_ready=profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler runs,
    else one shared null context: outside a profile a span costs one
    check of the profiler's state (a fraction of a microsecond)."""
    if torch.autograd._profiler_enabled():
        return profiler.record_function(name)
    return _NO_SPAN


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _cuda_devices(*trees) -> set:
    return {t.device for tree in trees for t in _tensors(tree)
            if t.device.type == "cuda"}


def _synchronize(*trees) -> None:
    """Wait for the work of every card that holds a tensor of ``trees``
    (CPU tensors are ready when they are returned)."""
    for dev in _cuda_devices(*trees):
        torch.cuda.synchronize(dev)


class ThroughputTimer:
    """Accumulate (items, seconds) intervals; report items/s."""

    def __init__(self):
        self.items = 0
        self.seconds = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, items: int, *sync_tensors):
        _synchronize(*sync_tensors)
        if self._t0 is None:
            raise RuntimeError("ThroughputTimer.stop without start")
        self.seconds += time.perf_counter() - self._t0
        self.items += items
        self._t0 = None

    @property
    def per_second(self) -> float:
        return self.items / self.seconds if self.seconds else 0.0


def time_fn(fn, *args, iters: int = 5, warmup: int = 1):
    """Warm up, then time ``fn(*args)``; returns (mean_seconds,
    last_output).  Where the output lies on the card the time is that of
    CUDA events around the ``iters`` calls on the current stream;
    otherwise it is the host clock."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    devs = _cuda_devices(out)
    _synchronize(out)
    if len(devs) == 1:
        dev = devs.pop()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(dev))
        for _ in range(iters):
            out = fn(*args)
        end.record(torch.cuda.current_stream(dev))
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters, out
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _synchronize(out)
    return (time.perf_counter() - t0) / iters, out
