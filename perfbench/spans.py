"""Span arithmetic for the metric readers: the port's own host spans
(``merging_gym_tpu_torch.utils.profiling.span``, named ``mgt.*``) of a
traced run's profiled sub-window (:class:`perfbench.trace.Trace`, whose
``host`` keeps every ``user_annotation``), against the window's calls (the
harness's ``perfbench.call`` spans) and the device's idle stretches
(:meth:`Trace.gaps`).  Spans and device intervals share the profiler's
clock.

Each function returns None where the trace holds no span of the names
asked for: a program without the spans reports nothing, not a zero.
"""

from __future__ import annotations

import statistics

from perfbench.trace import CALL, merged


def intervals(trace, name: str) -> list:
    """``(start_us, end_us)`` of the host spans called ``name`` that start
    inside the sub-window, in order of start."""
    if trace is None:
        return []
    return sorted((s, e) for n, s, e in trace.host
                  if n == name and trace.t0_us <= s <= trace.t1_us)


def per_call_us(trace, name: str):
    """Per call of the sub-window, the summed length of the ``name`` spans
    that start inside it (us)."""
    found = intervals(trace, name)
    if not found:
        return None
    return [sum(e - s for s, e in found if a <= s < b)
            for a, b in intervals(trace, CALL)]


def median_per_call_ms(trace, name: str):
    """The median over the sub-window's calls of :func:`per_call_us`, in
    ms."""
    per_call = per_call_us(trace, name)
    return statistics.median(per_call) / 1e3 if per_call else None


def total_us(trace, name: str):
    """The summed length of the sub-window's ``name`` spans (us)."""
    found = intervals(trace, name)
    return sum(e - s for s, e in found) if found else None


def count_per_call(trace, names):
    """How many spans of any of ``names`` the sub-window holds, over its
    calls."""
    n = sum(len(intervals(trace, name)) for name in names)
    return n / trace.calls if n and trace.calls else None


def idle_outside_share(trace, name: str):
    """The share (%) of the sub-window in which the device was idle and
    the host was outside every ``name`` span (None where the device ran
    nothing, as ``idle_share`` reads)."""
    found = intervals(trace, name)
    if not found or trace.window_s <= 0 or not trace.busy_s:
        return None
    covered = merged(("", s, e) for s, e in found)
    idle = 0.0
    for a, b in trace.gaps():
        idle += b - a - sum(max(0.0, min(b, e) - max(a, s))
                            for s, e in covered)
    return 100.0 * idle / (trace.t1_us - trace.t0_us)
