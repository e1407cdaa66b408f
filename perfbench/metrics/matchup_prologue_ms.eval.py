"""Median over the profiled sub-window's matchups of the host's time from
the call of ``fused_policy_rollout`` to K6's launch: the span
``mgt.eval.prologue`` (argument checks, the event buffers, the nets cast
or uploaded)."""

from perfbench import spans


def read(run):
    return spans.median_per_call_ms(run.trace, "mgt.eval.prologue")
