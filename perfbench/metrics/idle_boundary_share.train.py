"""The share of the profiled sub-window in which the device was idle and
the host was outside every launch loop (``mgt.chunk.issue``): the idle at
the chunks' boundaries (prologue, fold, the harness's read-back between
calls).  ``idle_share.train`` less this is the idle inside the launch
loops."""

from perfbench import spans


def read(run):
    return spans.idle_outside_share(run.trace, "mgt.chunk.issue")
