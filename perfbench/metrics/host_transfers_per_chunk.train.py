"""Blocking transfers between host and card per chunk: the spans
``mgt.readback`` and ``mgt.upload`` of the profiled sub-window over its
calls (a count the program makes, the same in every run)."""

from perfbench import spans


def read(run):
    return spans.count_per_call(run.trace, ("mgt.readback", "mgt.upload"))
