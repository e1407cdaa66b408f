"""Median over the profiled sub-window's chunks of the host's time in the
chunk's prologue: the span ``mgt.chunk.prologue`` of K5's and K8's
``chunk_state``, from the call to the first launch (argument checks, the
host's sample draws, the working copies, the learner's workspace and
geometry, the uploads; in K8 also ``_sync_start``'s read-backs)."""

from perfbench import spans


def read(run):
    return spans.median_per_call_ms(run.trace, "mgt.chunk.prologue")
