"""Replays of K5's chunk graph per chunk: the spans ``mgt.chunk.graph``
(one around each replay of ``ops.fused_trainer.ChunkGraph``, inside the
chunk's ``mgt.chunk.issue``) of the profiled sub-window over its calls;
1.0 where every chunk is one replay.  A program without the span reports
nothing."""

from perfbench import spans


def read(run):
    return spans.count_per_call(run.trace, ("mgt.chunk.graph",))
