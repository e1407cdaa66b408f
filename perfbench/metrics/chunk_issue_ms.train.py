"""Median host time of a chunk call over the window: the host loop's
launches and the chunk's own read-back (``fused_*_chunk`` returns only
after its counters are in host memory); the harness adds no sync."""

import statistics


def read(run):
    ms = run.window.ms
    return statistics.median(ms) if ms else None
