"""Per chunk of the profiled sub-window, the host's time in blocking
reads of the card (the spans ``mgt.readback``: ``_finish``'s two, and in
K8 ``_sync_start``'s two), summed; the median over the chunks."""

from perfbench import spans


def read(run):
    return spans.median_per_call_ms(run.trace, "mgt.readback")
