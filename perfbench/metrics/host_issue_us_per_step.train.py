"""The host's time in the chunks' launch loops (the spans
``mgt.chunk.issue`` of ``launch_trainer`` and ``launch_rainbow``, from the
first launch to the last) summed over the profiled sub-window, over the
steps they ran (calls times ``chunk_steps``)."""

from perfbench import spans


def read(run):
    t, cell = run.trace, run.cell
    total = spans.total_us(t, "mgt.chunk.issue")
    if total is None or not t.calls:
        return None
    return total / (t.calls * cell.T)
