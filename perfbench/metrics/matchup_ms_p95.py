"""95th percentile of the host time of every matchup of the window, from
the call to the outcome dict in host memory."""

from perfbench.harness import quantile


def read(run):
    ms = run.window.ms
    return quantile(ms, 95) if len(ms) >= 2 else None
