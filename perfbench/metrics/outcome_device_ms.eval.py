"""Device time per matchup of everything but K6 in the profiled
sub-window: the event buffers' allocation and fills, the outcome
reduction on the card and the read-back."""


def read(run):
    t, cell = run.trace, run.cell
    if t is None or not t.calls or not t.busy_s:
        return None
    secs, _ = t.device_time_s(
        lambda n: not any(k in n for k in cell.policy_kernels))
    return 1e3 * secs / t.calls
