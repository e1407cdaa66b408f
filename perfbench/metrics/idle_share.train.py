"""The device's idle share of the profiled sub-window: one less the union
of its kernel, copy and fill intervals over the sub-window's length."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
