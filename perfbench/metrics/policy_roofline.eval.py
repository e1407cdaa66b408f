"""K6's share of its bound: the larger of its operations (both forwards,
the env step and the observation per env-step) over 67 TFLOP/s and its
events' bytes over 3.35 TB/s (``reference/counts.py``), over its device
time per launch in the profiled sub-window."""


def read(run):
    t, cell = run.trace, run.cell
    if t is None:
        return None
    secs, launches = t.device_time_s(
        lambda n: any(k in n for k in cell.policy_kernels))
    if not launches or secs <= 0:
        return None
    return 100.0 * launches * cell.policy_bound_s() / secs
