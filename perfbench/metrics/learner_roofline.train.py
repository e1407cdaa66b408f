"""The learner kernels' share of their bound: per learn, the least time of
the learner's operations and bytes at this cell's batch, with Adam
(``reference/counts.py``), over the kernels' device time per learn in the
profiled sub-window.  A learn is one launch of the forward/backward
kernel."""


def read(run):
    t, cell = run.trace, run.cell
    if t is None:
        return None
    secs, _ = t.device_time_s(
        lambda n: any(k in n for k in cell.learner_kernels))
    _, learns = t.device_time_s(lambda n: cell.learner_kernels[0] in n)
    if not learns or secs <= 0:
        return None
    return 100.0 * learns * cell.learn_bound_s() / secs
