"""The recurrence's share of K9's learner: the device time of
``drqn::rec_kernel`` (the LSTM recurrence forward and back, one warp a
window and net, the heads and the targets) over that of the learner's
three kernels (``in_kernel``, ``rec_kernel``, ``grad_kernel``) in the
profiled sub-window.  Whether the sequential recurrence or the
input side and gradient sums set the learner's pace."""


def read(run):
    t, cell = run.trace, run.cell
    if t is None:
        return None
    secs, _ = t.device_time_s(
        lambda n: any(k in n for k in cell.learner_kernels))
    rec, _ = t.device_time_s(lambda n: "drqn::rec_kernel" in n)
    return 100.0 * rec / secs if secs > 0 else None
