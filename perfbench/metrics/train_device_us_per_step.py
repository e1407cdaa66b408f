"""Device time of a training step of all the cell's envs: the union of
every kernel, copy and fill interval of the profiled sub-window's chunks
(the act, the env step, the store, the learner, the post and the
read-back), over the steps they ran.  The host's pace does not enter it:
it is what the card needs for the work, and it is what the step costs
once the host keeps up."""


def read(run):
    t, cell = run.trace, run.cell
    if t is None or not t.calls or not t.busy_s:
        return None
    return 1e6 * t.busy_s / (t.calls * cell.T)
