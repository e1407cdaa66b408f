"""The whole training step's share of the card's f32 peak (67 TFLOP/s,
tensor cores unused, the configurations' precision): the model's
operations of the profiled sub-window's chunks (every env's act forward,
the learner's forward and backward per sampled lane; counted from shapes
in ``reference/counts.py``) over the sub-window's length."""

from perfbench.reference import counts


def read(run):
    t, cell = run.trace, run.cell
    if t is None or t.window_s <= 0 or not t.busy_s:
        return None
    flops = t.calls * cell.model_flops_per_call()
    return 100.0 * flops / (t.window_s * counts.F32_FLOPS_PER_S)
