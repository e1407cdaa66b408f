"""The whole matchup's share of the card's f32 peak: both nets' forwards
of every env-step (``reference/counts.py:mlp_flops``) of every matchup of
the window, over the window's length."""

from perfbench.reference import counts


def read(run):
    w, cell = run.window, run.cell
    if not w.ms or w.seconds <= 0:
        return None
    flops = len(w.ms) * cell.model_flops_per_call()
    return 100.0 * flops / (w.seconds * counts.F32_FLOPS_PER_S)
