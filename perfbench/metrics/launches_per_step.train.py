"""The program's ``kernels.launch_counts`` over the window, divided by the
steps the window ran (env-steps over envs)."""


def read(run):
    w, cell = run.window, run.cell
    steps = w.units / cell.n
    return sum(w.launches.values()) / steps if steps else None
