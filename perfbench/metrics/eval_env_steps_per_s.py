"""Env-steps (envs x steps) of every matchup the window completed, over the window: from the
first matchup's call to a synchronize after the last (host clock)."""


def read(run):
    w = run.window
    return w.units / w.seconds if w.units else None
