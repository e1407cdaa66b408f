"""Env-steps of every chunk the window completed, over the window: from the
first chunk's call to a synchronize after the last (host clock)."""


def read(run):
    w = run.window
    return w.units / w.seconds if w.units else None
