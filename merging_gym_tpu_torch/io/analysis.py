"""Training curves of a run directory.

Counterpart of ``plot_training_curves`` and ``_plt`` in
``merging_gym_tpu/io/analysis.py``; matplotlib is imported when a figure
is drawn, with the Agg backend.  The rest of that module reads the
trajectory logs of ``play`` sessions and comes with ``play``.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_training_curves(run_dir: str, out_name: str = "curves.png"):
    """4-panel training figure -- reward, loss, collision rate, win rate --
    from a run's scalars.jsonl, mirroring the reference's live matplotlib
    panel and saved curve PNGs (main.py:176-242)."""
    plt = _plt()
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    if not rows:
        return None
    fig, ax = plt.subplots(4, 1, figsize=(7, 10), sharex=True)
    x = [r["step"] for r in rows]

    def series(key):
        return [r.get(key, np.nan) for r in rows]

    ax[0].plot(x, series("reward"), "g-", label="reward")
    ax[1].plot(x, series("loss"), "b-", label="loss")
    ax[2].plot(x, series("collision_rate"), "k-", label="collision_rate")
    ax[3].plot(x, series("win_rate"), "k-", label="win_rate")
    for a in ax:
        a.legend(loc="best")
    ax[3].set_xlabel("chunk")
    out_path = os.path.join(run_dir, out_name)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
