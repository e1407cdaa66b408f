"""Offline analysis of experiment logs and training curves.

Counterpart of ``merging_gym_tpu/io/analysis.py`` (numpy and matplotlib,
no torch).  Programmatic replacement for the reference's analysis notebook
(scripts/data/data_analysis.ipynb, cells 0-16): parses the per-episode
14-column trajectory CSVs written by the human harness, groups them by
condition tag, and produces the same figures -- per-subject reward
curves, collision counts (the notebook's ``score < -7`` heuristic, cell
6), utility mean +/- SEM bars, x-t trajectory error bands, and velocity
bars -- and the 4-panel training curves of a run.  Figures save as PNGs;
matplotlib is imported when a figure is drawn, with the Agg backend;
everything also returns plain arrays so the analysis is scriptable.
"""

from __future__ import annotations

import csv
import json
import os
from collections import defaultdict

import numpy as np

COLLISION_SCORE_THRESHOLD = -7.0  # notebook cell 6 heuristic


def load_episode(path: str) -> dict:
    """Parse one episode CSV -> dict of column arrays."""
    with open(path) as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [r for r in reader if r]
    data = np.array([[float(v) if v != "" else np.nan for v in r] for r in rows])
    if data.size == 0:
        data = np.zeros((0, len(header)))
    return {
        "obs": data[:, :10],
        "action1": data[:, 10] if data.shape[1] > 10 else np.array([]),
        "action2": data[:, 11] if data.shape[1] > 11 else np.array([]),
        "reward1": data[:, 12] if data.shape[1] > 12 else np.array([]),
        "reward2": data[:, 13] if data.shape[1] > 13 else np.array([]),
        "path": path,
    }


def load_session(log_dir: str) -> list[dict]:
    """Load all episode CSVs of one session directory, sorted by index."""
    files = [f for f in os.listdir(log_dir) if f.startswith("episode")]
    files.sort(key=lambda f: int(f.split(" ")[0].removeprefix("episode")))
    return [load_episode(os.path.join(log_dir, f)) for f in files]


def episode_stats(ep: dict) -> dict:
    """Scalars per episode: ego return, collision flag, mean velocity,
    distance-to-go trajectory."""
    score = float(np.nansum(ep["reward1"]))
    return {
        "score": score,
        "collision": score < COLLISION_SCORE_THRESHOLD,
        "mean_vel": float(np.nanmean(ep["obs"][:, 4])) if len(ep["obs"]) else 0.0,
        "steps": len(ep["obs"]),
        "x_to_go": ep["obs"][:, 3],
    }


def session_summary(log_dir: str) -> dict:
    eps = [episode_stats(e) for e in load_session(log_dir)]
    scores = np.array([e["score"] for e in eps])
    return {
        "episodes": len(eps),
        "scores": scores,
        "mean_score": float(scores.mean()) if len(eps) else 0.0,
        "sem_score": float(scores.std(ddof=1) / np.sqrt(len(eps))) if len(eps) > 1 else 0.0,
        "collisions": int(sum(e["collision"] for e in eps)),
        "mean_vel": float(np.mean([e["mean_vel"] for e in eps])) if eps else 0.0,
    }


def group_sessions(root: str, tag_fn=None) -> dict:
    """Group session dirs under ``root`` by condition tag (the notebook's
    Pre_low / Pre_L2 / Formal_* grouping, cells 8-11).  ``tag_fn`` maps a
    session dir name to a tag; default: the whole name."""
    tag_fn = tag_fn or (lambda name: name)
    groups = defaultdict(list)
    for name in sorted(os.listdir(root)):
        full = os.path.join(root, name)
        if os.path.isdir(full):
            groups[tag_fn(name)].append(session_summary(full))
    return dict(groups)


# --------------------------------------------------------------------------
# Figures (matplotlib imported lazily; Agg backend safe)
# --------------------------------------------------------------------------

def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_reward_curves(log_dir: str, out_path: str | None = None):
    """Per-episode ego return curve for one session (notebook cell 5)."""
    plt = _plt()
    summary = session_summary(log_dir)
    fig, ax = plt.subplots()
    ax.plot(summary["scores"], "g.-")
    ax.axhline(COLLISION_SCORE_THRESHOLD, color="r", ls="--", lw=0.8,
               label="collision threshold")
    ax.set_xlabel("episode")
    ax.set_ylabel("ego return")
    ax.legend()
    out_path = out_path or os.path.join(log_dir, "reward_curve.png")
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_utility_bars(groups: dict, out_path: str):
    """Mean +/- SEM utility per condition (notebook cell 9)."""
    plt = _plt()
    tags = list(groups)
    means = [np.mean([s["mean_score"] for s in groups[t]]) for t in tags]
    sems = [np.std([s["mean_score"] for s in groups[t]], ddof=1) /
            max(np.sqrt(len(groups[t])), 1) if len(groups[t]) > 1 else 0.0
            for t in tags]
    fig, ax = plt.subplots()
    ax.bar(range(len(tags)), means, yerr=sems, capsize=4)
    ax.set_xticks(range(len(tags)), tags, rotation=30, ha="right")
    ax.set_ylabel("mean episode utility")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_xt_trajectories(log_dir: str, out_path: str | None = None):
    """x-t error-band plot of distance-to-go (notebook cell 10)."""
    plt = _plt()
    eps = load_session(log_dir)
    fig, ax = plt.subplots()
    max_len = max((len(e["obs"]) for e in eps), default=0)
    if max_len:
        padded = np.full((len(eps), max_len), np.nan)
        for i, e in enumerate(eps):
            padded[i, :len(e["obs"])] = e["obs"][:, 3]
        mean = np.nanmean(padded, axis=0)
        std = np.nanstd(padded, axis=0)
        t = np.arange(max_len) * 0.2
        ax.plot(t, mean, "b-")
        ax.fill_between(t, mean - std, mean + std, alpha=0.3)
    ax.set_xlabel("time [s]")
    ax.set_ylabel("distance to merge point [m]")
    out_path = out_path or os.path.join(log_dir, "xt_trajectories.png")
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


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


def plot_velocity_bars(groups: dict, out_path: str):
    """Mean ego velocity per condition (notebook cell 11)."""
    plt = _plt()
    tags = list(groups)
    vels = [np.mean([s["mean_vel"] for s in groups[t]]) for t in tags]
    fig, ax = plt.subplots()
    ax.bar(range(len(tags)), vels)
    ax.set_xticks(range(len(tags)), tags, rotation=30, ha="right")
    ax.set_ylabel("mean ego velocity [m/s]")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
