"""Per-episode CSV trajectory logging, byte-compatible with the reference.

Counterpart of ``merging_gym_tpu/io/trajectory.py`` (plain Python and
numpy; :func:`dump_batch_trajectories` reads the port's
``core.vector.rollout`` ``TimeStep``, on the card or the CPU).

The human-experiment harness writes one CSV per episode with 14 columns
-- the 10 observation components, both actions and both rewards -- under
``log/<timestamp>/`` (human_player.py:50-53,108-111,180-181), and the
analysis notebook (scripts/data/data_analysis.ipynb) parses exactly that
layout.  This module reproduces the header verbatim and the
rows-only-until-ego-finishes gating so existing notebooks keep working.
"""

from __future__ import annotations

import csv
import datetime
import os

import numpy as np

# Verbatim header row (human_player.py:111).
HEADER = [
    "x2 - x1", "y2 - y1", "self.state2['vel'] - self.state1['vel']",
    "END_POINT - self.state1['pos']", "self.state1['vel']",
    "x1 - x2", "y1 - y2", "self.state1['vel'] - self.state2['vel']",
    "END_POINT - self.state2['pos']", "self.state2['vel']",
    "action1", "action2", "reward1", "reward2",
]


def make_log_dir(root: str = "log") -> str:
    """``log/<timestamp>/`` (human_player.py:50-53)."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(
        root, datetime.datetime.now().strftime("%Y--%m--%d %H:%M:%S"))
    os.makedirs(path, exist_ok=True)
    return path


class EpisodeLogger:
    """One CSV per episode: ``episode<i> <tag>`` (human_player.py:108)."""

    def __init__(self, log_dir: str, episode: int, tag: str):
        self.path = os.path.join(log_dir, f"episode{episode} {tag}")
        self._file = open(self.path, "w", newline="")
        self._writer = csv.writer(self._file)
        self._writer.writerow(HEADER)

    def log_step(self, obs, action1, action2, rewards, winner) -> None:
        """Append one row; skipped once the ego has won, mirroring
        ``if env.winner is not 1`` (human_player.py:180-181)."""
        if winner == 1:
            return
        a2 = "" if action2 is None else action2
        self._writer.writerow(list(obs) + [action1, a2] + list(rewards))

    def close(self) -> None:
        self._file.close()


def dump_batch_trajectories(log_dir: str, traj, tag: str = "batch",
                            max_episodes: int | None = None,
                            start_obs=None) -> list:
    """Slice a vectorised rollout (``core.vector.rollout``'s ``TimeStep``,
    on any device) into reference-format per-episode CSVs.

    ``traj`` carries stacked TimeSteps f[T, N, ...]; episode boundaries
    are the ``done`` flags.  Reference rows hold the *pre-step*
    observation (human_player.py:181 writes ``state``, i.e. the obs the
    action was chosen from), so row k uses ``traj.obs[k-1]``; the first
    row of each episode uses the reset observation (``start_obs``,
    defaulting to the deterministic start -- pass per-episode values for
    randomised starts).  The L0 sentinel action (-1) is written as the
    empty cell the reference produces for ``None``.  Returns the written
    paths.
    """
    def host(t):
        return t.detach().cpu().numpy()

    obs, rewards, done, winner, actions = (
        host(getattr(traj, f))
        for f in ("obs", "rewards", "done", "winner", "actions"))
    if start_obs is None:
        from merging_gym_tpu_torch.core.env import EnvParams, observe, reset
        start_obs = host(observe(reset(EnvParams(),
                                       device=traj.obs.device))[0])
    T, N = done.shape
    paths = []
    count = 0
    for env_i in range(N):
        start = 0
        for t in np.flatnonzero(done[:, env_i]):
            if max_episodes is not None and count >= max_episodes:
                return paths
            logger = EpisodeLogger(log_dir, count, tag)
            for k in range(start, t + 1):
                pre_obs = start_obs if k == start else obs[k - 1, env_i]
                a2 = int(actions[k, env_i, 1])
                logger.log_step(pre_obs,
                                int(actions[k, env_i, 0]),
                                None if a2 < 0 else a2,
                                rewards[k, env_i],
                                int(winner[k, env_i]))
            logger.close()
            paths.append(logger.path)
            count += 1
            start = t + 1
    return paths
