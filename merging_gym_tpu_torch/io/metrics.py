"""Metrics: scalar logging off the hot path, without JAX.

Copy of ``merging_gym_tpu/io/metrics.py`` for the port.  The reference
logs through tensorboardX scalars and prints; here the trainers' counters
are read back at the end of each chunk and written as

* JSONL (one object per log call) -- machine-readable, append-only;
* a CSV mirror -- notebook-friendly;
* TensorBoard via tensorboardX when it is installed.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Mapping


class MetricsWriter:
    """Append-only scalar writer: JSONL + CSV (+ tensorboardX if present)."""

    def __init__(self, log_dir: str):
        self.log_dir = os.path.abspath(log_dir)
        os.makedirs(self.log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.log_dir, "scalars.jsonl"), "a")
        self._csv_path = os.path.join(self.log_dir, "scalars.csv")
        self._csv_file = None
        self._csv_writer = None
        self._csv_fields = None
        self._tb = None
        try:  # optional
            from tensorboardX import SummaryWriter  # type: ignore
            self._tb = SummaryWriter(log_dir=self.log_dir)
        except Exception:
            pass
        self._t0 = time.time()

    def log(self, step: int, scalars: Mapping[str, float]) -> None:
        row = {"step": int(step), "wall_time": round(time.time() - self._t0, 3)}
        row.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()

        if self._csv_writer is None:
            self._csv_fields = list(row)
            self._csv_file = open(self._csv_path, "a", newline="")
            self._csv_writer = csv.DictWriter(self._csv_file, self._csv_fields)
            if self._csv_file.tell() == 0:
                self._csv_writer.writeheader()
        self._csv_writer.writerow({k: row.get(k, "") for k in self._csv_fields})
        self._csv_file.flush()

        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"scalar/{k}", float(v), int(step))

    def close(self) -> None:
        self._jsonl.close()
        if self._csv_file:
            self._csv_file.close()
        if self._tb is not None:
            self._tb.close()


def rates_from_counters(metrics) -> dict:
    """The reference's episode-rate scalars from the trainer's counters
    (collision_rate = collisions/episodes as in main.py:224, win_rate as
    in main.py:225-227, mean episode reward)."""
    eps = max(int(metrics.episodes), 1)
    return {
        "episodes": int(metrics.episodes),
        "env_steps": int(metrics.env_steps),
        "collision_rate": int(metrics.collisions) / eps,
        "win_rate": int(metrics.wins) / eps,
        "reward": float(metrics.sum_ep_reward) / eps,
    }
