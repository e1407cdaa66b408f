"""The port's headline benchmark: env-steps/s of the reduce-on-chip rollout
(K2) at 4,096 envs on one card.

    python -m merging_gym_tpu_torch.cli bench

Counterpart of the JAX package's ``cli bench`` (the repository's root
``bench.py``): one warm-up launch at seed 0, then ``REPS`` launches of
:func:`ops.fused_rollout.fused_rollout_counters` at seeds 1-5, seed mode,
``LAUNCH_STEPS`` steps each.  Each launch is timed on the host clock and
fenced by a read-back of ``reward_sum.sum()``; the value is the median
rate.  Prints one JSON line: ``{"metric", "value", "unit",
"vs_baseline", "device"}``.  ``vs_baseline`` divides by the reference's
serial Python env, at most 1e3 env-steps/s on a CPU (BASELINE.md).

No watchdog, no CPU fallback, no retry at another length: a launch that
fails raises.  The command measures the card, so the CLI refuses
``--cpu``; :func:`measure` takes ``device="cpu"`` for the tests.
"""

from __future__ import annotations

import json
import statistics
import time

import torch

from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.device import resolve_device
from merging_gym_tpu_torch.ops.fused_rollout import fused_rollout_counters

NUM_ENVS = 4096
LAUNCH_STEPS = 1048576
REPS = 5
REFERENCE_STEPS_PER_SEC = 1e3
METRIC = "env_steps_per_sec_1chip_4096envs"


def measure(num_envs: int = NUM_ENVS, launch_steps: int = LAUNCH_STEPS,
            reps: int = REPS, device=None) -> list[float]:
    """Env-steps/s of ``reps`` timed launches (after one warm-up)."""
    dev = resolve_device(device)
    params = EnvParams()

    def launch(seed):
        out = fused_rollout_counters(launch_steps, num_envs, seed=seed,
                                     env_params=params, device=dev)
        return float(out["reward_sum"].sum())  # the read-back fence

    launch(0)
    rates = []
    for seed in range(1, reps + 1):
        t0 = time.perf_counter()
        launch(seed)
        rates.append(num_envs * launch_steps / (time.perf_counter() - t0))
    return rates


def result_line(value: float, device_name: str) -> dict:
    """The JSON line of the JAX package's bench, with the card's name."""
    return {"metric": METRIC, "value": round(value, 1),
            "unit": "env-steps/s",
            "vs_baseline": round(value / REFERENCE_STEPS_PER_SEC, 1),
            "device": device_name}


def main() -> dict:
    dev = resolve_device(None)
    line = result_line(statistics.median(measure(device=dev)),
                       torch.cuda.get_device_name(dev))
    print(json.dumps(line), flush=True)
    return line
