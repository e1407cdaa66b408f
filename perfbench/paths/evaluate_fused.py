"""``agents.evaluate.evaluate_fused`` (K6 and its outcome reduction), as
``cli.py eval --fused`` calls it: one matchup of two Q-nets, Phi(eps)-greedy,
its outcome dict back in host memory.  Matchups run back to back, the i-th
with seed ``seed + i`` (set-up plays matchup 0, which warms the shapes).

The nets are the traffic's two ``.npz`` files (copies of the zoo's, under
``perfbench/zoo/``), loaded with numpy and handed to the program and the
reference alike.  After the window the reference (the frozen plain K6 and
reduction of ``reference/policy.py``) replays ``checked_matchups`` of the
window's matchups, drawn from the seed.  Compared: ``count_gap``, the
largest gap of the five outcome counts, in episodes, and ``return_gap``,
the largest relative gap of the two mean returns.

``control="bfloat16"`` runs the program's own lower-precision path
(``compute_dtype="bfloat16"``).
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

from perfbench.reference import counts
from perfbench.reference import policy as ref
from perfbench.reference.env import EnvParams as RefEnvParams

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTS = ("episodes", "p1_first", "p2_first", "collisions", "timeouts")
RETURNS = ("mean_return_p1", "mean_return_p2")
POLICY_KERNELS = ("policy_kernel",)


def load_qnet(path: str, device) -> dict:
    """A ``params.npz`` of ``{fc0, fc1, fc2: {w, b}}`` (keys
    ``['fc0']['w']``) as f32 tensors on ``device``."""
    out: dict = {}
    with np.load(os.path.join(BENCH_DIR, path)) as z:
        for key in z.files:
            layer, name = key[2:-2].split("']['")
            out.setdefault(layer, {})[name] = torch.tensor(
                z[key], dtype=torch.float32, device=device)
    return out


class Cell:
    policy_kernels = POLICY_KERNELS

    def __init__(self, config, traffic, seed, device, control=None):
        from merging_gym_tpu_torch.agents.evaluate import evaluate_fused
        from merging_gym_tpu_torch.core.env import EnvParams

        steps_cap = traffic.get("max_steps")   # a test's short episodes
        self.ep = EnvParams() if steps_cap is None else EnvParams(
            max_steps=int(steps_cap))
        self.ref_ep = RefEnvParams(max_steps=self.ep.max_steps)
        self.evaluate_fused = evaluate_fused
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.n, self.T = int(traffic["num_envs"]), int(traffic["num_steps"])
        self.eps = float(traffic["epsilon"])
        self.dtype = control or config["dtype"]
        self.p1 = load_qnet(traffic["p1"], device)
        self.p2 = load_qnet(traffic["p2"], device)
        self.i, self.results = 0, {}
        self.call()                                   # matchup 0: warm-up
        self.results.clear()

    def call(self) -> int:
        res = self.evaluate_fused(
            self.p1, self.p2, self.ep, num_envs=self.n, num_steps=self.T,
            greedy=False, epsilon=self.eps, seed=self.seed + self.i,
            compute_dtype=self.dtype, device=self.device)
        self.results[self.i] = res
        self.i += 1
        return self.n * self.T

    def release(self):
        pass   # the nets are the reference's inputs too; nothing else lives

    def check(self) -> dict:
        done = sorted(self.results)
        k = min(int(self.traffic["checked_matchups"]), len(done))
        sample = random.Random(self.seed).sample(done, k)
        nan = float("nan")
        counts, returns = (0.0, 0.0) if sample else (nan, nan)
        for i in sample:
            ev = ref.fused_policy_rollout_plain(
                self.T, self.n, self.p1, self.p2, greedy=False,
                epsilon=self.eps, seed=self.seed + i,
                env_params=self.ref_ep, compute_dtype=self.config["dtype"],
                device=self.device)
            sums = ref.fused_outcomes(ev["done"], ev["winner"],
                                      ev["collision"], ev["rewards"]).tolist()
            want = ref._finalize(
                {c: int(v) for c, v in zip(ref.OUTCOME_COUNTS, sums)},
                sums[len(ref.OUTCOME_COUNTS):])
            got = self.results[i]
            counts = max([counts] + [abs(got[c] - want[c]) for c in COUNTS])
            returns = max([returns] + [
                abs(got[c] - want[c]) / max(abs(want[c]), 1e-30)
                for c in RETURNS])
        self.sample = sample
        return {"count_gap": float(counts), "return_gap": returns}

    # Counts for the metric readers (reference/counts.py).

    @property
    def dims(self) -> tuple:
        c = self.config
        return (c["obs_dim"], *c["hidden"], c["num_actions"])

    def model_flops_per_call(self) -> float:
        """Both nets' forwards of every env-step of a matchup."""
        return 2 * counts.mlp_flops(*self.dims) * self.n * self.T

    def policy_bound_s(self) -> float:
        """K6's least time: its operations (both forwards, the env step and
        the observation) or its events written, the larger."""
        return counts.bound(counts.policy_bytes(self.n, self.T),
                            counts.policy_flops(self.n, self.T))[0] / 1e3

    def notes(self, run) -> dict:
        ms = sorted(run.window.ms)
        return {"matchups": len(ms), "matchup_ms_median":
                ms[len(ms) // 2] if ms else None,
                "checked": getattr(self, "sample", None)}
