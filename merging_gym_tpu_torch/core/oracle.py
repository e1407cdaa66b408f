"""Float64 CPU oracle: a line-faithful re-implementation of the reference env.

A copy of ``merging_gym_tpu/core/oracle.py`` (the port imports nothing of
the JAX package); ``tests/test_torch_oracle_native.py`` holds the two bit
for bit.  It is a host env in both packages and stays numpy float64: the
parity authority for the batched env in core.env.  It mirrors the
reference ``MergeEnv`` (merging_gym/envs/merging_env.py) operation by
operation in numpy float64, including:

* sequential float accumulation of ``time_stamp += 0.2`` with the
  ``> 500`` timeout test (merging_env.py:141-143);
* the direct (cancellation-prone) ``R - R*cos(angle)`` lateral coordinate
  (merging_env.py:53-55);
* pygame's half-away-from-zero centre rounding + shapely's touch-inclusive
  ``intersects`` in the collision test (merging_env.py:198-206, 232-239);
* the per-step QP control law via its exact closed form
  ``(vt - v0) / prediction_t`` (scripts/helper.py:152-191; see
  core.control for the equivalence proof, which tests also verify
  numerically against a dense KKT solve);
* the full winner/reward state machine with the ``>`` / ``>=`` asymmetry
  and the winner-reward-overwrite (merging_env.py:163-181).

The class keeps the reference's exact public surface -- ``reset() -> list``,
``step(action1, action2=None) -> (obs, [r1, r2], done, info)``,
``observe``, ``is_collided``, ``show_reward``, ``winner``,
``r1_accumulate``/``r2_accumulate`` -- so reference training scripts port
against it unmodified.
"""

import math

import numpy as np

from merging_gym_tpu_torch.core import constants as C

_ACTION_DICT = {0: 0.0, 1: 10.0, 2: 20.0, 3: 30.0, 4: 40.0}


def _lon2coord(lon, side):
    """merging_env.py:48-58, exact float64 form (direct R - R*cos)."""
    angle = math.atan2(C.H, C.R) - lon / C.R
    x = C.R * math.sin(angle)
    y = C.W / 2 + side * (C.R - C.R * math.cos(angle))
    return x, y


def _round_half_away(v):
    """pygame Rect centre rounding (verified against pygame 2.6)."""
    return math.copysign(math.floor(abs(v) + 0.5), v)


class OracleMergeEnv:
    """Serial float64 oracle with the reference ``MergeEnv`` API."""

    def __init__(self, r_first=C.R_FIRST, r_second=C.R_SECOND,
                 r_collision=C.R_COLLISION, vel_penalty=C.VEL_PENALTY,
                 time_penalty=C.TIME_PENALTY, random_start=False, rng=None):
        self.r_first = r_first
        self.r_second = r_second
        self.r_collision = r_collision
        self.vel_penalty = vel_penalty
        self.time_penalty = time_penalty
        self.random_start = random_start
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.reset()

    def show_reward(self):
        """merging_env.py:115-116."""
        return self.r_first, self.r_second, self.r_collision, self.vel_penalty

    def reset(self):
        """merging_env.py:208-230."""
        self.done = False
        self.winner = None
        self.time_stamp = 0.0
        if self.random_start:
            # Commented-out randomised start mode (merging_env.py:219-221).
            self.state1 = {
                "pos": C.START_POINT + self.rng.standard_normal() * 5,
                "vel": C.START_VEL + self.rng.standard_normal() * 3,
                "acc": 0.0,
            }
            self.state2 = {
                "pos": C.START_POINT + self.rng.uniform(-C.VEHICLE_H / 2, C.VEHICLE_H / 2),
                "vel": C.START_VEL + self.rng.uniform(-5, 10),
                "acc": 0.0,
            }
        else:
            self.state1 = {"pos": C.START_POINT, "vel": C.START_VEL, "acc": 0.0}
            self.state2 = {"pos": C.START_POINT, "vel": C.START_VEL, "acc": 0.0}
        self.r1_accumulate = 0.0
        self.r2_accumulate = 0.0
        return self.observe()

    def observe(self):
        """merging_env.py:118-132."""
        x1, y1 = _lon2coord(self.state1["pos"], +1.0)
        x2, y2 = _lon2coord(self.state2["pos"], -1.0)
        return [
            x2 - x1,
            y2 - y1,
            self.state2["vel"] - self.state1["vel"],
            C.END_POINT - self.state1["pos"],
            self.state1["vel"],
            x1 - x2,
            y1 - y2,
            self.state1["vel"] - self.state2["vel"],
            C.END_POINT - self.state2["pos"],
            self.state2["vel"],
        ]

    @staticmethod
    def action_to_acc(v0, vt):
        """Closed form of the reference QP (helper.py:152-191)."""
        return (vt - v0) / C.PREDICTION_T

    def is_collided(self):
        """merging_env.py:198-206 without pygame/shapely (see geometry.py)."""
        x1, y1 = _lon2coord(self.state1["pos"], +1.0)
        x2, y2 = _lon2coord(self.state2["pos"], -1.0)
        d_lon = abs(_round_half_away(x1) - _round_half_away(x2))
        d_lat = abs(_round_half_away(y1) - _round_half_away(y2))
        return d_lon <= C.VEHICLE_H and d_lat <= C.VEHICLE_W

    def step(self, action1, action2=None):
        """merging_env.py:138-195, statement for statement."""
        self.time_stamp += C.DT
        if self.time_stamp > C.TIME_LIMIT:
            self.done = True
        info = {"collision": False}

        self.state1["acc"] = self.action_to_acc(self.state1["vel"], _ACTION_DICT[action1])
        self.state1["vel"] = max(0.0, self.state1["vel"] + self.state1["acc"] * C.DT)
        self.state1["pos"] += self.state1["vel"] * C.DT

        self.state2["acc"] = (
            0.0 if action2 is None
            else self.action_to_acc(self.state2["vel"], _ACTION_DICT[action2])
        )
        self.state2["vel"] = max(0.0, self.state2["vel"] + self.state2["acc"] * C.DT)
        self.state2["pos"] += self.state2["vel"] * C.DT

        obs = self.observe()

        reward1 = -self.time_penalty - self.vel_penalty * abs(self.state1["vel"] - C.V_REF)
        reward2 = -self.time_penalty - self.vel_penalty * abs(self.state2["vel"] - C.V_REF)

        if self.state1["pos"] > C.END_POINT:
            if self.winner is None:
                self.winner = 1
                reward1 += self.r_first
            elif self.winner == 1:
                reward1 = 0.0
            else:
                reward1 += self.r_second
                self.done = True

        if self.state2["pos"] >= C.END_POINT:
            if self.winner is None:
                self.winner = 2
                reward2 += self.r_first
            elif self.winner == 2:
                reward2 = 0.0
            else:
                reward2 += self.r_second
                self.done = True

        if self.is_collided():
            self.done = True
            reward1 += self.r_collision
            reward2 += self.r_collision
            info["collision"] = True

        self.r1_accumulate += reward1
        self.r2_accumulate += reward2
        return obs, [reward1, reward2], self.done, info
