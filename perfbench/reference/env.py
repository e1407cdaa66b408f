"""The merging env's step, reset and observation on batched tensors.

Frozen copy of ``core/geometry.py``, ``core/control.py:action_to_acc``,
``core/env.py``, ``core/vector.py`` and
``ops/fused_rollout.py:random_reset_vals`` of ``merging_gym_tpu_torch`` at
commit 79f5ae92604b, with its imports of the port replaced by the copies
in this folder. Nothing here imports the port or JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from perfbench.reference import constants as C
from perfbench.reference import philox


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded once, on the CPU and on the card alike."""
    return x / x.new_full((), c)


def lon2coord(lon: torch.Tensor, side: float):
    """Longitudinal arc position -> (x, y) screen coordinates.

    ``side`` is +1 for player 1 (right arc) and -1 for player 2 (mirrored
    left arc).  Uses the versine form ``R - R*cos(a) == 2*R*sin(a/2)**2``
    (``merging_gym_tpu/core/geometry.py:24-40``), which keeps f32 free of
    the cancellation of the direct form.
    """
    angle = C.ANGLE0 - true_div(lon, C.R)
    x = C.R * torch.sin(angle)
    half = 0.5 * angle
    versine = 2.0 * C.R * torch.sin(half) * torch.sin(half)
    y = C.W / 2 + side * versine
    return x, y


def round_half_away(v: torch.Tensor) -> torch.Tensor:
    """Round half away from zero, as pygame's ``Rect`` centre does.

    ``torch.round`` rounds half to even, so it is not used here.
    """
    return torch.sign(v) * torch.floor(torch.abs(v) + 0.5)


def is_collided(x1, y1, x2, y2) -> torch.Tensor:
    """Touch-inclusive overlap of the 4 (lateral) x 8 (longitudinal)
    vehicle boxes centred at the rounded coordinates."""
    cx1, cy1 = round_half_away(x1), round_half_away(y1)
    cx2, cy2 = round_half_away(x2), round_half_away(y2)
    lon_hit = torch.abs(cx1 - cx2) <= C.VEHICLE_H
    lat_hit = torch.abs(cy1 - cy2) <= C.VEHICLE_W
    return lon_hit & lat_hit


def action_to_acc(vel, target_vel):
    """Closed-form acceleration for a target-velocity action (true division,
    as the kernels compute it)."""
    return true_div(target_vel - vel, C.PREDICTION_T)


@dataclass(frozen=True)
class EnvParams:
    """Reward and start-distribution parameters (merging_env.py:27-32,
    216-221); ``random_start`` selects the reference's commented-out
    randomised start."""

    r_first: float = C.R_FIRST
    r_second: float = C.R_SECOND
    r_collision: float = C.R_COLLISION
    vel_penalty: float = C.VEL_PENALTY
    time_penalty: float = C.TIME_PENALTY
    random_start: bool = False
    max_steps: int = C.TIMEOUT_STEPS

    def reward_tuple(self):
        """Mirror of ``MergeEnv.show_reward`` (merging_env.py:115-116)."""
        return (self.r_first, self.r_second, self.r_collision, self.vel_penalty)


@dataclass
class EnvState:
    """Per-env simulation state; player axis last (0 = player 1)."""

    pos: torch.Tensor     # f[N, 2] longitudinal arc positions
    vel: torch.Tensor     # f[N, 2] velocities
    acc: torch.Tensor     # f[N, 2] last applied accelerations
    t: torch.Tensor       # i32[N] step counter (time = t * DT)
    winner: torch.Tensor  # i32[N]: 0 = none, 1, 2
    done: torch.Tensor    # bool[N]
    r_acc: torch.Tensor   # f[N, 2] accumulated rewards


@dataclass
class TimeStep:
    """Everything ``MergeEnv.step`` returns, batched."""

    obs: torch.Tensor        # f[N, 10] player-1-centric observation
    rewards: torch.Tensor    # f[N, 2]
    done: torch.Tensor       # bool[N]
    collision: torch.Tensor  # bool[N]
    winner: torch.Tensor     # i32[N]
    actions: torch.Tensor    # i32[N, 2]


def observe(state: EnvState) -> torch.Tensor:
    """10-dim mirrored two-player observation (merging_env.py:118-132)."""
    pos, vel = state.pos, state.vel
    x1, y1 = lon2coord(pos[:, 0], +1.0)
    x2, y2 = lon2coord(pos[:, 1], -1.0)
    v1, v2 = vel[:, 0], vel[:, 1]
    return torch.stack([
        x2 - x1, y2 - y1, v2 - v1, C.END_POINT - pos[:, 0], v1,
        x1 - x2, y1 - y2, v1 - v2, C.END_POINT - pos[:, 1], v2,
    ], dim=-1)


def swap_obs(obs: torch.Tensor) -> torch.Tensor:
    """Player-2 view: the ``state[5:] + state[:5]`` swap (main.py:199)."""
    return torch.roll(obs, C.OBS_DIM // 2, dims=-1)


def reset(params: EnvParams, generator: torch.Generator | None = None,
          n: int = 1, dtype=torch.float32, device=None) -> EnvState:
    """Deterministic or randomised start for ``n`` envs (merging_env.py:
    208-230).  Randomised starts draw from ``generator`` (its device is
    the state's); the distributions are those of the JAX package:
    pos1 ~ N(50, 5), vel1 ~ N(20, 3), pos2 ~ U(46, 54), vel2 ~ U(15, 30)."""
    if device is None and generator is not None:
        device = generator.device
    device = torch.device("cuda" if device is None else device)
    if params.random_start:
        if generator is None:
            raise ValueError("random_start requires a torch.Generator")

        def uniform(lo, hi):
            return torch.empty(n, dtype=dtype, device=device).uniform_(
                lo, hi, generator=generator)

        pos1 = C.START_POINT + torch.randn(
            n, generator=generator, dtype=dtype, device=device) * 5.0
        vel1 = C.START_VEL + torch.randn(
            n, generator=generator, dtype=dtype, device=device) * 3.0
        pos2 = C.START_POINT + uniform(-C.VEHICLE_H / 2, C.VEHICLE_H / 2)
        vel2 = C.START_VEL + uniform(-5.0, 10.0)
        pos = torch.stack([pos1, pos2], dim=-1)
        vel = torch.stack([vel1, vel2], dim=-1)
    else:
        pos = torch.full((n, 2), C.START_POINT, dtype=dtype, device=device)
        vel = torch.full((n, 2), C.START_VEL, dtype=dtype, device=device)
    return EnvState(
        pos=pos,
        vel=vel,
        acc=torch.zeros((n, 2), dtype=dtype, device=device),
        t=torch.zeros(n, dtype=torch.int32, device=device),
        winner=torch.zeros(n, dtype=torch.int32, device=device),
        done=torch.zeros(n, dtype=torch.bool, device=device),
        r_acc=torch.zeros((n, 2), dtype=dtype, device=device),
    )


def step(params: EnvParams, state: EnvState, actions: torch.Tensor):
    """One simulation step for both players of every env.

    ``actions`` is an integer ``[N, 2]`` tensor of discrete actions in
    [0, 5); ``ACTION_NONE`` (-1) forces that player's acceleration to 0.
    Returns ``(next_state, TimeStep)``.  Like the reference, stepping a
    done env keeps evolving it; auto-reset lives in ``core.vector``.
    """
    pos0 = state.pos
    dtype = pos0.dtype
    zero = pos0.new_zeros(())
    actions = actions.to(torch.int32)

    # --- dynamics (merging_env.py:147-154) ---------------------------------
    # TARGET_VELS is the table {a: 10*a}, so 10*a is the exact lookup.
    target = 10.0 * actions.clamp(0, C.NUM_ACTIONS - 1).to(dtype)
    acc = torch.where(actions < 0, zero, action_to_acc(state.vel, target))
    vel = torch.clamp_min(state.vel + acc * C.DT, 0.0)
    pos = pos0 + vel * C.DT

    t = state.t + 1
    done = state.done | (t >= params.max_steps)

    # --- velocity-tracking penalty (merging_env.py:158-159) ----------------
    pen = -params.time_penalty - params.vel_penalty * torch.abs(vel - C.V_REF)

    # --- first/second-across state machine (merging_env.py:163-181) --------
    w0 = state.winner
    c1 = pos[:, 0] > C.END_POINT          # strict for player 1
    r1 = torch.where(
        c1,
        torch.where(w0 == 0, pen[:, 0] + params.r_first,
                    torch.where(w0 == 1, zero, pen[:, 0] + params.r_second)),
        pen[:, 0])
    done = done | (c1 & (w0 == 2))
    w1 = torch.where(c1 & (w0 == 0), 1, w0)

    c2 = pos[:, 1] >= C.END_POINT         # inclusive for player 2
    r2 = torch.where(
        c2,
        torch.where(w1 == 0, pen[:, 1] + params.r_first,
                    torch.where(w1 == 2, zero, pen[:, 1] + params.r_second)),
        pen[:, 1])
    done = done | (c2 & (w1 == 1))
    w2 = torch.where(c2 & (w1 == 0), 2, w1).to(torch.int32)

    # --- collision (merging_env.py:183-187) --------------------------------
    x1, y1 = lon2coord(pos[:, 0], +1.0)
    x2, y2 = lon2coord(pos[:, 1], -1.0)
    collision = is_collided(x1, y1, x2, y2)
    done = done | collision
    penalty = torch.where(collision, pos0.new_full((), params.r_collision), zero)
    rewards = torch.stack([r1, r2], dim=-1) + penalty[:, None]

    next_state = EnvState(pos=pos, vel=vel, acc=acc, t=t, winner=w2,
                          done=done, r_acc=state.r_acc + rewards)
    ts = TimeStep(obs=observe(next_state), rewards=rewards, done=done,
                  collision=collision, winner=w2, actions=actions)
    return next_state, ts


def reset_batch(params: EnvParams, generator: torch.Generator | None,
                num_envs: int, dtype=torch.float32, device=None) -> EnvState:
    """Batched reset; random starts draw from ``generator``."""
    return reset(params, generator, num_envs, dtype, device)


def step_batch(params: EnvParams, state: EnvState, actions: torch.Tensor):
    """Batched step. ``actions``: int[num_envs, 2]."""
    return step(params, state, actions)


def autoreset_step(params: EnvParams, state: EnvState, actions: torch.Tensor,
                   generator: torch.Generator | None = None):
    """Step all envs, then reset the ones that finished.

    The returned ``TimeStep`` carries the pre-reset terminal observation;
    the returned state is post-reset.
    """
    next_state, ts = step_batch(params, state, actions)
    n = ts.done.shape[0]
    fresh = reset_batch(params, generator, n, state.pos.dtype, state.pos.device)
    d = ts.done

    def pick(new, old):
        return torch.where(d.reshape((n,) + (1,) * (old.dim() - 1)), new, old)

    return EnvState(**{f: pick(getattr(fresh, f), getattr(next_state, f))
                       for f in EnvState.__dataclass_fields__}), ts


def random_reset_vals(step_idx: int, num_envs: int, key, dtype, device):
    """Randomised-start values from Philox stream 1 at ``step_idx``: the
    Box-Muller construction of ``merging_gym_tpu/ops/fused_rollout.py:
    41-63`` on 24-bit uniforms.  pos1 ~ N(50, 5), vel1 ~ N(20, 3),
    pos2 ~ U(46, 54), vel2 ~ U(15, 30).  Returns ``(pos, vel)``, [N, 2]."""
    w = philox.draw(step_idx, num_envs, philox.STREAM_RESET, key, device)
    u = [(x >> 8).to(dtype) * (1.0 / 16777216.0) for x in w]
    r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u[0], 1e-7)))
    theta = (2.0 * 3.14159265358979) * u[1]
    z1, z2 = r * torch.cos(theta), r * torch.sin(theta)
    pos = torch.stack([C.START_POINT + 5.0 * z1,
                       C.START_POINT + (u[2] * C.VEHICLE_H - C.VEHICLE_H / 2)],
                      dim=-1)
    vel = torch.stack([C.START_VEL + 3.0 * z2,
                       (C.START_VEL - 5.0) + 15.0 * u[3]], dim=-1)
    return pos, vel
