"""The whole vectorised env rollout as one kernel launch (K1 and K2).

Replaces ``merging_gym_tpu/ops/fused_rollout.py``: ``_kernel`` (K1, the
trajectory rollout, ``pallas_call`` at :264) and ``_kernel_counters`` (K2,
the reduce-on-chip rollout at :321, ``bench.py``'s headline kernel).

On the card both are ``kernels/csrc/env_rollout.cu``: one thread per env
loops over the T steps with its state in registers, so the env-last
``[T, c, N]`` writes are coalesced across each warp.  K2 keeps its
counters in registers and writes them once.  On the CPU each wrapper runs
its plain PyTorch version below, which repeats the kernel's arithmetic op
for op; on the card the two agree bit for bit.

Two action sources, as in the JAX package:
* ``actions`` -- an int ``[T, 2, N]`` stream (-1 = the L0 arm);
* ``seed`` -- uniform joint actions in [-1, 5) drawn from Philox4x32-10
  at counter ``(step, env, 0, 0)`` (``ops.philox``).  Unlike the TPU
  stream, the draws depend on (seed, step, env) alone, so K1 and K2 at
  one seed play the same actions, whatever ``unroll`` says.

Deterministic starts only, as in the JAX kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from merging_gym_tpu_torch import kernels
from merging_gym_tpu_torch.core import constants as C
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.core.vector import autoreset_step, reset_batch
from merging_gym_tpu_torch.device import tensor_device
from merging_gym_tpu_torch.ops import philox

# Bytes each env-step moves in K1: actions read (8), obs (40), rewards (8),
# done/winner/collision (12).  Seed mode reads no actions.
K1_BYTES_PER_ENV_STEP = 68

_ENV_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
             ctypes.c_int] + [ctypes.c_float] * 5
_ROLLOUT_ARGS = [ctypes.c_void_p] * 6 + _ENV_ARGS + [ctypes.c_void_p]
_COUNTERS_ARGS = [ctypes.c_void_p] * 3 + _ENV_ARGS + [ctypes.c_void_p]


def rewards_cfg(env_params: EnvParams) -> tuple:
    """``(r_first, r_second, r_collision, vel_penalty, time_penalty)``."""
    p = env_params
    return (p.r_first, p.r_second, p.r_collision, p.vel_penalty,
            p.time_penalty)


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


def seed_actions(step_idx: int, num_envs: int, key, device) -> torch.Tensor:
    """Seed-mode joint actions ``bits % 6 - 1`` as int32 ``[N, 2]``."""
    w = philox.draw(step_idx, num_envs, philox.STREAM_ACTIONS, key, device)
    return torch.stack([w[0] % (C.NUM_ACTIONS + 1) - 1,
                        w[1] % (C.NUM_ACTIONS + 1) - 1],
                       dim=-1).to(torch.int32)


def _plain_steps(num_steps, num_envs, actions, seed, env_params, device):
    """Yield ``TimeStep``s of the auto-reset rollout (plain version)."""
    key = philox.seed_key(seed) if actions is None else None
    state = reset_batch(env_params, None, num_envs, torch.float32, device)
    for s in range(num_steps):
        a = (seed_actions(s, num_envs, key, device) if actions is None
             else actions[s].T)
        state, ts = autoreset_step(env_params, state, a)
        yield ts


def fused_rollout_plain(num_steps: int, num_envs: int, actions=None,
                        seed=None, env_params: EnvParams | None = None,
                        device=None) -> dict:
    """Plain PyTorch version of K1 (see :func:`fused_rollout`)."""
    env_params, actions, dev = _prepare(num_steps, num_envs, actions, seed,
                                        env_params, device)
    out = empty_rollout(num_steps, num_envs, dev)
    for s, ts in enumerate(_plain_steps(num_steps, num_envs, actions, seed,
                                        env_params, dev)):
        out["obs"][s] = ts.obs.T
        out["rewards"][s] = ts.rewards.T
        out["done"][s] = ts.done
        out["winner"][s] = ts.winner
        out["collision"][s] = ts.collision
    return as_events(out)


def fused_rollout_counters_plain(num_steps: int, num_envs: int, actions=None,
                                 seed=None,
                                 env_params: EnvParams | None = None,
                                 device=None) -> dict:
    """Plain PyTorch version of K2 (see :func:`fused_rollout_counters`)."""
    env_params, actions, dev = _prepare(num_steps, num_envs, actions, seed,
                                        env_params, device)
    rewsum = torch.zeros(2, num_envs, dtype=torch.float32, device=dev)
    counts = torch.zeros(4, num_envs, dtype=torch.int32, device=dev)
    for ts in _plain_steps(num_steps, num_envs, actions, seed, env_params,
                           dev):
        rewsum = rewsum + ts.rewards.T
        d, col = ts.done, ts.collision
        counts = counts + torch.stack([
            d, col, d & (ts.winner == 1) & ~col,
            d & (ts.winner == 2) & ~col]).to(torch.int32)
    return _as_counters(rewsum, counts)


def fused_rollout(num_steps: int, num_envs: int, actions=None, seed=None,
                  env_params: EnvParams | None = None, unroll: int = 1,
                  device=None) -> dict:
    """T lockstep env steps for N envs with auto-reset, in one launch (K1).

    Exactly one of ``actions`` (int ``[T, 2, N]``, a tensor or array) or
    ``seed`` (int) is given.  The device is that of ``actions`` if it is a
    tensor, else ``device`` (default ``cuda``).  On the CPU this runs the
    plain version.  ``unroll`` is accepted for API parity with the JAX
    package and changes no result.

    Returns env-last trajectories: ``obs`` f32[T, 10, N], ``rewards``
    f32[T, 2, N], ``done``/``collision`` bool[T, N], ``winner`` i32[T, N].
    """
    env_params, actions, dev = _prepare(num_steps, num_envs, actions, seed,
                                        env_params, device)
    if dev.type == "cpu":
        return fused_rollout_plain(num_steps, num_envs, actions, seed,
                                   env_params, dev)
    out = empty_rollout(num_steps, num_envs, dev)
    launch_rollout(out, actions, seed, env_params)
    return as_events(out)


def fused_rollout_counters(num_steps: int, num_envs: int, actions=None,
                           seed=None, env_params: EnvParams | None = None,
                           unroll: int = 1, device=None) -> dict:
    """Reduce-on-chip rollout (K2): the action stream and env math of
    :func:`fused_rollout`, returning per-env sums instead of trajectories:
    ``reward_sum`` f32[2, N] and i32[N] ``episodes`` (sum of done),
    ``collisions``, ``wins1``/``wins2`` (done & winner == p & ~collision).
    """
    env_params, actions, dev = _prepare(num_steps, num_envs, actions, seed,
                                        env_params, device)
    if dev.type == "cpu":
        return fused_rollout_counters_plain(num_steps, num_envs, actions,
                                            seed, env_params, dev)
    rewsum = torch.empty(2, num_envs, dtype=torch.float32, device=dev)
    counts = torch.empty(4, num_envs, dtype=torch.int32, device=dev)
    launch_counters(rewsum, counts, num_steps, actions, seed, env_params)
    return _as_counters(rewsum, counts)


def launch_rollout(out: dict, actions, seed, env_params: EnvParams) -> None:
    """Launch K1 into the preallocated int32/f32 buffers of ``out``."""
    T, _, N = out["obs"].shape
    bufs = [out[k] for k in ("obs", "rewards", "done", "winner", "collision")]
    dev = kernels.require_cuda(*bufs, *([] if actions is None else [actions]))
    fn = kernels.function("env_rollout", "mgt_env_rollout", _ROLLOUT_ARGS)
    rc = fn(kernels.ptr(actions), *map(kernels.ptr, bufs),
            *_env_call_args(T, N, seed, env_params), kernels.stream_ptr(dev))
    kernels.check("env_rollout", rc, "env_rollout launch")
    kernels.launch_counts["env_rollout"] += 1


def launch_counters(rewsum, counts, num_steps: int, actions, seed,
                    env_params: EnvParams) -> None:
    """Launch K2 into ``rewsum`` f32[2, N] and ``counts`` i32[4, N]."""
    N = rewsum.shape[1]
    dev = kernels.require_cuda(rewsum, counts,
                               *([] if actions is None else [actions]))
    fn = kernels.function("env_rollout", "mgt_env_counters", _COUNTERS_ARGS)
    rc = fn(kernels.ptr(actions), kernels.ptr(rewsum), kernels.ptr(counts),
            *_env_call_args(num_steps, N, seed, env_params),
            kernels.stream_ptr(dev))
    kernels.check("env_rollout", rc, "env_counters launch")
    kernels.launch_counts["env_counters"] += 1


def _env_call_args(T, N, seed, env_params):
    k0, k1 = philox.seed_key(0 if seed is None else seed)
    return (T, N, k0, k1, env_params.max_steps, *rewards_cfg(env_params))


def _prepare(num_steps, num_envs, actions, seed, env_params, device):
    if (actions is None) == (seed is None):
        raise ValueError("pass actions XOR seed")
    env_params = env_params or EnvParams()
    if env_params.random_start:
        raise ValueError("fused rollout: deterministic starts only")
    dev = tensor_device(actions, device)
    if actions is not None:
        actions = torch.as_tensor(np.asarray(actions) if not isinstance(
            actions, torch.Tensor) else actions, device=dev).to(
                torch.int32).contiguous()
        if tuple(actions.shape) != (num_steps, 2, num_envs):
            raise ValueError(f"actions must be [{num_steps}, 2, {num_envs}], "
                             f"got {tuple(actions.shape)}")
    return env_params, actions, dev


def empty_rollout(T, N, dev):
    """K1 output buffers (int32 events) for T steps of N envs."""
    return {"obs": torch.empty(T, 10, N, dtype=torch.float32, device=dev),
            "rewards": torch.empty(T, 2, N, dtype=torch.float32, device=dev),
            "done": torch.empty(T, N, dtype=torch.int32, device=dev),
            "winner": torch.empty(T, N, dtype=torch.int32, device=dev),
            "collision": torch.empty(T, N, dtype=torch.int32, device=dev)}


def as_events(out):
    """int32 event buffers -> the bool ``done``/``collision`` of the API."""
    return {**out, "done": out["done"].bool(),
            "collision": out["collision"].bool()}


def _as_counters(rewsum, counts):
    return {"reward_sum": rewsum, "episodes": counts[0],
            "collisions": counts[1], "wins1": counts[2], "wins2": counts[3]}
