"""Learned-policy rollout as one kernel launch (K6).

Replaces ``merging_gym_tpu/ops/fused_policy_rollout.py:_kernel``
(``pallas_call`` at :197, entry ``fused_policy_rollout``, used by
``agents/evaluate.py:evaluate_fused``).  Each step, both players' Q-nets
run inside the kernel on the pre-step observation, actions are picked
greedily or by the reference's Phi(eps)-greedy quirk, the env steps and
auto-resets; only the per-step events leave the card.

On the card it is ``kernels/csrc/policy_rollout.cu``: a block owns a
tile of envs, the env state sits in the registers of one thread per env,
and all the block's threads share each layer's outputs through shared
memory (``kernels/csrc/mlp.cuh``, the K3 device code).  The plain
PyTorch version below repeats the arithmetic op for op; on the card the
two agree bit for bit.

Modes, as in the JAX kernel:
* ``greedy=True``: first-occurrence argmax; else Phi(eps)-greedy with the
  bits of Philox stream 0 at ``(step, env)``: words 0/1 for player 1's
  mask/random action, 2/3 for player 2's (``mask < min(int(p*2**32),
  2**32-1)`` keeps the greedy action, else ``rand % A``);
* ``params2=None``: player 2 is the L0 opponent (action -1); otherwise
  its net acts on the half-swapped observation;
* ``env_params.random_start``: starts and resets from Philox stream 1
  (``ops.fused_rollout.random_reset_vals``);
* ``compute_dtype`` ``"float32"`` or ``"bfloat16"`` (weights stored bf16).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import replace

import torch

from merging_gym_tpu_torch import kernels
from merging_gym_tpu_torch.core import constants as C
from merging_gym_tpu_torch.core.env import EnvParams, observe, swap_obs
from merging_gym_tpu_torch.core.vector import autoreset_step, reset_batch
from merging_gym_tpu_torch.device import tensor_device
from merging_gym_tpu_torch.ops import philox
from merging_gym_tpu_torch.ops.fused_mlp import (cast_weights,
                                                 compute_dtype_of, mlp_plain)
from merging_gym_tpu_torch.ops.fused_rollout import (as_events,
                                                     random_reset_vals,
                                                     rewards_cfg)

# Bytes each env-step writes: actions (8), rewards (8), done/winner/col (12).
K6_BYTES_PER_ENV_STEP = 28

# Envs per block; fewer where a wide net's tile would not fit.
K6_TILE_ENVS = 16
_ROLLOUT_ARGS = ([ctypes.c_void_p] * 12 + [ctypes.c_void_p] * 5
                 + [ctypes.c_int] * 7
                 + [ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
                    ctypes.c_int, ctypes.c_int]
                 + [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int]
                 + [ctypes.c_float] * 5 + [ctypes.c_void_p])


def phi(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def greedy_threshold(epsilon: float) -> int:
    """uint32 threshold below which a Phi(eps)-greedy draw stays greedy."""
    return min(int(phi(epsilon) * 4294967296.0), 4294967295)


def _select(q, mask_bits, rand_bits, greedy, threshold):
    a = torch.argmax(q, dim=-1).to(torch.int32)
    if greedy:
        return a
    rand = (rand_bits % q.shape[-1]).to(torch.int32)
    return torch.where(mask_bits < threshold, a, rand)


def fused_policy_rollout_plain(num_steps: int, num_envs: int, params1,
                               params2=None, *, greedy: bool = True,
                               epsilon: float = 0.7, seed: int = 0,
                               env_params: EnvParams | None = None,
                               compute_dtype: str = "float32",
                               device=None) -> dict:
    """Plain PyTorch version of K6 (see :func:`fused_policy_rollout`)."""
    env_params, dtype, dev = _prepare(params1, params2, env_params,
                                      compute_dtype, device)
    w1 = cast_weights(params1, dtype, dev)
    w2 = cast_weights(params2, dtype, dev) if params2 is not None else None
    key = philox.seed_key(seed)
    thr = greedy_threshold(epsilon)
    N = num_envs
    # Steps and resets run deterministic; random starts then overwrite the
    # reset envs' positions and velocities with Philox stream 1.
    det = replace(env_params, random_start=False)

    state = reset_batch(det, None, N, torch.float32, dev)
    if env_params.random_start:
        state.pos, state.vel = random_reset_vals(0, N, key, torch.float32, dev)
    out = empty_events(num_steps, N, dev)
    for s in range(num_steps):
        obs = observe(state)
        bits = ((None,) * 4 if greedy else
                philox.draw(s, N, philox.STREAM_ACTIONS, key, dev))
        a1 = _select(mlp_plain(w1, obs, dtype), bits[0], bits[1], greedy, thr)
        if w2 is None:
            a2 = torch.full_like(a1, C.ACTION_NONE)
        else:
            a2 = _select(mlp_plain(w2, swap_obs(obs), dtype), bits[2],
                         bits[3], greedy, thr)
        actions = torch.stack([a1, a2], dim=-1)
        state, ts = autoreset_step(det, state, actions)
        out["actions"][s] = actions.T
        out["rewards"][s] = ts.rewards.T
        out["done"][s] = ts.done
        out["winner"][s] = ts.winner
        out["collision"][s] = ts.collision
        if env_params.random_start:
            pos_r, vel_r = random_reset_vals(s, N, key, torch.float32, dev)
            d = ts.done[:, None]
            state.pos = torch.where(d, pos_r, state.pos)
            state.vel = torch.where(d, vel_r, state.vel)
    return as_events(out)


def fused_policy_rollout(num_steps: int, num_envs: int, params1,
                         params2=None, *, greedy: bool = True,
                         epsilon: float = 0.7, seed: int = 0,
                         env_params: EnvParams | None = None,
                         compute_dtype: str = "float32",
                         device=None) -> dict:
    """Run T policy-driven env steps for N envs in one launch (K6).

    ``params1``/``params2`` are Q-net param dicts ``{fc0, fc1, fc2: {w, b}}``
    (10 -> H1 -> H2 -> A) of tensors or arrays; ``params2=None`` plays L0,
    ``params2=params1`` is self-play.  The device is that of ``params1``'s
    tensors, else ``device`` (default ``cuda``); CPU runs the plain version.
    Returns env-last events: ``actions`` i32[T, 2, N], ``rewards``
    f32[T, 2, N], ``done``/``collision`` bool[T, N], ``winner`` i32[T, N].
    """
    env_params, dtype, dev = _prepare(params1, params2, env_params,
                                      compute_dtype, device)
    if dev.type == "cpu":
        return fused_policy_rollout_plain(
            num_steps, num_envs, params1, params2, greedy=greedy,
            epsilon=epsilon, seed=seed, env_params=env_params,
            compute_dtype=compute_dtype, device=dev)
    out = empty_events(num_steps, num_envs, dev)
    w1 = cast_weights(params1, dtype, dev)
    w2 = cast_weights(params2, dtype, dev) if params2 is not None else None
    launch_policy_rollout(out, w1, w2, greedy=greedy, epsilon=epsilon,
                          seed=seed, env_params=env_params)
    return as_events(out)


def launch_policy_rollout(out: dict, w1: list, w2: list | None, *,
                          greedy: bool, epsilon: float, seed: int,
                          env_params: EnvParams) -> None:
    """Launch K6 into the preallocated int32/f32 buffers of ``out``."""
    T, _, N = out["actions"].shape
    bufs = [out[k] for k in ("actions", "rewards", "done", "winner",
                             "collision")]
    dev = kernels.require_cuda(*bufs, *w1, *(w2 or []))
    d_in, h1 = w1[0].shape
    h2, a = w1[4].shape
    if w2 is not None and [w.shape for w in w2] != [w.shape for w in w1]:
        raise ValueError("both players' nets must have the same shapes")
    tile = kernels.tile_size(
        K6_TILE_ENVS, (2 * C.OBS_DIM + 2 * a) * 4,
        (d_in + h1 + h2) * w1[0].element_size())
    k0, k1 = philox.seed_key(seed)
    fn = kernels.function("policy_rollout", "mgt_policy_rollout",
                          _ROLLOUT_ARGS)
    rc = fn(*map(kernels.ptr, w1), *map(kernels.ptr, w2 or [None] * 6),
            *map(kernels.ptr, bufs),
            T, N, d_in, h1, h2, a, tile,
            int(w2 is not None), int(greedy), greedy_threshold(epsilon),
            int(env_params.random_start), int(w1[0].dtype == torch.bfloat16),
            k0, k1, env_params.max_steps, *rewards_cfg(env_params),
            kernels.stream_ptr(dev))
    kernels.check("policy_rollout", rc, "policy_rollout launch")
    kernels.launch_counts["policy_rollout"] += 1


def _prepare(params1, params2, env_params, compute_dtype, device):
    env_params = env_params or EnvParams()
    dtype = compute_dtype_of(compute_dtype)
    d_in = params1["fc0"]["w"].shape[0]
    if d_in != C.OBS_DIM:
        raise ValueError(f"policy nets take {C.OBS_DIM} inputs, got {d_in}")
    return env_params, dtype, tensor_device(params1, device)


def empty_events(T, N, dev):
    """Kernel output buffers (int32 events) for T steps of N envs."""
    return {"actions": torch.empty(T, 2, N, dtype=torch.int32, device=dev),
            "rewards": torch.empty(T, 2, N, dtype=torch.float32, device=dev),
            "done": torch.empty(T, N, dtype=torch.int32, device=dev),
            "winner": torch.empty(T, N, dtype=torch.int32, device=dev),
            "collision": torch.empty(T, N, dtype=torch.int32, device=dev)}
