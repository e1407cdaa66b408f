"""Learned-policy rollout as one kernel launch (K6).

Replaces ``merging_gym_tpu/ops/fused_policy_rollout.py:_kernel``
(``pallas_call`` at :197, entry ``fused_policy_rollout``, used by
``agents/evaluate.py:evaluate_fused``).  Each step, both players' Q-nets
run inside the kernel on the pre-step observation, actions are picked
greedily or by the reference's Phi(eps)-greedy quirk, the env steps and
auto-resets; only the per-step events leave the card.

On the card it is ``kernels/csrc/policy_rollout.cu``: a block owns
``rows`` envs, the env state sits in the registers of one thread per env,
and all the block's threads run each layer on K3's register micro-tiles
(``kernels/csrc/qnet_tiled.cuh``) with the activations in shared memory.
Both nets stay in shared memory for the whole launch where they fit,
else they stream through two weight buffers every step;
:func:`policy_geometry` chooses.  The plain PyTorch version below repeats
the arithmetic op for op; on the card the two agree bit for bit.

Modes, as in the JAX kernel:
* ``greedy=True``: first-occurrence argmax; else Phi(eps)-greedy with the
  bits of Philox stream 0 at ``(step, env)``: words 0/1 for player 1's
  mask/random action, 2/3 for player 2's (``ops.fused_actor.select``);
* ``params2=None``: player 2 is the L0 opponent (action -1); otherwise
  its net acts on the half-swapped observation;
* ``env_params.random_start``: starts and resets from Philox stream 1
  (``ops.fused_rollout.random_reset_vals``);
* ``compute_dtype`` ``"float32"`` or ``"bfloat16"`` (weights stored bf16).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import replace
from typing import NamedTuple

import torch

from merging_gym_tpu_torch import kernels
from merging_gym_tpu_torch.core import constants as C
from merging_gym_tpu_torch.core.env import EnvParams, observe, swap_obs
from merging_gym_tpu_torch.core.vector import autoreset_step, reset_batch
from merging_gym_tpu_torch.device import tensor_device
from merging_gym_tpu_torch.ops import philox
from merging_gym_tpu_torch.ops.fused_actor import greedy_threshold, select
from merging_gym_tpu_torch.ops.fused_mlp import (QNET_MIN_TILES,
                                                 cast_weights,
                                                 compute_dtype_of, micro_tile,
                                                 mlp_plain, sm_count,
                                                 weight_chunk)
from merging_gym_tpu_torch.ops.fused_rollout import (as_events,
                                                     random_reset_vals,
                                                     rewards_cfg)
from merging_gym_tpu_torch.utils.profiling import span

# Bytes each env-step writes: actions (8), rewards (8), done/winner/col (12).
K6_BYTES_PER_ENV_STEP = 28

# Envs per block at most (policy_rollout.cu:kPolicyRowsMax): the block's
# first `rows` threads own one env each.
K6_ROWS_MAX = 32
# Micro-tiles of the largest layer per block that the pick aims for: six
# warps of them, twice K3's aim, since a K6 block runs alone on its SM
# (chip_smoke.py:k6_sweep times every tile).
K6_MIN_TILES = 2 * QNET_MIN_TILES
_ROLLOUT_ARGS = ([ctypes.c_void_p] * 12 + [ctypes.c_void_p] * 5
                 + [ctypes.c_int] * 12
                 + [ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
                    ctypes.c_int, ctypes.c_int]
                 + [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int]
                 + [ctypes.c_float] * 5 + [ctypes.c_void_p])


class PolicyGeometry(NamedTuple):
    """Launch geometry of K6: ``rows`` envs per block, ``rm`` x ``rn``
    micro-tiles, both nets ``resident`` in shared memory for the launch or
    streamed through two buffers of ``chunk`` elements every step, and
    ``smem`` bytes of shared memory per block."""
    rows: int
    rm: int
    rn: int
    resident: bool
    chunk: int
    smem: int


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def _stride(k: int) -> int:  # qnet_tiled.cuh:act_stride
    return (k + 3) // 4 * 4 + 4


def net_smem(widths, elem: int) -> int:
    """Bytes of one net held whole in shared memory (qnet_tiled.cuh:
    NetSmem): each weight and bias 16-byte aligned."""
    return sum(_align16(k * j * elem) + _align16(j * elem)
               for k, j in zip(widths[:3], widths[1:]))


def policy_smem(widths, rows: int, elem: int, nets: int, resident: bool,
                chunk: int = 0) -> int:
    """Shared-memory bytes of one block (policy_rollout.cu:PolicySmem):
    the ``nets`` resident nets or two weight buffers of ``chunk`` elements,
    an input tile per net, the shared h1 and h2 tiles, and each net's f32
    q."""
    d_in, h1, h2, a = widths
    n = (nets * net_smem(widths, elem) if resident
         else _align16(2 * chunk * elem))
    n += nets * _align16(rows * _stride(d_in) * elem)
    n += _align16(rows * _stride(h1) * elem) + _align16(rows * _stride(h2)
                                                        * elem)
    return n + _align16(rows * a * 4) + (nets - 1) * rows * a * 4


def policy_tiling(widths: tuple, rows: int, elem: int, nets: int,
                  min_tiles: int = K6_MIN_TILES) -> PolicyGeometry | None:
    """K6's geometry for blocks of ``rows`` envs of ``nets`` Q-nets of
    ``widths`` in ``elem``-byte weights: resident where the nets fit beside
    the tiles, else streamed through buffers that take the rest of the
    block's shared memory (``ops.fused_mlp.weight_chunk``), else None.
    The micro-tile is ``ops.fused_mlp.micro_tile``'s."""
    rm, rn = micro_tile(widths, rows, min_tiles)
    smem = policy_smem(widths, rows, elem, nets, True)
    if smem <= kernels.SMEM_LIMIT:
        return PolicyGeometry(rows, rm, rn, True, 0, smem)
    chunk = weight_chunk(widths, kernels.SMEM_LIMIT - policy_smem(
        widths, rows, elem, nets, False), elem)
    if chunk is None:
        return None
    return PolicyGeometry(rows, rm, rn, False, chunk,
                          policy_smem(widths, rows, elem, nets, False, chunk))


@functools.lru_cache(maxsize=None)
def policy_geometry(num_envs: int, widths: tuple, elem: int, sms: int,
                    two_nets: bool) -> PolicyGeometry:
    """K6's launch geometry for ``num_envs`` envs on ``sms`` SMs:
    :func:`policy_tiling` of the smallest power of two of envs per block
    (at most ``K6_ROWS_MAX``) that needs no more blocks than the card has
    SMs, halved while neither layout fits shared memory.  At the CLI's
    4,096 envs on 132 SMs: 32 envs a block in 128 blocks, the f32 and bf16
    reference nets resident."""
    top = 1
    while top < K6_ROWS_MAX and -(-num_envs // top) > sms:
        top *= 2
    for rows in (top >> i for i in range(top.bit_length())):
        g = policy_tiling(widths, rows, elem, 2 if two_nets else 1)
        if g is not None:
            return g
    raise ValueError(f"a Q-net of widths {tuple(widths)} does not fit the "
                     f"{kernels.SMEM_LIMIT} B of shared memory of a block")


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
        a1 = select(mlp_plain(w1, obs, dtype), bits[0], bits[1], greedy, thr)
        if w2 is None:
            a2 = torch.full_like(a1, C.ACTION_NONE)
        else:
            a2 = select(mlp_plain(w2, swap_obs(obs), dtype), bits[2],
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
    with span("mgt.eval.prologue"):
        env_params, dtype, dev = _prepare(params1, params2, env_params,
                                          compute_dtype, device)
        on_card = dev.type != "cpu"
        if on_card:
            out = empty_events(num_steps, num_envs, dev)
            w1 = _card_weights(params1, dtype, dev)
            w2 = (_card_weights(params2, dtype, dev) if params2 is not None
                  else None)
    with span("mgt.eval.rollout"):
        if not on_card:
            return fused_policy_rollout_plain(
                num_steps, num_envs, params1, params2, greedy=greedy,
                epsilon=epsilon, seed=seed, env_params=env_params,
                compute_dtype=compute_dtype, device=dev)
        launch_policy_rollout(out, w1, w2, greedy=greedy, epsilon=epsilon,
                              seed=seed, env_params=env_params)
        return as_events(out)


def _card_weights(params, dtype, dev) -> list:
    """``ops.fused_mlp.cast_weights`` onto the card ``dev``: a net held in
    host memory (arrays or CPU tensors) is uploaded, under the span
    ``mgt.upload``."""
    w = params["fc0"]["w"]
    if isinstance(w, torch.Tensor) and w.device.type != "cpu":
        return cast_weights(params, dtype, dev)
    with span("mgt.upload"):
        return cast_weights(params, dtype, dev)


def launch_policy_rollout(out: dict, w1: list, w2: list | None, *,
                          greedy: bool, epsilon: float, seed: int,
                          env_params: EnvParams,
                          geometry: PolicyGeometry | None = None) -> None:
    """Launch K6 into the preallocated int32/f32 buffers of ``out``, in
    ``geometry`` (by default :func:`policy_geometry`'s)."""
    T, _, N = out["actions"].shape
    bufs = [out[k] for k in ("actions", "rewards", "done", "winner",
                             "collision")]
    dev = kernels.require_cuda(*bufs, *w1, *(w2 or []))
    d_in, h1 = w1[0].shape
    h2, a = w1[4].shape
    if w2 is not None and [w.shape for w in w2] != [w.shape for w in w1]:
        raise ValueError("both players' nets must have the same shapes")
    g = geometry or policy_geometry(N, (d_in, h1, h2, a),
                                    w1[0].element_size(), sm_count(dev),
                                    w2 is not None)
    k0, k1 = philox.seed_key(seed)
    fn = kernels.function("policy_rollout", "mgt_policy_rollout",
                          _ROLLOUT_ARGS)
    rc = fn(*map(kernels.ptr, w1), *map(kernels.ptr, w2 or [None] * 6),
            *map(kernels.ptr, bufs),
            T, N, d_in, h1, h2, a, g.rows, g.rm, g.rn, int(g.resident),
            g.chunk, g.smem,
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
