"""The whole recurrent DQN (DRQN) trainer on the card (K9).

Replaces ``merging_gym_tpu/ops/fused_drqn.py:_kernel`` (both call forms:
``_call``, the VMEM ring, and ``_call_hbm``, the HBM ring; entry
``fused_drqn_chunk``) with its helpers ``_cell_fwd``, ``_cell_fwd_pair``,
``drqn_learn_math`` and ``slab_to_batch``.  Per training step: the LSTM
actor of both seats from their own per-env h/c, the Phi(eps)-greedy pick,
the env step, the write of window slot ``wl + 1`` (the pre-reset obs and
the transition into it), the auto-reset, on the last step of a window its
flush into ring round ``(s // L) % R`` and the next window started at the
post-reset obs, then, once the ring has filled, a learn on one
(round, lane-window) draw of B whole windows: truncated BPTT through the
eval and target nets' ``L + 1``-step unrolls from zero state, per-timestep
Double-DQN targets, burn-in and first-done masks, Adam, with the target
sync before the update; last the metrics and the h/c of both seats zeroed
where the episode ended.

On the TPU the T steps of a chunk were the sequential grid of one launch.
On the H100 a step is one hand-written kernel before the ring has filled
and four after (``kernels/csrc/drqn_trainer.cu``), issued by
:func:`launch_drqn` in a host loop on one stream, K5's design:
``drqn_act`` (act / env / window / flush, a few envs a block, geometry
:func:`act_geometry`), then on a learning step the
three kernels of :class:`Learner`: ``drqn_learn_in`` (the valid count and
the input side of both nets, register-tiled), ``drqn_learn_rec`` (one warp
per window and net: the recurrence forward and back, the heads, the
targets) and ``drqn_learn_grad`` (every gradient summed in the plain
version's order, the target sync, Adam).  Their geometry comes from
:func:`learn_geometry`, and the row factors pass between them through a
workspace (:data:`WS_GROUPS`).  The flush comes before the learner, which
may sample the round flushed this step.  The learn gate, the learn count, the
target sync and Adam's step depend only on the host counters ``warm``,
``steps % (L * R)`` and ``learns``, so nothing is read back inside a chunk.
The plain version (:func:`fused_drqn_chunk_plain`) repeats the kernels'
arithmetic and summation order step for step, so on the card the two
agree bit for bit.

Layouts.  The carry is the JAX package's dict, with the same keys, except
that a parameter set is one flat f32 buffer of 7,949 values in the
``[in, out]`` layout of the port's other kernels (fc1 w [10][200], b;
fc2 w [200][16], b; w_ih [16][64], b_ih; w_hh [16][64], b_hh; fc3 w
[16][16], b; fc4 w [16][5], b; gate columns in torch order i, f, g, o),
where JAX keeps transposed 12-tuples (:func:`drqn_carry_from_numpy`
converts).  ``b_ih`` and ``b_hh`` get the same gradient and stay two
parameters with their own moments, so params round-trip to JAX.  The env
rows ``f32[75, n]`` (pos 2, vel 2, xy 4, winner, t, episode reward, then
h, c of seat 1 and h, c of seat 2), the window ``f32[(L + 1) * 16, n]``
and the ring ``f32[R * (L + 1) * 16, n]`` keep JAX's layout: slot s of a
window is 16 rows, obs_s in rows 0:10, then action, reward and done of
the transition into it in rows 10, 11, 12; rows 13:16 are padding (the
TPU's sublane alignment).  The port keeps them so that a carry and a ring
move between the packages unchanged and are compared field by field; on
the card the 3 pad rows cost 19% of the window bytes, which are small
(1.1 MB sampled per learn at B 1,024).  ``ring_hbm`` is recorded only: the
ring always lives in device memory (JAX's two ring modes compute the same
values, the patch that lets the round flushed this step be sampled
included).

Randomness: Philox at counter ``(global step, env, stream, 0)`` under the
chunk's seed.  Stream 0 gives both seats' picks (words 0/1 the mask and the
action of seat 1, words 2/3 of seat 2, JAX's four words per env per step),
stream 1 the random start.  Greedy mode draws nothing, and greedy with
random starts is refused, as in JAX.  The learner's ``rounds`` and ``cols``
come from a CPU ``torch.Generator`` seeded with ``seed ^ 0xD7D7``, uploaded
as int32; explicit streams stay injectable.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from merging_gym_tpu_torch import kernels
from merging_gym_tpu_torch.core import constants as C
from merging_gym_tpu_torch.core import env as core_env
from merging_gym_tpu_torch.core.geometry import lon2coord
from merging_gym_tpu_torch.device import resolve_device
from merging_gym_tpu_torch.nn.lstm import LSTM_HIDDEN, drqn_init
from merging_gym_tpu_torch.ops import fused_mlp as FM
from merging_gym_tpu_torch.ops import fused_trainer as FT
from merging_gym_tpu_torch.ops import philox
from merging_gym_tpu_torch.ops.fused_actor import greedy_threshold, select
from merging_gym_tpu_torch.ops.fused_rollout import (random_reset_vals,
                                                     rewards_cfg)

HID = LSTM_HIDDEN   # 16
H1 = 200            # fc1 width (main.py:60-61)
IN_DIM = C.OBS_DIM  # 10
A = C.NUM_ACTIONS   # 5
SLOT = 16           # rows per window slot (see the module docstring)
ENV_ROWS = 11 + 4 * HID  # 75

# (name, shape) of the flat parameter layout, in order.
LAYOUT = (("fc1.w", (IN_DIM, H1)), ("fc1.b", (H1,)),
          ("fc2.w", (H1, HID)), ("fc2.b", (HID,)),
          ("lstm.w_ih", (HID, 4 * HID)), ("lstm.b_ih", (4 * HID,)),
          ("lstm.w_hh", (HID, 4 * HID)), ("lstm.b_hh", (4 * HID,)),
          ("fc3.w", (HID, HID)), ("fc3.b", (HID,)),
          ("fc4.w", (HID, A)), ("fc4.b", (A,)))
P = sum(math.prod(s) for _, s in LAYOUT)  # 7,949

# Windows per summation tile (drqn_trainer.cu:kWindows): a gradient entry
# sums each tile's 4 * L rows in order, window by window, then the tiles in
# order; the plain version repeats it.
LEARN_WINDOWS = 4

_ACT_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 14
             + [ctypes.c_uint32] * 4 + [ctypes.c_int] + [ctypes.c_float] * 5
             + [ctypes.c_void_p])
_IN_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_REC_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_float]
             + [ctypes.c_void_p])
_GRAD_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
              + [ctypes.c_float] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


# ---------------------------------------------------------------------------
# Parameter layouts
# ---------------------------------------------------------------------------

def _views(flat: torch.Tensor) -> list:
    """The twelve ``[in, out]`` views of a flat parameter buffer."""
    out, o = [], 0
    for _, shape in LAYOUT:
        k = math.prod(shape)
        out.append(flat[o:o + k].view(shape))
        o += k
    return out


def drqn_params_to_t(params: dict, device=None) -> torch.Tensor:
    """An ``nn.lstm.drqn_init`` dict (tensors or arrays) -> one flat f32
    buffer in the port's layout (:data:`LAYOUT`)."""
    parts = []
    for name, shape in LAYOUT:
        layer, key = name.split(".")
        x = params[layer][key]
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.array(x, np.float32))
        x = x.to(device=device, dtype=torch.float32)
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, the K9 "
                             f"net needs {shape}")
        parts.append(x.reshape(-1))
    return torch.cat(parts)


def t_to_drqn_params(flat: torch.Tensor) -> dict:
    """A flat buffer -> the ``nn.lstm`` param dict (views)."""
    out: dict = {}
    for (name, _), v in zip(LAYOUT, _views(flat)):
        layer, key = name.split(".")
        out.setdefault(layer, {})[key] = v
    return out


def _flat_from_jax_t(pt, device) -> torch.Tensor:
    """JAX's transposed 12-tuple (weights ``[out, in]``, biases ``[k, 1]``)
    -> a flat buffer."""
    return torch.cat([torch.tensor(np.asarray(a, np.float32).T.reshape(-1),
                                   device=device) for a in pt])


# ---------------------------------------------------------------------------
# Plain arithmetic of the kernels
# ---------------------------------------------------------------------------

def _acc(x, w):
    """``sum_k x[..., k] * w[k, :]`` in k order from 0 (every kernel sum
    starts at 0 and rounds each multiply and each add)."""
    acc = torch.zeros(*x.shape[:-1], w.shape[1], dtype=torch.float32,
                      device=x.device)
    for k in range(w.shape[0]):
        acc = acc + x[..., k:k + 1] * w[k]
    return acc


def _back(d, w):
    """``sum_j w[k, j] * d[..., j]`` in j order from 0."""
    acc = torch.zeros(*d.shape[:-1], w.shape[0], dtype=torch.float32,
                      device=d.device)
    for j in range(w.shape[1]):
        acc = acc + w[:, j] * d[..., j:j + 1]
    return acc


def _relu(x):
    return torch.clamp_min(x, 0.0)


def _sigmoid(x):
    """``1 / (1 + exp(-x))`` as one IEEE division, as the kernels spell it
    (a Python scalar over a CUDA tensor would multiply by a reciprocal)."""
    return torch.ones_like(x) / (1.0 + torch.exp(-x))


def _gates(v, x2, h):
    """``((x2 w_ih + b_ih) + h w_hh) + b_hh``, the JAX order."""
    return (_acc(x2, v[4]) + v[5] + _acc(h, v[6])) + v[7]


def _tail(g, c):
    """LSTM elementwise tail: gate pre-activations [..., 64] and the
    previous cell -> (gi, gf, gg, go, c_new, tanh(c_new), h_new)."""
    gi, gf = _sigmoid(g[..., 0:HID]), _sigmoid(g[..., HID:2 * HID])
    gg, go = torch.tanh(g[..., 2 * HID:3 * HID]), _sigmoid(g[..., 3 * HID:])
    c_new = gf * c + gi * gg
    tc = torch.tanh(c_new)
    return gi, gf, gg, go, c_new, tc, go * tc


def cell_fwd(flat, x, h, c):
    """One recurrent actor step, the arithmetic of ``drqn_act`` (and of
    JAX's ``_cell_fwd``): x [n, 10], h/c [n, 16] -> (q [n, A], h, c)."""
    v = _views(flat)
    x2 = _acc(_relu(_acc(x, v[0]) + v[1]), v[2]) + v[3]
    *_, c_new, _, h_new = _tail(_gates(v, x2, h), c)
    q = _acc(_relu(_acc(h_new, v[8]) + v[9]), v[10]) + v[11]
    return q, h_new, c_new


def _unroll(v, X):
    """Both halves of one net's learner forward over windows X [B, T1, 10]:
    the input side over all timesteps, then the recurrence from zero state.
    Returns the layers the backward reads."""
    B, T1 = X.shape[0], X.shape[1]
    z1 = _acc(X, v[0]) + v[1]
    x2 = _acc(_relu(z1), v[2]) + v[3]
    h = torch.zeros(B, HID, device=X.device)
    c = torch.zeros(B, HID, device=X.device)
    steps = []
    for t in range(T1):
        gi, gf, gg, go, c_new, tc, h = _tail(_gates(v, x2[:, t], h), c)
        steps.append((gi, gf, gg, go, c, tc, h))
        c = c_new
    cells = [torch.stack(s, dim=1) for s in zip(*steps)]
    z3 = _acc(cells[6], v[8]) + v[9]
    q = _acc(_relu(z3), v[10]) + v[11]
    return {"z1": z1, "x2": x2, "cells": cells, "z3": z3, "q": q}


def _masks(done, burn_in):
    """Past burn-in and before the first in-window episode end: f32
    [B, L] of 0/1 (``fused_drqn.py:294-302``)."""
    ended = torch.zeros_like(done[:, 0])
    cols = []
    for t in range(done.shape[1]):
        cols.append(1.0 - ended if t >= burn_in else torch.zeros_like(ended))
        ended = torch.maximum(ended, done[:, t])
    return torch.stack(cols, dim=1)


def _grads_plain(p, tp, batch, *, gamma, burn_in, windows):
    """Gradient (flat layout), loss and valid count of one learn, as the
    learner's kernels (``drqn_learn_in``, ``drqn_learn_rec``,
    ``drqn_learn_grad``) compute them.  ``batch`` rows-first:
    obs [B, L+1, 10], action [B, L], reward [B, L], done [B, L] (f32)."""
    f32 = torch.float32
    X = batch["obs"].to(f32)
    act = batch["action"].to(torch.int64)
    rew, done = batch["reward"].to(f32), batch["done"].to(f32)
    B, L = act.shape
    v = _views(p)
    fe, ft = _unroll(v, X), _unroll(_views(tp), X)

    # Valid count as an integer, then JAX's floor and 2 / msum as one IEEE
    # division on the device.
    mask = _masks(done, burn_in)
    msum = torch.clamp_min(mask.sum().to(torch.int64), 1).to(f32)
    two = torch.full_like(msum, 2.0) / msum
    q, qt = fe["q"], ft["q"]
    a_star = torch.argmax(q[:, 1:], dim=-1, keepdim=True)
    boot = qt[:, 1:].gather(-1, a_star)[..., 0]
    target = rew + (gamma * boot) * (1.0 - done)
    diff = q[:, :L].gather(-1, act[..., None])[..., 0] - target
    onehot = (act[..., None] == torch.arange(A, device=X.device)).to(f32)
    dq = onehot * ((two * mask) * diff)[..., None]              # [B, L, A]
    lterm = (mask * diff) * diff

    # Backward: the heads for t < L, then the LSTM from t = L-1 down to 0.
    gi, gf, gg, go, cprev, tc, h = (x[:, :L] for x in fe["cells"])
    z3 = fe["z3"][:, :L]
    dz3 = _back(dq, v[10]) * (z3 > 0.0).to(f32)
    dh_head = _back(dz3, v[8])
    dh_next = torch.zeros(B, HID, device=X.device)
    dc_next = torch.zeros(B, HID, device=X.device)
    das = [None] * L
    for t in reversed(range(L)):
        dh = dh_head[:, t] + dh_next
        do = dh * tc[:, t]
        dc = ((dh * go[:, t]) * (1.0 - tc[:, t] * tc[:, t])) + dc_next
        das[t] = torch.cat([
            ((dc * gg[:, t]) * gi[:, t]) * (1.0 - gi[:, t]),
            ((dc * cprev[:, t]) * gf[:, t]) * (1.0 - gf[:, t]),
            (dc * gi[:, t]) * (1.0 - gg[:, t] * gg[:, t]),
            (do * go[:, t]) * (1.0 - go[:, t])], dim=-1)
        dh_next = _back(das[t], v[6])
        dc_next = dc * gf[:, t]
    da = torch.stack(das, dim=1)                                # [B, L, 64]
    dx2 = _back(da, v[4])
    z1 = fe["z1"][:, :L]
    dz1 = _back(dx2, v[2]) * (z1 > 0.0).to(f32)
    hprev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :L - 1]], dim=1)

    # Per-block sums over the block's windows, rows window by window in t
    # order, then the blocks in order (grad_kernel).
    tile = windows * L

    def rows(x):
        return x.reshape(B * L, -1)

    def out(a, b):
        return FT._outer_sum(rows(a), rows(b), tile)

    def bsum(d):
        return FT._batch_sum(rows(d), tile)

    parts = [out(X[:, :L], dz1), bsum(dz1), out(_relu(z1), dx2), bsum(dx2),
             out(fe["x2"][:, :L], da), bsum(da), out(hprev, da), bsum(da),
             out(h, dz3), bsum(dz3), out(_relu(z3), dq), bsum(dq)]
    grad = torch.cat([x.reshape(-1) for x in parts])
    loss = bsum(lterm)[0] / msum
    return grad, loss, msum


def drqn_learn_math(p, tp, m, v, batch, t, *, gamma, lr, num_actions=A,
                    seq_len, burn_in):
    """One BPTT Double-DQN + Adam step; returns ``(new_p, new_m, new_v,
    loss)``.

    The plain learner of K9 with the signature of the JAX
    ``drqn_learn_math``: flat buffers (``p``, ``tp``, ``m``, ``v``),
    ``batch`` env-last (obs a list of L+1 ``[10, B]``, action i32 ``[L,
    B]``, reward ``[L, B]``, done f32 in {0, 1} ``[L, B]``), ``t`` the
    1-based Adam step.  Its loss and gradient are those of
    ``agents.drqn.drqn_loss``.
    """
    if num_actions != A or len(batch["obs"]) != seq_len + 1:
        raise ValueError(f"K9 runs the {IN_DIM} -> {A} net over seq_len + 1 "
                         "obs")
    rows = {"obs": torch.stack([o.T for o in batch["obs"]], dim=1),
            "action": batch["action"].T, "reward": batch["reward"].T,
            "done": batch["done"].T}
    grad, loss, _ = _grads_plain(p, tp, rows, gamma=gamma, burn_in=burn_in,
                                 windows=LEARN_WINDOWS)
    new_p, new_m, new_v = FT._adam_plain(p, m, v, grad, int(t), lr)
    return new_p, new_m, new_v, loss


def slab_to_batch(slab: torch.Tensor, L: int, obs_dim: int = IN_DIM) -> dict:
    """Sampled window slab [WF, B] -> :func:`drqn_learn_math` batch."""
    obs = [slab[s * SLOT:s * SLOT + obs_dim] for s in range(L + 1)]
    action = torch.stack([slab[(t + 1) * SLOT + obs_dim].to(torch.int32)
                          for t in range(L)])
    reward = torch.stack([slab[(t + 1) * SLOT + obs_dim + 1]
                          for t in range(L)])
    done = torch.stack([slab[(t + 1) * SLOT + obs_dim + 2]
                        for t in range(L)])
    return {"obs": obs, "action": action, "reward": reward, "done": done}


def _rows_batch(slab: torch.Tensor, L: int) -> dict:
    """A window slab [WF, B] rows-first, for :func:`_grads_plain`."""
    s = slab.T.reshape(slab.shape[1], L + 1, SLOT)
    return {"obs": s[:, :, :IN_DIM], "action": s[:, 1:, IN_DIM],
            "reward": s[:, 1:, IN_DIM + 1], "done": s[:, 1:, IN_DIM + 2]}


# ---------------------------------------------------------------------------
# Carry
# ---------------------------------------------------------------------------

def _obs_rows(e):
    """The 10 obs rows of env rows ``e`` (pos 2, vel 2, xy 4, ...)."""
    return torch.stack([
        e[6] - e[4], e[7] - e[5], e[3] - e[2], C.END_POINT - e[0], e[2],
        e[4] - e[6], e[5] - e[7], e[2] - e[3], C.END_POINT - e[1], e[3]])


def fused_drqn_init(seed: int, cfg, env_params, num_envs: int,
                    opp_params=None, *, learn_batch=None, ring_hbm=None,
                    device=None) -> dict:
    """Fresh training state for K9 (the JAX ``fused_drqn_init``).

    ``cfg``: ``agents.drqn.DRQNConfig``.  ``cfg.memory_capacity`` counts
    windows and must be ``k * num_envs`` with k = R >= 2 (the ring holds
    the R latest flushes); ``learn_batch`` (default ``num_envs``): whole
    windows per learn, one lane window of a uniformly drawn round, a
    multiple of 128 dividing ``num_envs``.  These are JAX's checks, some of
    them TPU alignments, kept so both packages refuse the same
    configurations.  The nets and random starts draw from a generator
    seeded with ``seed`` on ``device`` (default ``cuda``).
    """
    if num_envs % 128 != 0:
        raise ValueError(f"num_envs must be a multiple of 128, got {num_envs}")
    B = num_envs if learn_batch is None else int(learn_batch)
    if B % 128 != 0 or num_envs % B != 0:
        raise ValueError("learn_batch must be a multiple of 128 dividing "
                         f"num_envs, got learn_batch={B} num_envs={num_envs}")
    R = cfg.memory_capacity // num_envs
    if R < 2 or cfg.memory_capacity != R * num_envs:
        raise ValueError("memory_capacity must be k*num_envs with k>=2, got "
                         f"capacity={cfg.memory_capacity} num_envs={num_envs}")
    if cfg.opponent == FT.OPP_FROZEN and opp_params is None:
        raise ValueError("frozen opponent needs params")
    if cfg.obs_dim != IN_DIM or cfg.num_actions != A:
        raise ValueError(f"K9 runs the {IN_DIM} -> {A} net")
    L = int(cfg.seq_len)
    dev = resolve_device(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    p = drqn_params_to_t(drqn_init(generator, IN_DIM, A, device=dev), dev)
    tp = drqn_params_to_t(drqn_init(generator, IN_DIM, A, device=dev), dev)
    opp = drqn_params_to_t(opp_params, dev) if opp_params is not None else p
    n = num_envs
    env = torch.zeros(ENV_ROWS, n, device=dev)
    env[0:8] = FT._init_env_rows(env_params, generator, n)
    WF = (L + 1) * SLOT
    win = torch.zeros(WF, n, device=dev)
    # Slot 0 of the first window is the initial observation.
    win[0:IN_DIM] = _obs_rows(env[0:8])
    if ring_hbm is None:  # the JAX rule, recorded only
        ring_hbm = R * WF * n * 4 > 24 * 1024 * 1024
    return {
        "p": p, "tp": tp, "m": torch.zeros_like(p), "v": torch.zeros_like(p),
        "opp": opp, "env": env, "win": win,
        "ring": torch.zeros(R * WF, n, device=dev),
        "ring_hbm": int(bool(ring_hbm)),
        "R": R, "n": n, "B": B, "L": L, "warm": 0, "learns": 0, "steps": 0,
        "env_steps": 0, "episodes": 0.0, "collisions": 0.0, "wins": 0.0,
        "sum_ep_reward": 0.0, "last_loss": 0.0,
    }


def drqn_carry_from_numpy(carry: dict, device=None) -> dict:
    """A JAX fused DRQN carry with numpy (or JAX) leaves -> the port's carry
    on ``device``: the transposed 12-tuples become flat buffers; the env
    rows, window and ring keep their layout."""
    dev = resolve_device(device)
    out = dict(carry)
    for k in ("p", "tp", "m", "v", "opp"):
        out[k] = _flat_from_jax_t(carry[k], dev)
    for k in ("env", "win", "ring"):
        out[k] = torch.tensor(np.asarray(carry[k], np.float32), device=dev)
    for k in ("R", "n", "B", "L", "ring_hbm", "warm", "learns", "steps",
              "env_steps"):
        out[k] = int(carry.get(k, 0))
    for k in ("episodes", "collisions", "wins", "sum_ep_reward",
              "last_loss"):
        out[k] = float(carry[k])
    return out


def drqn_launch_cfg(carry, env_params, seed) -> tuple:
    """``(seed, max_steps, warm, learns, base)``: the JAX kernel's SMEM cfg
    vector, here the host integers that schedule a chunk; ``base`` is the
    prior global steps mod L * R, the joint window and ring phase."""
    return (int(seed), env_params.max_steps, int(carry["warm"]),
            int(carry["learns"]), carry.get("steps", 0) % (carry["L"]
                                                           * carry["R"]))


def drqn_chunk_learns(carry, num_steps) -> int:
    """Learn count added by a ``num_steps`` chunk (ring-full gated)."""
    full_at = carry["R"] * carry["L"] - 1
    prior = carry.get("steps", 0)
    warmup_left = 0 if carry["warm"] else max(full_at - prior, 0)
    return max(num_steps - warmup_left, 0)


def apply_drqn_chunk(carry, out, num_steps, met_sum, loss) -> dict:
    """Fold a chunk's outputs (``out``: p, tp, m, v, env, win, ring) back
    into the carry dict: the warm gate, learns, steps and metrics."""
    steps = carry.get("steps", 0) + num_steps
    full_at = carry["R"] * carry["L"] - 1
    return {
        **carry, **out,
        "warm": 1 if steps >= full_at else 0,
        "steps": steps,
        "learns": carry["learns"] + drqn_chunk_learns(carry, num_steps),
        "env_steps": carry["env_steps"] + num_steps * carry["n"],
        "episodes": carry["episodes"] + float(met_sum[0]),
        "collisions": carry["collisions"] + float(met_sum[1]),
        "wins": carry["wins"] + float(met_sum[2]),
        "sum_ep_reward": carry["sum_ep_reward"] + float(met_sum[3]),
        "last_loss": float(loss),
    }


def _schedule(carry, env_params, seed, num_steps, target_sync):
    """Per step ``(i, wl, flush?, ring round, learns?, syncs?, Adam t)``
    from :func:`drqn_launch_cfg` (``fused_drqn.py:416-418,525,559,
    576-578``): the window phase, the flush on its last step into round
    ``(s // L) % R``, and the learn gate, open from global step R*L - 1."""
    _, _, warm, prior, base = drqn_launch_cfg(carry, env_params, seed)
    L, R = carry["L"], carry["R"]
    full_at = R * L - 1
    for i in range(num_steps):
        s = base + i
        learn = bool(warm) or s >= full_at
        lc = prior + (i if warm else i - (full_at - base))
        yield (i, s % L, s % L == L - 1, (s // L) % R, learn,
               learn and lc % target_sync == 0, lc + 1)


# ---------------------------------------------------------------------------
# One chunk: plain version and kernels
# ---------------------------------------------------------------------------

def working_state(carry) -> dict:
    """Working copies of a carry's tensors (the carry stays untouched)."""
    st = {k: carry[k].to(torch.float32).contiguous().clone()
          for k in ("p", "tp", "m", "v", "opp", "env", "win", "ring")}
    dev = st["env"].device
    st["met"] = torch.zeros(4, carry["n"], device=dev)
    st["loss"] = torch.zeros((), device=dev)
    return st


def _finish(carry, st, num_steps):
    out = {k: st[k] for k in ("p", "tp", "m", "v", "env", "win", "ring")}
    met = st["met"].to(torch.float64).sum(dim=1).tolist()
    return apply_drqn_chunk(carry, out, num_steps, met, float(st["loss"]))


def _prepare(cfg, env_params, carry, num_steps, seed, greedy, rounds, cols):
    R, n, B = carry["R"], carry["n"], carry["B"]
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    g = torch.Generator().manual_seed(seed ^ 0xD7D7)
    if rounds is None:
        rounds = torch.randint(0, R, (num_steps,), generator=g)
    if cols is None:
        cols = torch.randint(0, n // B, (num_steps,), generator=g)
    rounds = np.asarray(rounds, dtype=np.int32)
    cols = np.asarray(cols, dtype=np.int32)
    if rounds.shape != (num_steps,) or cols.shape != (num_steps,):
        raise ValueError("rounds/cols must be i32 [num_steps]")
    if (rounds.min() < 0 or rounds.max() >= R or cols.min() < 0
            or cols.max() >= n // B):
        raise ValueError(f"rounds must lie in [0, {R}) and cols in "
                         f"[0, {n // B})")
    if env_params.random_start and greedy:
        raise ValueError("random starts draw from the actors' Philox "
                         "stream, which greedy mode skips; drop one of the "
                         "two")
    if cfg.opponent not in (FT.OPP_L0, FT.OPP_SELFPLAY, FT.OPP_FROZEN):
        raise ValueError(f"unknown opponent mode {cfg.opponent!r}")
    if carry["L"] != cfg.seq_len or carry["p"].numel() != P:
        raise ValueError("the carry does not match the config's seq_len or "
                         "the K9 net")
    return rounds, cols


def fused_drqn_chunk_plain(cfg, env_params, carry, num_steps, seed, *,
                           greedy=False, rounds=None, cols=None) -> dict:
    """Plain PyTorch version of K9 (see :func:`fused_drqn_chunk`)."""
    rounds, cols = _prepare(cfg, env_params, carry, num_steps, seed, greedy,
                            rounds, cols)
    st = working_state(carry)
    n, B, L = carry["n"], carry["B"], carry["L"]
    WF = (L + 1) * SLOT
    key = philox.seed_key(seed)
    thr = greedy_threshold(cfg.epsilon)
    dev = st["env"].device
    f32 = torch.float32
    for i, wl, emit, r_cur, learn, sync, t in _schedule(
            carry, env_params, seed, num_steps, cfg.target_sync):
        gstep = carry["steps"] + i
        env = st["env"]
        pos, vel = env[0:2], env[2:4]
        obs = _obs_rows(env[0:8]).T                              # [n, 10]
        hc = env[11:].T.reshape(n, 4, HID)

        # Both seats' recurrent actors.
        bits = ((None,) * 4 if greedy else
                philox.draw(gstep, n, philox.STREAM_ACTIONS, key, dev))
        q1, h1, c1 = cell_fwd(st["p"], obs, hc[:, 0], hc[:, 1])
        a1 = select(q1, bits[0], bits[1], greedy, thr)
        if cfg.opponent == FT.OPP_L0:
            a2 = torch.full_like(a1, C.ACTION_NONE)
            h2, c2 = hc[:, 2], hc[:, 3]
        else:
            opp = st["p"] if cfg.opponent == FT.OPP_SELFPLAY else st["opp"]
            q2, h2, c2 = cell_fwd(opp, core_env.swap_obs(obs), hc[:, 2],
                                  hc[:, 3])
            a2 = select(q2, bits[2], bits[3], greedy, thr)

        # Env step.
        state = core_env.EnvState(
            pos=pos.T, vel=vel.T, acc=torch.zeros(n, 2, device=dev),
            t=env[9].to(torch.int32), winner=env[8].to(torch.int32),
            done=torch.zeros(n, dtype=torch.bool, device=dev),
            r_acc=torch.zeros(n, 2, device=dev))
        ns, ts = core_env.step(env_params, state,
                               torch.stack([a1, a2], dim=-1))
        done, r1 = ts.done, ts.rewards[:, 0]
        done_f = done.to(f32)

        # Slot wl + 1: the pre-reset obs and the transition into it.
        st["win"][(wl + 1) * SLOT:(wl + 2) * SLOT] = torch.cat([
            ts.obs.T, torch.stack([a1.to(f32), r1, done_f]),
            torch.zeros(SLOT - IN_DIM - 3, n, device=dev)])

        # Auto-reset; on the window's last step, the flush and the next
        # window's first obs (post-reset).
        if env_params.random_start:
            pos_r, vel_r = random_reset_vals(gstep, n, key, f32, dev)
        else:
            pos_r = torch.full((n, 2), C.START_POINT, device=dev)
            vel_r = torch.full((n, 2), C.START_VEL, device=dev)
        d = done[:, None]
        npos = torch.where(d, pos_r, ns.pos)
        nvel = torch.where(d, vel_r, ns.vel)
        nx1, ny1 = lon2coord(npos[:, 0], +1.0)
        nx2, ny2 = lon2coord(npos[:, 1], -1.0)
        rows8 = torch.stack([npos[:, 0], npos[:, 1], nvel[:, 0], nvel[:, 1],
                             nx1, ny1, nx2, ny2])
        if emit:
            st["ring"][r_cur * WF:(r_cur + 1) * WF] = st["win"]
            st["win"][0:IN_DIM] = _obs_rows(rows8)

        if learn:
            if sync:  # the target sync comes before the update
                st["tp"] = st["p"].clone()
            slab = st["ring"][int(rounds[i]) * WF:(int(rounds[i]) + 1) * WF,
                              int(cols[i]) * B:(int(cols[i]) + 1) * B]
            grad, st["loss"], _ = _grads_plain(
                st["p"], st["tp"], _rows_batch(slab, L), gamma=cfg.gamma,
                burn_in=cfg.burn_in, windows=LEARN_WINDOWS)
            st["p"], st["m"], st["v"] = FT._adam_plain(
                st["p"], st["m"], st["v"], grad, t, cfg.lr)

        # Metrics: every reward counts; the win is read from the pre-step
        # obs (main.py:225).
        ep = env[10] + r1
        won = done & (obs[:, 8] > obs[:, 3])
        met = st["met"]
        st["met"] = torch.stack([met[0] + done_f,
                                 met[1] + ts.collision.to(f32),
                                 met[2] + won.to(f32),
                                 met[3] + torch.where(done, ep, 0.0)])
        ep = torch.where(done, 0.0, ep)
        hc_new = torch.stack([h1, c1, h2, c2], dim=1).reshape(n, 4 * HID)
        st["env"] = torch.cat([rows8, torch.stack([
            torch.where(done, 0, ns.winner).to(f32),
            torch.where(done, 0, ns.t).to(f32), ep]),
            torch.where(d, 0.0, hc_new).T])
    return _finish(carry, st, num_steps)


def fused_drqn_chunk(cfg, env_params, carry, num_steps, seed, *,
                     greedy=False, rounds=None, cols=None,
                     act_geom=None) -> dict:
    """Run ``num_steps`` DRQN training steps; returns the new carry.

    ``greedy=True`` makes both actors pure argmax and skips the Philox
    draws; with explicit ``rounds``/``cols`` (i32 ``[num_steps]``; default:
    drawn on the host from ``seed ^ 0xD7D7``) the chunk is then
    deterministic.  A carry on the CPU runs the plain version; on the card
    K9 runs, one launch per step before the ring has filled and four
    after, with no read-back until the chunk ends.  The input carry is
    left as it was.  ``act_geom``: the act kernel's launch geometry in
    place of :func:`act_geometry`'s (a forced partial last block in the
    card's checks); the plain version has none.
    """
    if carry["env"].device.type == "cpu":
        return fused_drqn_chunk_plain(cfg, env_params, carry, num_steps, seed,
                                      greedy=greedy, rounds=rounds, cols=cols)
    rounds, cols = _prepare(cfg, env_params, carry, num_steps, seed, greedy,
                            rounds, cols)
    st = working_state(carry)
    launch_drqn(st, carry, cfg, env_params, num_steps, seed, greedy, rounds,
                cols, act_geom)
    return _finish(carry, st, num_steps)


# ---------------------------------------------------------------------------
# The act kernel on the card: geometry
# ---------------------------------------------------------------------------

# drqn_act (drqn_trainer.cu:act_kernel): floats a row of a pass of its
# arrays (kActRowFloats: the obs, h and c before the step, relu(z1), x2,
# h w_hh, the gates, h and c after it, relu(z3), q, each row padded), the
# bytes of one net held whole (kNetBytes: 7,949 floats, 16-byte sized), and
# the tiles of the gates' passes (64 columns a seat's rows, 16 deep) that
# the micro-tile of fc1 and the gates aims for: one a thread.
ACT_ROW_FLOATS = 468
ACT_NET_BYTES = (P * 4 + 15) // 16 * 16         # 31,808
ACT_MIN_TILES = 256


def act_seats(opponent: str) -> tuple:
    """``(seats, nets)`` of an opponent mode: the rows a pass holds per env
    (L0's seat 2 plays no net) and the nets the launch reads (a frozen
    opponent's besides the player's; self-play's seat 2 plays the live
    net)."""
    return ((1, 1) if opponent == FT.OPP_L0 else
            (2, 2) if opponent == FT.OPP_FROZEN else (2, 1))


def act_micro_tile(prows: int) -> tuple:
    """(RM, RN) of fc1's and the gates' passes of ``prows`` rows:
    ``FM.micro_tile``'s rule with ``ACT_MIN_TILES`` on the gates (16 ->
    64)."""
    return FM.micro_tile((HID, 4 * HID, 1, 1), prows, ACT_MIN_TILES)


def act_smem(rows: int, seats: int, resident: int) -> int:
    """Shared-memory bytes of one ``drqn_act`` block (``drqn_trainer.cu:
    act_total``): the first ``resident`` of the launch's nets held whole,
    then the arrays of ``seats * rows`` rows."""
    return resident * ACT_NET_BYTES + seats * rows * ACT_ROW_FLOATS * 4


def act_tiling(rows: int, seats: int = 1, nets: int = 1,
               resident: int | None = None) -> FT.ActGeometry | None:
    """The act geometry for blocks of ``rows`` envs, ``seats * rows`` rows a
    pass, with every one of the launch's ``nets`` held in shared memory
    (``resident`` forces how many, in order; a net not held is read from
    global memory); None where the layout does not fit a block."""
    rm, rn = act_micro_tile(seats * rows)
    held = nets if resident is None else resident
    smem = act_smem(rows, seats, held)
    if smem > kernels.SMEM_LIMIT:
        return None
    return FT.ActGeometry(rows, rm, rn, held, 0, smem)


@functools.lru_cache(maxsize=None)
def act_geometry(num_envs: int, sms: int, seats: int = 1,
                 nets: int = 1) -> FT.ActGeometry:
    """``drqn_act``'s launch geometry for ``num_envs`` envs on ``sms`` SMs:
    the smallest power of two of envs a block (at most
    ``FT.ACT_ROWS_MAX``) that needs no more blocks than the card has SMs,
    every net held (at the CLI's 1,024 envs on 132 SMs: 8 envs a block in
    128 blocks).  Every such layout fits (at most 183,424 B)."""
    top = 1
    while top < FT.ACT_ROWS_MAX and -(-num_envs // top) > sms:
        top *= 2
    return act_tiling(top, seats, nets)


# ---------------------------------------------------------------------------
# The learner on the card: geometry, workspace, launches
# ---------------------------------------------------------------------------

# in_kernel's three layers as a Q-net of widths (in, h1, h2, a): fc1, fc2
# and the gates' input term x2 w_ih (drqn_trainer.cu:in_dims); its shared
# memory is ops/fused_mlp.py:qnet_smem of these widths.
IN_WIDTHS = (IN_DIM, H1, HID, 4 * HID)
IN_ROWS_MAX = 64
# Micro-tiles of fc2 (200 -> 16, the longest chains) per block: every
# thread of the block (the rows sweep of chip_smoke.py times the rows).
IN_MIN_TILES = 256
# Ints per row after in_kernel's layout: its workspace row and gx row
# (drqn_trainer.cu:kInRowInts).
IN_ROW_INTS = 2
REC_WINDOWS_MAX = 4  # rec_kernel: two warps a window, at most 256 threads
# grad_kernel: 256, 512 or 1,024 threads a block, each summing 16 entries
# of a summation tile (drqn_trainer.cu:launch_grad); its shared memory
# parks the partial sums of the tiles in flight, 64 bytes a thread.
GRAD_THREADS = (256, 512, 1024)

# The workspace (drqn_trainer.cu:kWs*): one row per sampled window b and
# timestep t < L, row b * L + t, of these column groups in order, each a
# multiple of 4 floats.  A 1 follows the first factor of every weight
# (x, relu(z1), x2 with h_{t-1}, h, relu(z3)): its bias's row.
WS_GROUPS = (("x", 12), ("z1r", 204), ("dz1", 200), ("dx2", 16),
             ("x2h", 36), ("da", 64), ("h", 20), ("dz3", 16), ("z3r", 20),
             ("dq", 8))
WS_COLS = {name: sum(w for _, w in WS_GROUPS[:i])
           for i, (name, _) in enumerate(WS_GROUPS)}
WS_WIDTH = sum(w for _, w in WS_GROUPS)  # 596
WS_ONES = (WS_COLS["x"] + IN_DIM, WS_COLS["z1r"] + H1,
           WS_COLS["x2h"] + 2 * HID, WS_COLS["h"] + HID,
           WS_COLS["z3r"] + HID)


class LearnGeometry(NamedTuple):
    """Launch geometry of the learner: ``in_rows`` rows (timestep, window)
    per block of ``drqn_learn_in``, its ``in_rm`` x ``in_rn`` micro-tiles,
    ``in_chunk`` floats per weight buffer and ``in_smem`` bytes;
    ``rec_windows`` windows per block of ``drqn_learn_rec`` and its
    ``rec_smem`` bytes; ``grad_threads`` threads per block of
    ``drqn_learn_grad`` and its ``grad_smem`` bytes."""
    in_rows: int
    in_rm: int
    in_rn: int
    in_chunk: int
    in_smem: int
    rec_windows: int
    rec_smem: int
    grad_threads: int
    grad_smem: int


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def rec_smem(windows: int, L: int) -> int:
    """Shared-memory bytes of ``rec_kernel`` (``drqn_trainer.cu:
    RecLayout``): both nets' fc3, fc4 and b_hh, the eval net's w2 in rows
    of 17 and every window's rows of dx2, then per window one step's da,
    the eval net's gates, c_{t-1} and tanh(c_t) at t < L, both nets' h,
    fc3 and q at t <= L, the transitions, dq, dz3 and dh from the heads;
    the windows start on 16 bytes."""
    G, T1 = 4 * HID, L + 1
    shared = (2 * (HID * HID + HID + HID * A + A + G) + H1 * (HID + 1)
              + windows * L * HID)
    per = (G + L * (G + 2 * HID) + 2 * T1 * (2 * HID + A) + 3 * L + L * A
           + 2 * L * HID)
    return 4 * (_pad4(shared) + windows * _pad4(per))


def learn_tiling(B: int, L: int, in_rows: int, rec_windows: int,
                 grad_threads: int = GRAD_THREADS[-1]
                 ) -> LearnGeometry | None:
    """The geometry of ``in_rows`` rows per input-side block,
    ``rec_windows`` windows per recurrence block and ``grad_threads``
    threads per gradient block, or None where the first two do not fit a
    block's shared memory or the windows do not divide B."""
    g = FM.qnet_tiling(IN_WIDTHS, in_rows, 4, q_per_row=IN_ROW_INTS,
                       min_tiles=IN_MIN_TILES)
    smem = rec_smem(rec_windows, L)
    if g is None or smem > kernels.SMEM_LIMIT or B % rec_windows:
        return None
    return LearnGeometry(in_rows, g.rm, g.rn, g.chunk, g.smem, rec_windows,
                         smem, grad_threads, 64 * grad_threads)


@functools.lru_cache(maxsize=None)
def learn_geometry(B: int, L: int, sm_count: int) -> LearnGeometry:
    """The learner's geometry for B windows of L steps on ``sm_count``
    SMs.  Input side: the largest power of two of rows per block, at most
    ``IN_ROWS_MAX``, whose grid (both nets) has a block for every SM.
    Recurrence: the most windows per block, at most ``REC_WINDOWS_MAX``,
    that leave a block for every SM; two blocks of four windows fit an SM,
    so at B 1,024 all 2,048 warps run in one wave.  Each halved while it
    does not fit shared memory; an L whose recurrence does not fit one
    window a block is refused.  Gradients: 1,024 threads a block, the most
    summation tiles in flight (its sweep in chip_smoke.py)."""
    if B <= 0 or B % LEARN_WINDOWS:
        raise ValueError(f"the learner sums tiles of {LEARN_WINDOWS} "
                         f"windows; B = {B} is not a multiple")
    rows = IN_ROWS_MAX
    while rows > 1 and 2 * -(-B * (L + 1) // rows) < sm_count:
        rows //= 2
    while rows > 1 and learn_tiling(B, L, rows, 1) is None:
        rows //= 2
    windows = REC_WINDOWS_MAX
    while windows > 1 and (B % windows or B // windows < sm_count
                           or rec_smem(windows, L) > kernels.SMEM_LIMIT):
        windows //= 2
    g = learn_tiling(B, L, rows, windows)
    if g is None:
        raise ValueError(f"a DRQN learner of L = {L} steps does not fit the "
                         f"{kernels.SMEM_LIMIT} B of shared memory of a "
                         "block")
    return g


def new_workspace(B: int, L: int, device) -> torch.Tensor:
    """The learner's workspace, B * L rows of :data:`WS_WIDTH` floats:
    zeros, and the ones of the bias rows (the kernels write the rest)."""
    ws = torch.zeros(B * L, WS_WIDTH, device=device)
    ws[:, list(WS_ONES)] = 1.0
    return ws


class Learner:
    """The launches of K9's learner (``drqn_learn_in``, ``drqn_learn_rec``
    and ``drqn_learn_grad`` of ``drqn_trainer.cu``) on the working state
    ``st`` (see :func:`working_state`) of a carry of B windows of L steps,
    with their workspace, the gates' input terms ``gx`` of both nets, each
    input-side block's valid count and the batch's.  The state must lie on
    the card: nothing here runs on the CPU.  ``geometry``: a
    :class:`LearnGeometry` in place of :func:`learn_geometry`'s (the sweep
    of chip_smoke.py)."""

    def __init__(self, st, B: int, L: int, geometry=None):
        dev = kernels.require_cuda(*(st[k] for k in (
            "p", "tp", "m", "v", "ring", "loss")))
        if st["p"].numel() != P:
            raise ValueError("K9 needs the 7,949-parameter DRQN")
        self.st, self.B, self.L = st, B, L
        self.g = geometry or learn_geometry(B, L, FM.sm_count(dev))
        self.ws = new_workspace(B, L, dev)
        self.gx = torch.empty(2 * B * (L + 1) * 4 * HID, device=dev)
        self.ncnt = -(-B * (L + 1) // self.g.in_rows)
        self.cnt = torch.empty(self.ncnt, dtype=torch.int32, device=dev)
        self.msum = torch.zeros(1, dtype=torch.int32, device=dev)
        self.stream = kernels.stream_ptr(dev)
        self.fn = {name: kernels.function("drqn_trainer",
                                          f"mgt_drqn_learn_{name}", args)
                   for name, args in (("in", _IN_ARGS), ("rec", _REC_ARGS),
                                      ("grad", _GRAD_ARGS))}

    def _launch(self, name, *args):
        rc = self.fn[name](*args, self.stream)
        kernels.check("drqn_trainer", rc, f"drqn_learn_{name} launch")
        kernels.launch_counts[f"drqn_learn_{name}"] += 1

    def launch(self, cfg, round_: int, col: int, sync: bool, t: int):
        """One learn on the B windows of ring round ``round_``, lanes
        ``col * B ..``: the target is p on a sync step (``tp := p`` comes
        before the update), Adam's step is ``t``; the loss goes to
        ``st["loss"]``."""
        st, g, ptr = self.st, self.g, kernels.ptr
        n, B, L = st["ring"].shape[1], self.B, self.L
        tgt = st["p"] if sync else st["tp"]
        batch = (n, B, L, int(cfg.burn_in), int(round_), int(col))
        self._launch("in", ptr(st["p"]), ptr(tgt), ptr(st["ring"]),
                     ptr(self.ws), ptr(self.gx), ptr(self.cnt), *batch,
                     g.in_rows, g.in_rm, g.in_rn, g.in_chunk, g.in_smem)
        self._launch("rec", ptr(st["p"]), ptr(tgt), ptr(st["ring"]),
                     ptr(self.gx), ptr(self.cnt), ptr(self.ws),
                     ptr(self.msum), *batch, g.rec_windows, self.ncnt,
                     g.rec_smem, float(cfg.gamma))
        c1, c2 = FT.adam_bias_corrections(t)
        self._launch("grad", ptr(self.ws), ptr(st["p"]), ptr(st["tp"]),
                     ptr(st["m"]), ptr(st["v"]), ptr(st["loss"]),
                     ptr(self.msum), B, L, int(sync), float(cfg.lr),
                     FT.ADAM_B1, FT.ADAM_B2, 1.0 - FT.ADAM_B1,
                     1.0 - FT.ADAM_B2, FT.ADAM_EPS, c1, c2, g.grad_threads,
                     g.grad_smem)


def launch_drqn(st, carry, cfg, env_params, num_steps, seed, greedy, rounds,
                cols, act_geom=None) -> None:
    """Issue K9's kernels for ``num_steps`` steps on the current stream,
    updating the working state ``st`` (see :func:`working_state`) in
    place; the act kernel in ``act_geom`` (by default
    :func:`act_geometry`'s)."""
    n, B, L = carry["n"], carry["B"], carry["L"]
    names = ("p", "tp", "m", "v", "opp", "env", "win", "ring", "met", "loss")
    dev = kernels.require_cuda(*(st[k] for k in names))
    if st["p"].numel() != P or st["env"].shape != (ENV_ROWS, n):
        raise ValueError("K9 needs the 7,949-parameter DRQN and 75 env rows")
    learner = Learner(st, B, L)
    g = act_geom or act_geometry(n, FM.sm_count(dev),
                                 *act_seats(cfg.opponent))
    k0, k1 = philox.seed_key(seed)
    stream = kernels.stream_ptr(dev)
    act = kernels.function("drqn_trainer", "mgt_drqn_act", _ACT_ARGS)
    ptr = kernels.ptr
    opp_code = {FT.OPP_L0: 0, FT.OPP_SELFPLAY: 1, FT.OPP_FROZEN: 2}[
        cfg.opponent]
    opp = st["opp"] if cfg.opponent == FT.OPP_FROZEN else st["p"]
    thr = greedy_threshold(cfg.epsilon)
    env_args = (env_params.max_steps, *rewards_cfg(env_params))
    for i, wl, emit, r_cur, learn, sync, t in _schedule(
            carry, env_params, seed, num_steps, cfg.target_sync):
        gstep = (carry["steps"] + i) & philox.MASK32
        rc = act(ptr(st["p"]), ptr(opp), ptr(st["env"]), ptr(st["win"]),
                 ptr(st["ring"]), ptr(st["met"]), n, L, wl, int(emit), r_cur,
                 opp_code, int(greedy), int(env_params.random_start), g.rows,
                 g.rm, g.rn, g.resident, g.chunk, g.smem, gstep, thr, k0, k1,
                 *env_args, stream)
        kernels.check("drqn_trainer", rc, "drqn_act launch")
        kernels.launch_counts["drqn_act"] += 1
        if learn:
            learner.launch(cfg, rounds[i], cols[i], sync, t)
