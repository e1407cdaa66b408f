"""The whole Double-DQN trainer on the card (K5).

Replaces ``merging_gym_tpu/ops/fused_trainer.py:_kernel`` (``pallas_call``
at :535 ``_call`` and :586 ``_call_hbm``, entry ``fused_dqn_chunk``) with
its helpers ``learn_math``, ``_fwd`` and ``_argmax0``.  Per training step:
Phi(eps)-greedy actors for both seats, the env step, the store of a
``[24]`` transition slab into an R-round ring (a lane whose ego has won
keeps its old row), a learn on K (round, lane-window) draws with the
Double-DQN target, the pre-update target sync, hand-derived backprop and
Adam, the metrics and the auto-reset.

On the TPU the T steps of a chunk were the sequential grid of one launch
with all state in VMEM.  On the H100 a step is up to three hand-written
kernels (``kernels/csrc/dqn_trainer.cu``) issued by :func:`fused_dqn_chunk`
in a host loop on the current stream: the act/env/store kernel, then, on a
learning step, the learner (:class:`Learner`): its forward/backward kernel,
which writes each sampled lane's operands to a workspace, and its
gradient kernel, which sums them over the lanes and applies Adam.  Its
launch geometry (:func:`learn_geometry`) follows the batch and the SM
count, independent of the summation tile; the act kernel's
(:func:`act_geometry`, shared with K7's) follows the env count and the SM
count.  Blocks cannot carry state across a grid and the learner reduces
over the batch every step, so a step needs a reduction across blocks; a
per-step sequence gives it without a grid-wide sync, keeps the order of
JAX's step (the learner samples the ring after this step's store; the
actor of step i+1 sees the params after learn i), and needs no read-back: the learn gate, learn count, target sync and
Adam's bias corrections depend only on host counters.

The plain version (:func:`fused_dqn_chunk_plain`) repeats the kernels'
arithmetic and their summation order (``learn_math`` sums each gradient
over ``tile`` lanes in lane order, then over the tiles in order), so on
the card the two agree bit for bit.

The carry is the JAX package's plain dict, with the same keys and
layout: parameter sets as transposed 6-tuples ``(w0T [H1, IN], b0 [H1,
1], w1T, b1, w2T, b2)``, env rows ``f32[11, n]`` (pos 2, vel 2, xy 4,
winner, t, episode reward), the ring ``f32[R * 24, n]``.  Inside a chunk
the sets live in one flat f32 buffer each, in the ``[in, out]`` layout of
the port's other kernels.  Two JAX details have no counterpart here:
``ring_hbm`` is kept in the carry for API parity and changes nothing (the
ring always lives in device memory; JAX's two ring modes are bit-exact,
``tests/test_fused_trainer_e2e.py:234-259``), and there is no
``MGT_FUSED_INTERPRET``: CPU tensors run the plain version.

Randomness: the actors' bits come from Philox at counter ``(global step,
env, 0, 0)`` under the chunk's seed (words 0/1 for seat 1, 2/3 for seat
2), random starts from stream 1 at the same counter.  The learner's
``rounds``/``cols`` draws come from a CPU ``torch.Generator`` seeded with
``seed ^ 0x5EED`` on the host, so the card and the CPU draw the same
streams and explicit streams stay injectable.
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
from merging_gym_tpu_torch.core.geometry import lon2coord, true_div
from merging_gym_tpu_torch.core.vector import reset_batch
from merging_gym_tpu_torch.device import resolve_device
from merging_gym_tpu_torch.nn.mlp import qnet_init
from merging_gym_tpu_torch.ops import philox
from merging_gym_tpu_torch.ops.fused_actor import greedy_threshold, select
from merging_gym_tpu_torch.ops.fused_mlp import (QNET_MIN_TILES,
                                                 compute_dtype_of, micro_tile,
                                                 mlp_plain, mlp_plain_layers,
                                                 qnet_tiling, sm_count,
                                                 weight_chunk)
from merging_gym_tpu_torch.ops.fused_policy_rollout import net_smem
from merging_gym_tpu_torch.ops.fused_rollout import (random_reset_vals,
                                                     rewards_cfg)
from merging_gym_tpu_torch.utils.profiling import span

OPP_L0 = "L0"
OPP_SELFPLAY = "selfplay"
OPP_FROZEN = "frozen"

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # torch defaults (main.py:96)

# Ring fields per round: obs 10 + next_obs 10 + action/reward/done, padded
# to 24 as in the JAX layout.
NUM_F = 24
ENV_ROWS = 11  # pos 2, vel 2, xy 4, winner, t, ep_reward

# Lanes per block of the learner's summation order (the tile of
# learn_tile); fewer where a wide net's tile would not fit.
K5_TILE = 16

# The act kernels of K5 and K7 (kernels/csrc/act_tiled.cuh): envs per block
# at most (kActRowsMax: the block's first `rows` threads own one env each),
# the micro-tiles of the largest layer per pass that the pick aims for (K3's
# three warps: at 8 envs a block chip_smoke.py:act_geometry_sweep put 4x2,
# 100 tiles, 2-4% ahead of 4x1 for K7 and level with it for K5), and the
# opponent modes (kOppL0, kOppSelf, kOppFrozen).
ACT_ROWS_MAX = 32
ACT_MIN_TILES = QNET_MIN_TILES
OPP_MODES = {OPP_L0: 0, OPP_SELFPLAY: 1, OPP_FROZEN: 2}

_ACT_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 15
             + [ctypes.c_uint32, ctypes.c_int] + [ctypes.c_uint32] * 3
             + [ctypes.c_int] + [ctypes.c_float] * 5 + [ctypes.c_void_p])
_FWD_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
             + [ctypes.c_float] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_GRAD_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
              + [ctypes.c_float] * 8 + [ctypes.c_int] + [ctypes.c_void_p] * 2
              + [ctypes.c_int] * 4 + [ctypes.c_void_p])


# ---------------------------------------------------------------------------
# Parameter layouts
# ---------------------------------------------------------------------------

def params_to_t(params, device=None):
    """nn.mlp param dict (tensors or arrays) -> transposed 6-tuple (f32)."""
    out = []
    for i in range(3):
        p = params[f"fc{i}"]
        out.append(torch.as_tensor(p["w"], dtype=torch.float32,
                                   device=device).T)
        out.append(torch.as_tensor(p["b"], dtype=torch.float32,
                                   device=device)[:, None])
    return tuple(out)


def t_to_params(pt):
    """Transposed 6-tuple -> nn.mlp param dict."""
    return {f"fc{i}": {"w": pt[2 * i].T, "b": pt[2 * i + 1][:, 0]}
            for i in range(3)}


def _dims(pt):
    """``(in, h1, h2, a)`` of a transposed 6-tuple."""
    return (pt[0].shape[1], pt[0].shape[0], pt[2].shape[0], pt[4].shape[0])


def _shapes(dims):
    d_in, h1, h2, a = dims
    return [(d_in, h1), (h1,), (h1, h2), (h2,), (h2, a), (a,)]


def _flat(pt) -> torch.Tensor:
    """Transposed 6-tuple -> one flat f32 buffer in the ``[in, out]``
    layout: w0 [in][h1], b0, w1 [h1][h2], b1, w2 [h2][a], b2."""
    return torch.cat([(x.T if i % 2 == 0 else x).reshape(-1)
                      for i, x in enumerate(pt)]).to(torch.float32)


def _natural(flat, dims) -> list:
    """Views ``[w0, b0, w1, b1, w2, b2]`` (``[in, out]`` layout) of a flat
    buffer."""
    out, o = [], 0
    for shape in _shapes(dims):
        n = math.prod(shape)
        out.append(flat[o:o + n].view(shape))
        o += n
    return out


def _transposed(flat, dims):
    """A flat buffer as a transposed 6-tuple (views)."""
    w0, b0, w1, b1, w2, b2 = _natural(flat, dims)
    return (w0.T, b0[:, None], w1.T, b1[:, None], w2.T, b2[:, None])


# ---------------------------------------------------------------------------
# Learner math, plain version (the kernels' arithmetic and summation order)
# ---------------------------------------------------------------------------

def learn_tile(dims, elem_size: int) -> int:
    """Lanes per learner block: the largest power of two up to
    ``K5_TILE`` whose shared-memory tile fits (it divides every batch,
    a multiple of 128)."""
    d_in, h1, h2, a = dims
    tile = kernels.tile_size(K5_TILE, (2 * d_in + 4 * a + h1 + h2 + 4) * 4,
                             (d_in + 2 * h1 + 2 * h2 + a) * elem_size)
    return 1 << (tile.bit_length() - 1)


def _tile_sum(parts):
    total = torch.zeros_like(parts[0])
    for j in range(parts.shape[0]):
        total = total + parts[j]
    return total


def _batch_sum(x, tile):
    """Sum over the batch axis in the kernels' order: each tile of
    ``tile`` lanes in lane order, then the tiles in order."""
    xt = x.reshape(x.shape[0] // tile, tile, *x.shape[1:])
    part = torch.zeros_like(xt[:, 0])
    for r in range(tile):
        part = part + xt[:, r]
    return _tile_sum(part)


def _outer_sum(h, d, tile):
    """``sum_b h[b, :, None] * d[b, None, :]`` in the kernels' order."""
    ht = h.to(torch.float32).reshape(h.shape[0] // tile, tile, -1)
    dt = d.to(torch.float32).reshape(d.shape[0] // tile, tile, -1)
    part = torch.zeros(ht.shape[0], ht.shape[2], dt.shape[2],
                       dtype=torch.float32, device=h.device)
    for r in range(tile):
        part = part + ht[:, r, :, None] * dt[:, r, None, :]
    return _tile_sum(part)


def _grads_plain(wp, wt, batch, *, gamma, mask_terminal, dtype, tile):
    """Loss and gradients of one Double-DQN learn (``learn_math:160-201``).

    ``wp``/``wt``: online and target weights ``[w0, b0, ...]`` in the
    compute dtype, ``[in, out]`` layout; ``batch`` rows-first (obs
    ``[B, in]``).  Returns ``(grads, loss)``, grads in the same layout.
    """
    f32 = torch.float32
    x, xn = batch["obs"].to(f32), batch["next_obs"].to(f32)
    act = batch["action"].to(torch.int64)
    B = x.shape[0]
    q_ne = mlp_plain(wp, xn, dtype)
    q_nt = mlp_plain(wt, xn, dtype)
    h0, h1, h2, q = mlp_plain_layers(wp, x, dtype)
    bootstrap = q_nt.gather(1, torch.argmax(q_ne, dim=1, keepdim=True))[:, 0]
    if mask_terminal:
        bootstrap = bootstrap * (1.0 - batch["done"].to(f32))
    target = batch["reward"].to(f32) + gamma * bootstrap
    diff = q.gather(1, act[:, None])[:, 0] - target

    # Backward: operands in the compute dtype, sums in f32, ReLU masks
    # compared in f32 (learn_math:183-201).
    num_actions = q.shape[1]
    onehot = (act[:, None] == torch.arange(num_actions, device=x.device)
              ).to(f32)
    dq = onehot * ((2.0 / B) * diff)[:, None]                    # [B, A]
    dqc = dq.to(dtype).to(f32)
    w1, w2 = wp[2].to(f32), wp[4].to(f32)
    dz2 = torch.zeros_like(h2, dtype=f32)
    for a in range(num_actions):
        dz2 = dz2 + w2[None, :, a] * dqc[:, a, None]
    dz2 = dz2 * (h2.to(f32) > 0.0).to(f32)                       # [B, H2]
    dz2c = dz2.to(dtype).to(f32)
    dz1 = torch.zeros_like(h1, dtype=f32)
    for j in range(w1.shape[1]):
        dz1 = dz1 + w1[None, :, j] * dz2c[:, j, None]
    dz1 = dz1 * (h1.to(f32) > 0.0).to(f32)                       # [B, H1]
    dz1c = dz1.to(dtype).to(f32)
    grads = [_outer_sum(h0, dz1c, tile), _batch_sum(dz1, tile),
             _outer_sum(h1, dz2c, tile), _batch_sum(dz2, tile),
             _outer_sum(h2, dqc, tile), _batch_sum(dq, tile)]
    loss = true_div(_batch_sum(diff * diff, tile), float(B))
    return grads, loss


def adam_bias_corrections(t: int) -> tuple:
    """``(1 - b1**t, 1 - b2**t)`` in f32 through exp/log, as
    ``learn_math:203-206`` computes them, on the host: the kernel and the
    plain version receive the same two values."""
    tf = torch.tensor(float(t), dtype=torch.float32)
    c1 = 1.0 - torch.exp(tf * math.log(ADAM_B1))
    c2 = 1.0 - torch.exp(tf * math.log(ADAM_B2))
    return float(c1), float(c2)


def _adam_plain(p, m, v, g, t, lr):
    """Adam on flat buffers, op for op the ``dqn_adam`` kernel
    (``learn_math:207-214``); returns ``(p, m, v)``."""
    c1, c2 = adam_bias_corrections(t)
    m = ADAM_B1 * m + (1.0 - ADAM_B1) * g
    v = ADAM_B2 * v + (1.0 - ADAM_B2) * g * g
    upd = lr * true_div(m, c1) / (torch.sqrt(true_div(v, c2)) + ADAM_EPS)
    return p - upd, m, v


def learn_math(p, tp, m, v, batch, t, *, gamma, lr, mask_terminal=False,
               compute_dtype="float32"):
    """One Double-DQN + Adam step; returns ``(new_p, new_m, new_v, loss)``.

    The plain learner of K5, with the signature of the JAX ``learn_math``:
    transposed 6-tuples, ``batch`` env-last (obs ``[IN, n]``, action i32
    ``[n]``, reward ``[n]``, next_obs ``[IN, n]``, done bool ``[n]``),
    ``t`` the 1-based Adam step (int).  ``compute_dtype`` as in JAX:
    forward and backward operands in that dtype, f32 sums, f32 masters,
    gradients, TD math and Adam.
    """
    dtype = compute_dtype_of(compute_dtype)
    dims = _dims(p)
    rows = {"obs": batch["obs"].T, "next_obs": batch["next_obs"].T,
            "action": batch["action"], "reward": batch["reward"],
            "done": batch["done"]}
    fp = _flat(p)
    wp = [w.to(dtype) for w in _natural(fp, dims)]
    wt = [w.to(dtype) for w in _natural(_flat(tp), dims)]
    grads, loss = _grads_plain(wp, wt, rows, gamma=gamma,
                               mask_terminal=mask_terminal, dtype=dtype,
                               tile=learn_tile(dims, wp[0].element_size()))
    g = torch.cat([x.reshape(-1) for x in grads])
    np_, nm, nv = _adam_plain(fp, _flat(m), _flat(v), g, t, lr)
    return (_transposed(np_, dims), _transposed(nm, dims),
            _transposed(nv, dims), loss)


def ring_batch(ring, rounds, cols, W: int, num_f: int, d_in: int) -> dict:
    """The learner's batch, env-last, gathered from a slab ring as the
    learner kernel gathers it: draw k is lane window ``cols[k]`` (``W``
    lanes) of round ``rounds[k]``; a round of ``num_f`` fields holds obs
    at ``[0, d_in)``, next obs at ``[d_in, 2 d_in)``, then action, reward
    and done."""
    s = torch.cat([ring[int(r) * num_f:(int(r) + 1) * num_f,
                        int(c) * W:(int(c) + 1) * W]
                   for r, c in zip(rounds, cols)], dim=1)
    return {"obs": s[0:d_in], "next_obs": s[d_in:2 * d_in],
            "action": s[2 * d_in].to(torch.int64),
            "reward": s[2 * d_in + 1], "done": s[2 * d_in + 2] > 0.5}


def learn_plain(st, prefix: str, batch, sync: bool, t: int, cfg, dims):
    """One learn of the flat set ``prefix`` (``p``, ``tp``, ``m``, ``v``
    and the compute-dtype copies ``pc``, ``tpc``) of the working state
    ``st``, in place, as the learner kernels do it: the target sync
    first, then :func:`learn_math`.  Returns the loss."""
    k = {name: prefix + name for name in ("p", "tp", "m", "v", "pc", "tpc")}
    if sync:  # the target sync comes before the update
        st[k["tp"]], st[k["tpc"]] = st[k["p"]], st[k["pc"]]
    p, tp, m, v = (_transposed(st[k[n]], dims) for n in ("p", "tp", "m", "v"))
    p, m, v, loss = learn_math(p, tp, m, v, batch, t, gamma=cfg.gamma,
                               lr=cfg.lr, mask_terminal=cfg.mask_terminal,
                               compute_dtype=cfg.compute_dtype)
    st[k["p"]], st[k["m"]], st[k["v"]] = _flat(p), _flat(m), _flat(v)
    dtype = st[k["pc"]].dtype
    st[k["pc"]] = (st[k["p"]].to(dtype) if dtype != torch.float32
                   else st[k["p"]])
    return loss


# ---------------------------------------------------------------------------
# Carry
# ---------------------------------------------------------------------------

def fused_dqn_init(seed: int, cfg, env_params, num_envs: int,
                   opp_params=None, *, learn_batch=None, learn_rounds=1,
                   ring_hbm=None, device=None) -> dict:
    """Fresh training state for K5 (the JAX ``fused_dqn_init``).

    ``cfg``: ``agents.dqn.DQNConfig``; ``cfg.batch_size`` is ignored: the
    learner batch is ``num_envs`` unless ``learn_batch`` is given (a
    multiple of 128 dividing ``num_envs``), composed of ``learn_rounds``
    (K) independent (round, lane-window) draws of ``learn_batch // K``
    lanes.  ``cfg.memory_capacity`` must be a multiple of ``num_envs``,
    giving R = capacity // num_envs ring rounds.  The nets and random
    starts draw from a generator seeded with ``seed`` on ``device``
    (default ``cuda``).  ``ring_hbm`` is kept for API parity and changes
    nothing.
    """
    if num_envs % 128 != 0:
        raise ValueError(f"num_envs must be a multiple of 128, got {num_envs}")
    B = num_envs if learn_batch is None else int(learn_batch)
    if B % 128 != 0 or num_envs % B != 0:
        raise ValueError("learn_batch must be a multiple of 128 dividing "
                         f"num_envs, got learn_batch={B} num_envs={num_envs}")
    K = int(learn_rounds)
    if K < 1 or B % (128 * K) != 0:
        raise ValueError("learn_rounds must be >= 1 with learn_batch a "
                         f"multiple of 128*learn_rounds, got learn_rounds={K} "
                         f"learn_batch={B}")
    R = cfg.memory_capacity // num_envs
    if R < 2 or cfg.memory_capacity != R * num_envs:
        raise ValueError("memory_capacity must be k*num_envs with k>=2, got "
                         f"capacity={cfg.memory_capacity} num_envs={num_envs}")
    dev = resolve_device(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    p = params_to_t(qnet_init(generator, cfg.obs_dim, cfg.num_actions,
                              cfg.hidden))
    tp = params_to_t(qnet_init(generator, cfg.obs_dim, cfg.num_actions,
                               cfg.hidden))
    zeros6 = tuple(torch.zeros_like(a) for a in p)
    opp = params_to_t(opp_params, dev) if opp_params is not None else p
    n = num_envs
    if ring_hbm is None:  # the JAX rule, recorded only
        ring_hbm = R * NUM_F * n * 4 > 24 * 1024 * 1024
    env = torch.zeros(ENV_ROWS, n, dtype=torch.float32, device=dev)
    env[0:8] = _init_env_rows(env_params, generator, n)
    return {
        "p": p, "tp": tp, "m": zeros6, "v": zeros6, "opp": opp,
        "env": env,
        "ring": torch.zeros(R * NUM_F, n, dtype=torch.float32, device=dev),
        "R": R, "n": n, "B": B, "K": K, "ring_hbm": int(bool(ring_hbm)),
        "warm": 0, "learns": 0, "steps": 0, "env_steps": 0,
        "episodes": 0.0, "collisions": 0.0, "wins": 0.0, "sum_ep_reward": 0.0,
        "last_loss": 0.0,
    }


def _init_env_rows(env_params, generator, n):
    """Initial pos/vel/xy rows ``[8, n]``: the deterministic start, or a
    ``core.env.reset`` draw from ``generator`` when
    ``env_params.random_start`` (the auto-resets then draw from Philox)."""
    dev = generator.device
    if env_params.random_start:
        st = reset_batch(env_params, generator, n, torch.float32, dev)
        pos, vel = st.pos.T, st.vel.T
    else:
        pos = torch.full((2, n), C.START_POINT, dtype=torch.float32,
                         device=dev)
        vel = torch.full((2, n), C.START_VEL, dtype=torch.float32, device=dev)
    x1, y1 = lon2coord(pos[0], +1.0)
    x2, y2 = lon2coord(pos[1], -1.0)
    return torch.cat([pos, vel, torch.stack([x1, y1, x2, y2])])


def carry_from_numpy(carry: dict, device=None) -> dict:
    """A fused carry with numpy (or JAX) leaves -> the port's carry on
    ``device``: both packages can then train from the same state."""
    dev = resolve_device(device)

    def tensor(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=dev)

    out = dict(carry)
    for k in ("p", "tp", "m", "v", "opp"):
        out[k] = tuple(tensor(a) for a in carry[k])
    out["env"], out["ring"] = tensor(carry["env"]), tensor(carry["ring"])
    for k in ("R", "n", "B", "K", "ring_hbm", "warm", "learns", "steps",
              "env_steps"):
        out[k] = int(carry.get(k, 1 if k == "K" else 0))
    for k in ("episodes", "collisions", "wins", "sum_ep_reward",
              "last_loss"):
        out[k] = float(carry[k])
    return out


def launch_cfg(carry, env_params, seed) -> tuple:
    """``(seed, max_steps, warm, learns, base)``: the JAX kernel's SMEM cfg
    vector, here the host integers that schedule a chunk's steps."""
    return (int(seed), env_params.max_steps, int(carry["warm"]),
            int(carry["learns"]), carry.get("steps", 0) % carry["R"])


def chunk_learns(carry, num_steps):
    """Learn count added by a ``num_steps`` chunk (global-step gated)."""
    R = carry["R"]
    prior = carry.get("steps", 0)
    warmup_left = 0 if carry["warm"] else max(R - 1 - prior, 0)
    return max(num_steps - warmup_left, 0)


def apply_chunk(carry, out, num_steps, met_sum, loss):
    """Fold a chunk's outputs (``out``: p/tp/m/v 6-tuples, env, ring) back
    into the carry dict: the warm gate, learns, ring base and metrics."""
    steps = carry.get("steps", 0) + num_steps
    return {
        **carry,
        "p": out["p"], "tp": out["tp"], "m": out["m"], "v": out["v"],
        "env": out["env"], "ring": out["ring"],
        "warm": 1 if steps >= carry["R"] - 1 else 0,
        "steps": steps,
        "learns": carry["learns"] + chunk_learns(carry, num_steps),
        "env_steps": carry["env_steps"] + num_steps * carry["n"],
        "episodes": carry["episodes"] + float(met_sum[0]),
        "collisions": carry["collisions"] + float(met_sum[1]),
        "wins": carry["wins"] + float(met_sum[2]),
        "sum_ep_reward": carry["sum_ep_reward"] + float(met_sum[3]),
        "last_loss": float(loss),
    }


def _schedule(launch, R, num_steps, target_sync):
    """Per step ``(i, ring round, learns?, syncs?, Adam t)`` from the
    :func:`launch_cfg` vector: the learn gate opens once R-1 global steps
    have filled the ring (a chunk shorter than that must not open it
    early); the learn count, and with it the target sync and Adam's step,
    follow from the host counters."""
    _, _, warm, prior, base = launch
    for i in range(num_steps):
        learn = bool(warm) or base + i >= R - 1
        lc = prior + (i if warm else i - (R - 1 - base))
        yield i, (base + i) % R, learn, learn and lc % target_sync == 0, lc + 1


# ---------------------------------------------------------------------------
# One chunk: plain version and kernels
# ---------------------------------------------------------------------------

def working_state(carry, dtype):
    """Flat working copies of a carry (its tensors stay untouched)."""
    st = {k: _flat(carry[k]).contiguous()
          for k in ("p", "tp", "m", "v", "opp")}
    for k in ("p", "tp", "opp"):  # forward operands in the compute dtype
        st[k + "c"] = st[k].to(dtype) if dtype != torch.float32 else st[k]
    st["env"] = carry["env"].to(torch.float32).contiguous().clone()
    st["ring"] = carry["ring"].to(torch.float32).contiguous().clone()
    dev = st["env"].device
    st["met"] = torch.zeros(4, carry["n"], dtype=torch.float32, device=dev)
    st["loss"] = torch.zeros((), dtype=torch.float32, device=dev)
    return st


def _finish(carry, st, dims, num_steps):
    with span("mgt.chunk.fold"):
        out = {k: _transposed(st[k], dims) for k in ("p", "tp", "m", "v")}
        out["env"], out["ring"] = st["env"], st["ring"]
        met = st["met"].to(torch.float64).sum(dim=1)
        with span("mgt.readback"):
            met = met.tolist()
        with span("mgt.readback"):
            loss = float(st["loss"])
        return apply_chunk(carry, out, num_steps, met, loss)


def _prepare(cfg, env_params, carry, num_steps, seed, greedy, rounds, cols):
    R, n = carry["R"], carry["n"]
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    K = carry.get("K", 1)
    W = carry.get("B", n) // K
    g = torch.Generator().manual_seed(seed ^ 0x5EED)
    if rounds is None:
        rounds = torch.randint(0, R, (num_steps * K,), generator=g)
    if cols is None:
        cols = torch.randint(0, n // W, (num_steps * K,), generator=g)
    rounds = np.asarray(rounds, dtype=np.int32)
    cols = np.asarray(cols, dtype=np.int32)
    if rounds.shape != (num_steps * K,) or cols.shape != (num_steps * K,):
        raise ValueError("rounds/cols must be i32 [num_steps * learn_rounds]")
    if (rounds.min() < 0 or rounds.max() >= R or cols.min() < 0
            or cols.max() >= n // W):
        raise ValueError(f"rounds must lie in [0, {R}) and cols in "
                         f"[0, {n // W})")
    if env_params.random_start and greedy:
        raise ValueError("random starts draw from the actor's Philox "
                         "stream, which greedy mode skips (greedy is the "
                         "deterministic test mode); drop one of the two")
    if cfg.opponent not in (OPP_L0, OPP_SELFPLAY, OPP_FROZEN):
        raise ValueError(f"unknown opponent mode {cfg.opponent!r}")
    return rounds, cols, compute_dtype_of(cfg.compute_dtype)


def fused_dqn_chunk_plain(cfg, env_params, carry, num_steps, seed, *,
                          greedy=False, rounds=None, cols=None) -> dict:
    """Plain PyTorch version of K5 (see :func:`fused_dqn_chunk`)."""
    st = _plain_state(cfg, env_params, carry, num_steps, seed, greedy,
                      rounds, cols)
    return _finish(carry, st, _dims(carry["p"]), num_steps)


def _plain_state(cfg, env_params, carry, num_steps, seed, greedy, rounds,
                 cols) -> dict:
    with span("mgt.chunk.prologue"):
        rounds, cols, dtype = _prepare(cfg, env_params, carry, num_steps,
                                       seed, greedy, rounds, cols)
        st = working_state(carry, dtype)
    with span("mgt.chunk.issue"):
        _plain_steps(st, cfg, env_params, carry, num_steps, seed, greedy,
                     rounds, cols, dtype)
    return st


def _plain_steps(st, cfg, env_params, carry, num_steps, seed, greedy, rounds,
                 cols, dtype) -> None:
    """The plain version's steps, on the working state ``st`` in place."""
    dims = _dims(carry["p"])
    n, K = carry["n"], carry.get("K", 1)
    W = carry.get("B", n) // K
    key = philox.seed_key(seed)
    thr = greedy_threshold(cfg.epsilon)
    dev = st["env"].device
    f32 = torch.float32
    for i, r_cur, learn, sync, t in _schedule(
            launch_cfg(carry, env_params, seed), carry["R"], num_steps,
            cfg.target_sync):
        gstep = carry["steps"] + i
        env = st["env"]
        pos, vel = env[0:2], env[2:4]
        x1, y1, x2, y2 = env[4], env[5], env[6], env[7]
        obs = torch.stack([x2 - x1, y2 - y1, vel[1] - vel[0],
                           C.END_POINT - pos[0], vel[0], x1 - x2, y1 - y2,
                           vel[0] - vel[1], C.END_POINT - pos[1], vel[1]],
                          dim=1)                                   # [n, 10]

        # Actors.
        bits = ((None,) * 4 if greedy else
                philox.draw(gstep, n, philox.STREAM_ACTIONS, key, dev))
        a1 = select(mlp_plain(_natural(st["pc"], dims), obs, dtype),
                    bits[0], bits[1], greedy, thr)
        if cfg.opponent == OPP_L0:
            a2 = torch.full_like(a1, C.ACTION_NONE)
        else:
            opp = st["pc"] if cfg.opponent == OPP_SELFPLAY else st["oppc"]
            a2 = select(mlp_plain(_natural(opp, dims), core_env.swap_obs(obs),
                                  dtype), bits[2], bits[3], greedy, thr)

        # Env step.
        state = core_env.EnvState(
            pos=pos.T, vel=vel.T, acc=torch.zeros(n, 2, device=dev),
            t=env[9].to(torch.int32), winner=env[8].to(torch.int32),
            done=torch.zeros(n, dtype=torch.bool, device=dev),
            r_acc=torch.zeros(n, 2, device=dev))
        ns, ts = core_env.step(env_params, state,
                               torch.stack([a1, a2], dim=-1))
        done, r1 = ts.done, ts.rewards[:, 0]

        # Ring store; a lane whose ego has won keeps its old row.
        stored = ns.winner != 1
        slab = torch.cat([obs.T, ts.obs.T, torch.stack([
            a1.to(f32), r1, done.to(f32), torch.zeros(n, device=dev)])])
        rows = slice(r_cur * NUM_F, (r_cur + 1) * NUM_F)
        st["ring"][rows] = torch.where(stored[None], slab, st["ring"][rows])

        if learn:
            draws = slice(i * K, (i + 1) * K)
            batch = ring_batch(st["ring"], rounds[draws], cols[draws], W,
                               NUM_F, dims[0])
            st["loss"] = learn_plain(st, "", batch, sync, t, cfg, dims)

        # Metrics: the win is tested on the pre-step obs.
        ep = env[10] + torch.where(stored, r1, 0.0)
        won = done & (obs[:, 8] > obs[:, 3])
        met = st["met"]
        st["met"] = torch.stack([met[0] + done.to(f32),
                                 met[1] + ts.collision.to(f32),
                                 met[2] + won.to(f32),
                                 met[3] + torch.where(done, ep, 0.0)])
        ep = torch.where(done, 0.0, ep)

        # Auto-reset.
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
        st["env"] = torch.stack([
            npos[:, 0], npos[:, 1], nvel[:, 0], nvel[:, 1], nx1, ny1, nx2,
            ny2, torch.where(done, 0, ns.winner).to(f32),
            torch.where(done, 0, ns.t).to(f32), ep])


def fused_dqn_chunk(cfg, env_params, carry, num_steps, seed, *,
                    greedy=False, rounds=None, cols=None) -> dict:
    """Run ``num_steps`` training steps; returns the new carry.

    ``greedy=True`` makes the actors pure argmax and skips the Philox
    draws; with explicit ``rounds``/``cols`` sample streams (i32
    ``[num_steps * learn_rounds]``; default: drawn on the host from
    ``seed ^ 0x5EED``) the chunk is then deterministic.  A carry on the
    CPU runs the plain version; on the card K5 runs, three launches per
    learning step (one before the ring has filled), with no read-back
    until the chunk ends.  The input carry is left as it was.
    """
    st = chunk_state(cfg, env_params, carry, num_steps, seed, greedy=greedy,
                     rounds=rounds, cols=cols)
    return _finish(carry, st, _dims(carry["p"]), num_steps)


def chunk_state(cfg, env_params, carry, num_steps, seed, *, greedy=False,
                rounds=None, cols=None) -> dict:
    """The flat working state (:func:`working_state`) after a chunk, not
    yet folded into a carry: K5 on the card, the plain version on the
    CPU (``parallel.spmd`` averages it over the ranks before the fold)."""
    if carry["env"].device.type == "cpu":
        return _plain_state(cfg, env_params, carry, num_steps, seed, greedy,
                            rounds, cols)
    with span("mgt.chunk.prologue"):
        rounds, cols, dtype = _prepare(cfg, env_params, carry, num_steps,
                                       seed, greedy, rounds, cols)
        st = working_state(carry, dtype)
        issue = trainer_launches(st, carry, cfg, env_params, num_steps, seed,
                                 greedy, rounds, cols)
    issue()
    return st


def launch_trainer(st, carry, cfg, env_params, num_steps, seed, greedy,
                   rounds, cols, act_geom=None) -> None:
    """Issue K5's kernels for ``num_steps`` steps on the current stream,
    updating the flat working state ``st`` (see :func:`working_state`) in
    place; the act kernel in ``act_geom`` (by default
    :func:`act_geometry`'s)."""
    trainer_launches(st, carry, cfg, env_params, num_steps, seed, greedy,
                     rounds, cols, act_geom)()


def trainer_launches(st, carry, cfg, env_params, num_steps, seed, greedy,
                     rounds, cols, act_geom=None):
    """:func:`launch_trainer` in two parts: the set-up (the geometry, the
    learner's workspace, the sample streams' uploads) now, and the
    function it returns, which issues the kernels (the span
    ``mgt.chunk.issue``)."""
    n, B, K = carry["n"], carry.get("B", carry["n"]), carry.get("K", 1)
    bf16 = st["pc"].dtype == torch.bfloat16
    elem = st["pc"].element_size()
    dev = kernels.require_cuda(*(st[k] for k in (
        "p", "tp", "m", "v", "opp", "pc", "tpc", "oppc", "env", "ring",
        "met", "loss")))
    dims = _dims(carry["p"])
    d_in, h1, h2, a = dims
    g = act_geom or act_geometry(n, (dims,), elem, sm_count(dev),
                                 *act_seats(cfg.opponent))
    learner = Learner(st, "", dims, B, K, cfg, dev)
    with span("mgt.upload"):
        rounds_d = torch.as_tensor(rounds, dtype=torch.int32, device=dev)
    with span("mgt.upload"):
        cols_d = torch.as_tensor(cols, dtype=torch.int32, device=dev)
    k0, k1 = philox.seed_key(seed)
    stream = kernels.stream_ptr(dev)
    act_fn = kernels.function("dqn_trainer", "mgt_dqn_act", _ACT_ARGS)
    ptr = kernels.ptr
    opp = st["oppc"] if cfg.opponent == OPP_FROZEN else st["pc"]
    act_args = (d_in, h1, h2, a, g.rows, g.rm, g.rn, g.resident, g.chunk,
                g.smem, int(bf16), OPP_MODES[cfg.opponent], int(greedy),
                int(env_params.random_start))
    env_args = (env_params.max_steps, *rewards_cfg(env_params))
    thr = greedy_threshold(cfg.epsilon)
    schedule = launch_cfg(carry, env_params, seed)

    def issue():
        with span("mgt.chunk.issue"):
            for i, r_cur, learn, sync, t in _schedule(
                    schedule, carry["R"], num_steps, cfg.target_sync):
                rc = act_fn(ptr(st["pc"]), ptr(opp), ptr(st["env"]),
                            ptr(st["ring"]), ptr(st["met"]), n, *act_args,
                            (carry["steps"] + i) & philox.MASK32, r_cur, thr,
                            k0, k1, *env_args, stream)
                kernels.check("dqn_trainer", rc, "dqn_act_env_store launch")
                kernels.launch_counts["dqn_act_env_store"] += 1
                if learn:
                    learner.launch(st["ring"], NUM_F, rounds_d[i * K:],
                                   cols_d[i * K:], st["loss"],
                                   ("dqn_learn_fwd", "dqn_learn_grad"),
                                   sync=sync, t=t)
    return issue


# ---------------------------------------------------------------------------
# The act kernels of K5 and K7 on the card: geometry
# ---------------------------------------------------------------------------

class ActGeometry(NamedTuple):
    """Launch geometry of the act kernels of K5 and K7: ``rows`` envs per
    block, ``rm`` x ``rn`` micro-tiles, the first ``resident`` of the
    kernel's nets held in shared memory for the launch, ``chunk`` elements
    per weight buffer where a net streams (0: none does), and ``smem``
    bytes of shared memory per block."""
    rows: int
    rm: int
    rn: int
    resident: int
    chunk: int
    smem: int


def act_seats(opponent: str) -> tuple:
    """``(seats, frozen)`` of an opponent mode: self-play runs both seats'
    rows through one pass of the ego's nets, a frozen opponent's nets
    stream in passes of their own."""
    return (2 if opponent == OPP_SELFPLAY else 1), opponent == OPP_FROZEN


def _widest(widths) -> tuple:
    return tuple(max(w[i] for w in widths) for i in range(4))


def act_smem(widths, rows: int, elem: int, resident: int, chunk: int,
             seats: int) -> int:
    """Shared-memory bytes of one act block (``act_tiled.cuh:ActSmem``):
    the first ``resident`` nets of ``widths`` whole, two weight buffers of
    ``chunk`` elements (none at 0), then the input, h1 and h2 tiles of
    ``seats * rows`` rows (each row padded to ``act_stride``), as wide as
    the widest net's, and their f32 q."""
    prows = seats * rows
    n = sum(net_smem(w, elem) for w in widths[:resident])
    n += _align16(2 * chunk * elem) if chunk else 0
    widest = _widest(widths)
    for k in widest[:3]:
        n += _align16(prows * ((k + 3) // 4 * 4 + 4) * elem)
    return n + prows * widest[3] * 4


def act_tiling(widths, rows: int, elem: int, seats: int = 1,
               frozen: bool = False,
               resident: int | None = None) -> ActGeometry | None:
    """The act geometry for blocks of ``rows`` envs of the nets ``widths``
    (the kernel's own, in the order it holds them: K5 the player's, K7 the
    upper and the lower net) in ``elem``-byte weights, ``seats * rows``
    rows a pass, a frozen opponent's nets (of the same widths) streamed
    where ``frozen``: as many of ``widths`` resident as fit beside the
    tiles (``resident`` forces the count), the other nets streamed through
    two buffers that take the rest of the block's shared memory
    (``ops.fused_mlp.weight_chunk``); None where that leaves no room.  The
    micro-tile is ``ops.fused_mlp.micro_tile``'s for a pass of
    ``seats * rows`` rows."""
    widest = _widest(widths)
    rm, rn = micro_tile(widest, seats * rows, ACT_MIN_TILES)
    for held in (range(len(widths), -1, -1) if resident is None
                 else (resident,)):
        smem = act_smem(widths, rows, elem, held, 0, seats)
        if held == len(widths) and not frozen:
            if smem <= kernels.SMEM_LIMIT:
                return ActGeometry(rows, rm, rn, held, 0, smem)
            continue
        chunk = weight_chunk(widest, kernels.SMEM_LIMIT - smem, elem)
        if chunk is not None:
            return ActGeometry(rows, rm, rn, held, chunk, act_smem(
                widths, rows, elem, held, chunk, seats))
    return None


@functools.lru_cache(maxsize=None)
def act_geometry(num_envs: int, widths: tuple, elem: int, sms: int,
                 seats: int = 1, frozen: bool = False) -> ActGeometry:
    """The act kernels' launch geometry for ``num_envs`` envs on ``sms``
    SMs (:func:`act_tiling`'s arguments otherwise): the smallest power of
    two of envs per block (at most ``ACT_ROWS_MAX``) that needs no more
    blocks than the card has SMs, halved while nothing fits.  At the CLI's
    1,024 envs on 132 SMs: 8 envs a block in 128 blocks, with the f32 and
    bf16 reference nets resident."""
    top = 1
    while top < ACT_ROWS_MAX and -(-num_envs // top) > sms:
        top *= 2
    for rows in (top >> i for i in range(top.bit_length())):
        g = act_tiling(widths, rows, elem, seats, frozen)
        if g is not None:
            return g
    raise ValueError(f"Q-nets of widths {tuple(widths)} do not fit the "
                     f"{kernels.SMEM_LIMIT} B of shared memory of a block")


# ---------------------------------------------------------------------------
# The learner on the card: geometry, workspace, launches
# ---------------------------------------------------------------------------

LEARN_LANES_MAX = 16
# Micro-tiles of the forwards' largest layer per block: the target's
# forward and the dz1 layer run over half the rows of the online one, so
# the learner asks for twice K3's QNET_MIN_TILES (the tiles sweep of
# chip_smoke.py times the others).
LEARN_MIN_TILES = 192
# learn_grad_kernel (dqn_trainer.cu): rectangles of 16 x 16 gradient
# entries per block, GRAD_GROUPS summation tiles in flight.
GRAD_GROUPS = 16


class LearnGeometry(NamedTuple):
    """Launch geometry of the learner's forward/backward kernel: ``lanes``
    sampled lanes per block, its forwards' ``rm`` x ``rn`` micro-tiles,
    ``chunk`` elements per weight buffer, ``smem`` bytes per block."""
    lanes: int
    rm: int
    rn: int
    chunk: int
    smem: int


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def learn_extra(widths, lanes: int, elem: int) -> int:
    """Shared-memory bytes of ``learn_fwd_kernel`` after the forward's
    layout for ``2 * lanes`` rows (``dqn_trainer.cu:LearnSmem``): q of x and
    x', the target's q of x', four f32 per lane, dq and its rounded copy,
    dz2 in the compute type with h2's row stride."""
    a, h2 = widths[3], widths[2]
    q = lanes * a * 4
    return (_align16(2 * q) + _align16(q) + _align16(16 * lanes)
            + 2 * _align16(q) + lanes * ((h2 + 3) // 4 * 4 + 4) * elem)


def learn_tiling(widths, lanes: int, elem: int) -> LearnGeometry | None:
    """The geometry of blocks of ``lanes`` lanes, or None where they do
    not fit a block's shared memory: the forward's tiling of ``2 * lanes``
    rows (x and x' of each lane) with :func:`learn_extra` bytes after it."""
    g = qnet_tiling(tuple(widths), 2 * lanes, elem,
                    extra=learn_extra(widths, lanes, elem),
                    min_tiles=LEARN_MIN_TILES)
    return None if g is None else LearnGeometry(lanes, g.rm, g.rn, g.chunk,
                                                g.smem)


@functools.lru_cache(maxsize=None)
def learn_geometry(batch: int, widths: tuple, elem: int,
                   sm_count: int) -> LearnGeometry:
    """The learner's geometry for ``batch`` lanes on ``sm_count`` SMs: the
    smallest power of two of lanes per block (at most ``LEARN_LANES_MAX``)
    that needs no more blocks than the card has SMs -- as
    ``ops/fused_mlp.py:qnet_geometry`` sizes K3's rows -- halved while it
    does not fit shared memory.  It is independent of the summation tile
    (:func:`learn_tile`), which fixes only the order of the sums."""
    top = 1
    while top < LEARN_LANES_MAX and -(-batch // top) > sm_count:
        top *= 2
    for lanes in (top >> i for i in range(top.bit_length())):
        g = learn_tiling(widths, lanes, elem)
        if g is not None:
            return g
    raise ValueError(f"a Q-net of widths {tuple(widths)} does not fit the "
                     f"learner's {kernels.SMEM_LIMIT} B of shared memory")


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def workspace_width(dims, bf16: bool) -> int:
    """Floats per lane of the learner's workspace (``dqn_trainer.cu:
    WsCols``): x, h1, h2, dq with the squared TD error, dz2, dz1, and in
    bf16 dq, dz2 and dz1 rounded to bf16, each group padded to a multiple
    of 4 floats."""
    d_in, h1, h2, a = dims
    width = _pad4(d_in) + 2 * _pad4(h1) + 2 * _pad4(h2) + _pad4(a + 1)
    return width + (_pad4(a) + _pad4(h2) + _pad4(h1) if bf16 else 0)


def grad_smem(tile: int) -> int:
    """Shared-memory bytes of ``learn_grad_kernel`` (``dqn_trainer.cu:
    grad_smem``): two buffers of GRAD_GROUPS tiles of lanes x 16 columns of
    both factors, and the groups' partial sums."""
    return (4 * GRAD_GROUPS * tile * 16 + GRAD_GROUPS * 16 * 16) * 4


class Learner:
    """Launches of the learner kernels (``learn_fwd_kernel`` and
    ``learn_grad_kernel`` of ``dqn_trainer.cu``) for the flat set
    ``prefix`` of the working state ``st`` (see :func:`learn_plain`), with
    their workspace (one row per sampled lane) and ``w1t``, the online
    net's w1 transposed, which the gradient kernel keeps up to date.  K5
    runs one, K7 two (its lower and upper learners).  The set must lie on
    the card: nothing here runs on the CPU.  ``geometry``: a
    :class:`LearnGeometry` in place of :func:`learn_geometry`'s (the lanes
    sweep of chip_smoke.py)."""

    def __init__(self, st, prefix, dims, B, K, cfg, dev, geometry=None):
        pc = st[prefix + "pc"]
        dev = kernels.require_cuda(*(st[prefix + k] for k in (
            "p", "tp", "m", "v", "pc", "tpc")))
        self.st, self.prefix, self.dims = st, prefix, dims
        self.B, self.K, self.cfg = B, K, cfg
        self.bf16 = pc.dtype == torch.bfloat16
        elem = pc.element_size()
        self.tile = learn_tile(dims, elem)
        self.geom = geometry or learn_geometry(B, tuple(dims), elem,
                                               sm_count(dev))
        self.P = st[prefix + "p"].numel()
        self.ws = torch.empty(B, workspace_width(dims, self.bf16),
                              dtype=torch.float32, device=dev)
        self.w1t = _natural(pc, dims)[2].T.contiguous()
        self.stream = kernels.stream_ptr(dev)
        self.fwd_fn = kernels.function("dqn_trainer", "mgt_dqn_learn_fwd",
                                       _FWD_ARGS)
        self.grad_fn = kernels.function("dqn_trainer", "mgt_dqn_learn_grad",
                                        _GRAD_ARGS)

    def launch(self, ring, num_f, rounds, cols, loss, counts, *,
               sync=False, t=1, gate=None):
        """One learn on ``ring`` (``num_f`` fields per round) from the
        first K draws of the i32 device streams ``rounds``/``cols``; the
        loss goes to the 0-d ``loss``, the launches to the two
        ``launch_counts`` keys ``counts``.  ``gate``: ``None`` (the host
        decided: ``sync`` and Adam's step ``t``), or ``(any_end, bias,
        step, first_open, prior)`` for the device gate of K7's upper
        learner (``dqn_trainer.cu:DevGate``)."""
        st, pre, ptr, cfg, g = self.st, self.prefix, kernels.ptr, self.cfg, \
            self.geom
        if gate is None:
            dev_gate = (ptr(None), ptr(None), 0, 0, 0)
            c1, c2 = adam_bias_corrections(t)
        else:
            any_end, bias, step, first_open, prior = gate
            dev_gate = (ptr(any_end), ptr(bias), step, first_open, prior)
            sync, c1, c2 = False, 1.0, 1.0  # decided on the device
        pc, tpc = st[pre + "pc"], st[pre + "tpc"]
        rc = self.fwd_fn(
            ptr(pc), ptr(pc if sync else tpc), ptr(self.w1t), ptr(ring),
            ptr(rounds), ptr(cols), ptr(self.ws), ring.shape[1], self.B,
            self.K, num_f, *self.dims, int(self.bf16),
            int(cfg.mask_terminal), cfg.gamma, 2.0 / self.B, g.lanes, g.rm,
            g.rn, g.chunk, g.smem, dev_gate[0], *dev_gate[2:],
            cfg.target_sync, self.stream)
        kernels.check("dqn_trainer", rc, "learn_fwd launch")
        kernels.launch_counts[counts[0]] += 1
        pb, tpb = (ptr(pc), ptr(tpc)) if self.bf16 else (ptr(None),) * 2
        rc = self.grad_fn(
            ptr(self.ws), ptr(st[pre + "p"]), ptr(st[pre + "tp"]),
            ptr(st[pre + "m"]), ptr(st[pre + "v"]), pb, tpb, ptr(self.w1t),
            ptr(loss), *self.dims, self.B, self.tile, int(sync), cfg.lr,
            ADAM_B1, ADAM_B2, 1.0 - ADAM_B1, 1.0 - ADAM_B2, ADAM_EPS, c1, c2,
            grad_smem(self.tile), *dev_gate, cfg.target_sync, self.stream)
        kernels.check("dqn_trainer", rc, "learn_grad launch")
        kernels.launch_counts[counts[1]] += 1
