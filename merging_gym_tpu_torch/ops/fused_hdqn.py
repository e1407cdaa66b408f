"""The whole two-timescale h-DQN trainer on the card (K7).

Replaces ``merging_gym_tpu/ops/fused_hdqn.py:_kernel`` (helper
``_goal_status``; ``pallas_call`` at :349 ``_call``, entry
``fused_hdqn_chunk``).  Per training step: the meta-controller's
Phi(eps)-greedy goal at option starts and again on the post-step obs (the
reference's goal-drift quirk, hdqn.py:283-286,303), the low controller's
action on ``[goal] + obs``, the opponent's pair (live nets in selfplay,
frozen nets, or L0), the env step, the intrinsic reward, the unconditional
store of a ``[32]`` slab into the lower ring, the option-end-gated store
of a ``[24]`` slab into the upper ring (the faithful meta transition: the
final state twice), the lower Double-DQN learner on every step once its
ring has filled, the upper one on steps where some option ended once its
ring has filled, the metrics and the auto-reset.

On the H100 a step is up to five hand-written kernels issued by
:func:`fused_hdqn_chunk` in a host loop on the current stream (K5's design,
``ops/fused_trainer.py``): the act/env/store kernel of
``kernels/csrc/hdqn_trainer.cu``, then the learner of
``kernels/csrc/dqn_trainer.cu`` on the lower ring and on the upper ring.
The upper learner's learn count depends on the data, so its gate, target
sync and Adam step are decided on the card from per-step flags that the
act kernel raises (``hdqn_trainer.cu`` explains how); the chunk reads the
card back twice, for the counter in state row 15 at its start and for the
flags and the metrics at its end.

The plain version (:func:`fused_hdqn_chunk_plain`) repeats the kernels'
arithmetic and summation order (``fused_trainer.learn_math`` for both
learners), so on the card the two agree bit for bit.

The carry is the JAX package's plain dict, with the same keys and layout:
ten parameter sets as transposed 6-tuples (``u_*`` the meta net 10 -> 3,
``l_*`` the low net 11 -> 5, each with target and Adam moments, and the
opponent's ``opp_u``/``opp_l``), ``state f32[16, n]`` (pos 2, vel 2, xy 4,
winner, t, episode reward, goal, opponent goal, option return, option
start, and in row 15 the int32 *bits* of the upper learn counter),
``lo_ring f32[R_lo * 32, n]``, ``up_ring f32[R_up * 24, n]`` and the host
counters.  Faithful-meta mode only, as in JAX.

Randomness: the actors draw from Philox at counter ``(global step, env,
stream, 0)`` under the chunk's seed, the JAX kernel's ten words per env
in three streams: stream 0 for the goal and the action, 2 for the
opponent's goal and action, 3 for the goal re-chosen after the step
(stream 1 is the random start).  The learners' ``lo_rounds``/``up_rounds``
come from a CPU ``torch.Generator`` seeded with ``seed ^ 0x4D0``, the
lane windows ``cols`` (lower at even indices, upper at odd) from one
seeded with ``seed ^ 0xC01``; explicit streams stay injectable.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from merging_gym_tpu_torch import kernels
from merging_gym_tpu_torch.agents.hdqn import goal_obs, goal_status
from merging_gym_tpu_torch.core import constants as C
from merging_gym_tpu_torch.core import env as core_env
from merging_gym_tpu_torch.core.geometry import lon2coord
from merging_gym_tpu_torch.device import resolve_device
from merging_gym_tpu_torch.nn.mlp import qnet_init
from merging_gym_tpu_torch.ops import fused_trainer as FT
from merging_gym_tpu_torch.ops import philox
from merging_gym_tpu_torch.ops.fused_actor import greedy_threshold, select
from merging_gym_tpu_torch.ops.fused_mlp import (compute_dtype_of, mlp_plain,
                                                 sm_count)
from merging_gym_tpu_torch.ops.fused_rollout import (random_reset_vals,
                                                     rewards_cfg)

# Lower ring fields: [goal;obs] 11 + [goal';next_obs] 11 + a/r/done = 25,
# padded to 32 as in the JAX layout.
LO_F = 32
# Upper ring fields: obs 10 + next_obs 10 + goal/r/done = 23, padded to 24.
UP_F = 24
# State rows: env 11 (pos 2, vel 2, xy 4, winner, t, ep_rew) + goal,
# goal_op, extr_return, option_start, upper learn counter = 16.
ROWS = 16

SETS = ("u_p", "u_tp", "u_m", "u_v", "l_p", "l_tp", "l_m", "l_v",
        "opp_u", "opp_l")
_COMPUTE_COPIES = ("u_p", "u_tp", "l_p", "l_tp", "opp_u", "opp_l")

_ACT_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 15
             + [ctypes.c_uint32] + [ctypes.c_int] * 2
             + [ctypes.c_uint32] * 3 + [ctypes.c_int]
             + [ctypes.c_float] * 5 + [ctypes.c_void_p])


def _goal_status(obs10: torch.Tensor) -> torch.Tensor:
    """hdqn.py:223-236 on ``[10, n]`` stacked obs."""
    return goal_status(obs10.T)


# ---------------------------------------------------------------------------
# Carry
# ---------------------------------------------------------------------------

def fused_hdqn_init(seed: int, cfg, env_params, num_envs: int,
                    opp_upper=None, opp_lower=None, *, learn_batch=None,
                    device=None) -> dict:
    """Fresh training state for K7 (the JAX ``fused_hdqn_init``).

    ``cfg``: ``agents.hdqn.HDQNConfig``.  ``cfg.memory_capacity`` (lower)
    and ``cfg.goal_memory_capacity`` (upper) must both be multiples of
    ``num_envs`` with at least 2 rounds each (the reference's 200-slot
    goal memory maps to ``goal_memory_capacity = 2 * num_envs`` at vector
    scale).  Both learners' batch is ``num_envs`` unless ``learn_batch``
    (a multiple of 128 dividing ``num_envs``).  The nets and random starts
    draw from a generator seeded with ``seed`` on ``device`` (default
    ``cuda``).  Faithful-meta mode only.
    """
    if not cfg.faithful_meta:
        raise ValueError("fused_hdqn supports faithful_meta=True only; "
                         "use agents.hdqn for the textbook meta transition")
    if num_envs % 128 != 0:
        raise ValueError(f"num_envs must be a multiple of 128, got {num_envs}")
    B = num_envs if learn_batch is None else int(learn_batch)
    if B % 128 != 0 or num_envs % B != 0:
        raise ValueError("learn_batch must be a multiple of 128 dividing "
                         f"num_envs, got learn_batch={B} num_envs={num_envs}")
    R_lo = cfg.memory_capacity // num_envs
    R_up = cfg.goal_memory_capacity // num_envs
    for name, cap, R in (("memory_capacity", cfg.memory_capacity, R_lo),
                         ("goal_memory_capacity", cfg.goal_memory_capacity,
                          R_up)):
        if R < 2 or cap != R * num_envs:
            raise ValueError(f"{name} must be k*num_envs with k>=2, got "
                             f"{cap} at num_envs={num_envs}")
    dev = resolve_device(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)

    def net(d_in, d_out):
        return FT.params_to_t(qnet_init(generator, d_in, d_out, cfg.hidden))

    u_p, u_tp = (net(cfg.obs_dim, cfg.num_goals) for _ in range(2))
    l_p, l_tp = (net(cfg.obs_dim + 1, cfg.num_actions) for _ in range(2))
    if cfg.opponent == FT.OPP_FROZEN:
        if opp_upper is None or opp_lower is None:
            raise ValueError("frozen opponent needs opp_upper and opp_lower")
        opp_u = FT.params_to_t(opp_upper, dev)
        opp_l = FT.params_to_t(opp_lower, dev)
    else:
        opp_u, opp_l = u_p, l_p
    n = num_envs
    state = torch.zeros(ROWS, n, dtype=torch.float32, device=dev)
    state[0:8] = FT._init_env_rows(env_params, generator, n)
    state[14] = 1.0  # every lane starts a fresh option

    def zeros(t):
        return tuple(torch.zeros_like(a) for a in t)

    return {
        "u_p": u_p, "u_tp": u_tp, "u_m": zeros(u_p), "u_v": zeros(u_p),
        "l_p": l_p, "l_tp": l_tp, "l_m": zeros(l_p), "l_v": zeros(l_p),
        "opp_u": opp_u, "opp_l": opp_l, "state": state,
        "lo_ring": torch.zeros(R_lo * LO_F, n, dtype=torch.float32,
                               device=dev),
        "up_ring": torch.zeros(R_up * UP_F, n, dtype=torch.float32,
                               device=dev),
        "R_lo": R_lo, "R_up": R_up, "n": n, "B": B,
        "warm_lo": 0, "warm_up": 0, "lo_learns": 0, "steps": 0,
        "env_steps": 0, "episodes": 0.0, "collisions": 0.0, "wins": 0.0,
        "sum_ep_reward": 0.0, "last_loss": 0.0,
    }


def hdqn_carry_from_numpy(carry: dict, device=None) -> dict:
    """A fused h-DQN carry with numpy (or JAX) leaves -> the port's carry
    on ``device``: both packages can then train from the same state."""
    dev = resolve_device(device)

    def tensor(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=dev)

    out = dict(carry)
    for k in SETS:
        out[k] = tuple(tensor(a) for a in carry[k])
    for k in ("state", "lo_ring", "up_ring"):
        out[k] = tensor(carry[k])
    for k in ("R_lo", "R_up", "n", "warm_lo", "warm_up", "lo_learns",
              "steps", "env_steps"):
        out[k] = int(carry[k])
    out["B"] = int(carry.get("B", carry["n"]))
    for k in ("episodes", "collisions", "wins", "sum_ep_reward",
              "last_loss"):
        out[k] = float(carry[k])
    return out


def upper_learns(state: torch.Tensor) -> int:
    """The upper learner's count, kept as int32 bits in state row 15 (f32
    counting would stall at 2**24 learns)."""
    return int(state[15, 0:1].view(torch.int32).item())


def _set_upper_learns(state: torch.Tensor, count: int) -> None:
    state[15].view(torch.int32).fill_(count)


def hdqn_launch_cfg(carry, env_params, seed) -> tuple:
    """``(seed, max_steps, warm_lo, lo_learns, base, warm_up)``: the JAX
    kernel's SMEM cfg vector, here the host integers that schedule a
    chunk.  ``base`` is ``steps % (R_lo * R_up)``, a common multiple of
    both ring sizes that equals the true prior step count while either
    warm flag is 0."""
    return (int(seed), env_params.max_steps, int(carry["warm_lo"]),
            int(carry["lo_learns"]),
            carry["steps"] % (carry["R_lo"] * carry["R_up"]),
            int(carry["warm_up"]))


def _chunk_schedule(carry, env_params, seed, num_steps, target_sync):
    """The chunk's host schedule from :func:`hdqn_launch_cfg`: the lower
    learner's per-step ``(i, ring round, learns?, syncs?, Adam t)``
    (``fused_trainer._schedule`` on the lower ring), and the first step at
    which the upper ring has filled (the host part of the upper gate,
    ``fused_hdqn.py:256``)."""
    seed, max_steps, warm_lo, lo_learns, base, warm_up = hdqn_launch_cfg(
        carry, env_params, seed)
    R_lo, R_up = carry["R_lo"], carry["R_up"]
    lower = FT._schedule((seed, max_steps, warm_lo, lo_learns, base % R_lo),
                         R_lo, num_steps, target_sync)
    return lower, 0 if warm_up else max(R_up - 1 - base, 0)


def apply_hdqn_chunk(carry, groups, state, lo_ring, up_ring, num_steps,
                     met_sum, loss) -> dict:
    """Fold a chunk's outputs back into the carry dict (the JAX
    ``apply_hdqn_chunk``): ``groups`` the eight learner sets in ``SETS``
    order, the warm flags, the lower learn count and the metrics."""
    R_lo, R_up = carry["R_lo"], carry["R_up"]
    steps = carry["steps"] + num_steps
    warmup_left = 0 if carry["warm_lo"] else max(R_lo - 1 - carry["steps"], 0)
    return {
        **carry,
        **dict(zip(SETS[:8], groups)),
        "state": state, "lo_ring": lo_ring, "up_ring": up_ring,
        "warm_lo": 1 if steps >= R_lo - 1 else 0,
        "warm_up": 1 if steps >= R_up - 1 else 0,
        "lo_learns": carry["lo_learns"] + max(num_steps - warmup_left, 0),
        "steps": steps,
        "env_steps": carry["env_steps"] + num_steps * carry["n"],
        "episodes": carry["episodes"] + float(met_sum[0]),
        "collisions": carry["collisions"] + float(met_sum[1]),
        "wins": carry["wins"] + float(met_sum[2]),
        "sum_ep_reward": carry["sum_ep_reward"] + float(met_sum[3]),
        "last_loss": float(loss),
    }


# ---------------------------------------------------------------------------
# One chunk: plain version and kernels
# ---------------------------------------------------------------------------

def working_state(carry, dtype) -> dict:
    """Flat working copies of a carry (its tensors stay untouched), with
    compute-dtype copies ``<set>c`` of the forward operands."""
    st = {k: FT._flat(carry[k]).contiguous() for k in SETS}
    for k in _COMPUTE_COPIES:
        st[k + "c"] = st[k].to(dtype) if dtype != torch.float32 else st[k]
    for k in ("state", "lo_ring", "up_ring"):
        st[k] = carry[k].to(torch.float32).contiguous().clone()
    dev = st["state"].device
    st["met"] = torch.zeros(4, carry["n"], dtype=torch.float32, device=dev)
    st["loss"] = torch.zeros((), dtype=torch.float32, device=dev)
    return st


def _finish(carry, st, num_steps):
    du, dl = FT._dims(carry["u_p"]), FT._dims(carry["l_p"])
    groups = [FT._transposed(st[k], du if k.startswith("u_") else dl)
              for k in SETS[:8]]
    met = st["met"].to(torch.float64).sum(dim=1).tolist()
    return apply_hdqn_chunk(carry, groups, st["state"], st["lo_ring"],
                            st["up_ring"], num_steps, met, float(st["loss"]))


def _prepare(cfg, env_params, carry, num_steps, seed, greedy, lo_rounds,
             up_rounds, cols):
    R_lo, R_up, n = carry["R_lo"], carry["R_up"], carry["n"]
    B = carry.get("B", n)
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    g = torch.Generator().manual_seed(seed ^ 0x4D0)
    if lo_rounds is None:
        lo_rounds = torch.randint(0, R_lo, (num_steps,), generator=g)
    if up_rounds is None:
        up_rounds = torch.randint(0, R_up, (num_steps,), generator=g)
    if cols is None:
        cols = torch.randint(0, n // B, (2 * num_steps,),
                             generator=torch.Generator().manual_seed(
                                 seed ^ 0xC01))
    lo_rounds, up_rounds, cols = (np.asarray(x, dtype=np.int32)
                                  for x in (lo_rounds, up_rounds, cols))
    if (lo_rounds.shape != (num_steps,) or up_rounds.shape != (num_steps,)
            or cols.shape != (2 * num_steps,)):
        raise ValueError("lo_rounds/up_rounds must be i32 [num_steps], "
                         "cols i32 [2*num_steps]")
    if cols.min() < 0 or cols.max() >= n // B:
        raise ValueError(f"cols must lie in [0, {n // B})")
    if (lo_rounds.min() < 0 or lo_rounds.max() >= R_lo
            or up_rounds.min() < 0 or up_rounds.max() >= R_up):
        raise ValueError(f"lo_rounds must lie in [0, {R_lo}) and up_rounds "
                         f"in [0, {R_up}) (out-of-range values would train "
                         "on the wrong slab)")
    if env_params.random_start and greedy:
        raise ValueError("random starts draw from the actors' Philox "
                         "streams, which greedy mode skips; drop one of "
                         "the two")
    if cfg.opponent not in (FT.OPP_L0, FT.OPP_SELFPLAY, FT.OPP_FROZEN):
        raise ValueError(f"unknown opponent mode {cfg.opponent!r}")
    if not cfg.faithful_meta:
        raise ValueError("fused_hdqn supports faithful_meta=True only")
    return lo_rounds, up_rounds, cols, compute_dtype_of(cfg.compute_dtype)


def fused_hdqn_chunk_plain(cfg, env_params, carry, num_steps, seed, *,
                           greedy=False, lo_rounds=None, up_rounds=None,
                           cols=None) -> dict:
    """Plain PyTorch version of K7 (see :func:`fused_hdqn_chunk`)."""
    st = _plain_state(cfg, env_params, carry, num_steps, seed, greedy,
                      lo_rounds, up_rounds, cols)
    return _finish(carry, st, num_steps)


def _plain_state(cfg, env_params, carry, num_steps, seed, greedy, lo_rounds,
                 up_rounds, cols) -> dict:
    lo_rounds, up_rounds, cols, dtype = _prepare(
        cfg, env_params, carry, num_steps, seed, greedy, lo_rounds,
        up_rounds, cols)
    du, dl = FT._dims(carry["u_p"]), FT._dims(carry["l_p"])
    st = working_state(carry, dtype)
    n, B, R_up = carry["n"], carry.get("B", carry["n"]), carry["R_up"]
    key = philox.seed_key(seed)
    thr = greedy_threshold(cfg.epsilon)
    dev = st["state"].device
    f32 = torch.float32
    lower, first_open = _chunk_schedule(carry, env_params, seed, num_steps,
                                        cfg.target_sync)
    lc_up = upper_learns(st["state"])
    for i, r_lo, learn_lo, sync_lo, t_lo in lower:
        gstep = carry["steps"] + i
        s = st["state"]
        pos, vel = s[0:2], s[2:4]
        x1, y1, x2, y2 = s[4], s[5], s[6], s[7]
        goal, goal_op = s[11].to(torch.int32), s[12].to(torch.int32)
        extr, opt_start = s[13], s[14] > 0.5
        obs = torch.stack([x2 - x1, y2 - y1, vel[1] - vel[0],
                           C.END_POINT - pos[0], vel[0], x1 - x2, y1 - y2,
                           vel[0] - vel[1], C.END_POINT - pos[1], vel[1]],
                          dim=1)                                   # [n, 10]
        if greedy:
            bits = (None,) * 10
        else:
            bits = (philox.draw(gstep, n, philox.STREAM_ACTIONS, key, dev)
                    + philox.draw(gstep, n, philox.STREAM_OPPONENT, key, dev)
                    + philox.draw(gstep, n, philox.STREAM_GOAL, key, dev)[:2])

        def act(flat, dims, x, word):
            q = mlp_plain(FT._natural(flat, dims), x, dtype)
            return select(q, bits[word], bits[word + 1], greedy, thr)

        # Option boundaries: a fresh goal and a zeroed return.
        goal = torch.where(opt_start, act(st["u_pc"], du, obs, 0), goal)
        extr = torch.where(opt_start, 0.0, extr)
        a1 = act(st["l_pc"], dl, goal_obs(goal, obs), 2)
        if cfg.opponent == FT.OPP_L0:
            a2 = torch.full_like(a1, C.ACTION_NONE)
        else:
            selfplay = cfg.opponent == FT.OPP_SELFPLAY
            up_op = st["u_pc"] if selfplay else st["opp_uc"]
            lo_op = st["l_pc"] if selfplay else st["opp_lc"]
            obs2 = core_env.swap_obs(obs)
            goal_op = torch.where(opt_start, act(up_op, du, obs2, 4), goal_op)
            a2 = act(lo_op, dl, goal_obs(goal_op, obs2), 6)

        # Env step.
        state = core_env.EnvState(
            pos=pos.T, vel=vel.T, acc=torch.zeros(n, 2, device=dev),
            t=s[9].to(torch.int32), winner=s[8].to(torch.int32),
            done=torch.zeros(n, dtype=torch.bool, device=dev),
            r_acc=torch.zeros(n, 2, device=dev))
        ns, ts = core_env.step(env_params, state,
                               torch.stack([a1, a2], dim=-1))
        done, r1, next_obs = ts.done, ts.rewards[:, 0], ts.obs
        done_f = done.to(f32)

        # The goal re-chosen from the post-step obs; the intrinsic reward.
        goal_new = act(st["u_pc"], du, next_obs, 8)
        intrinsic = (goal_new == goal_status(obs)).to(f32)

        # Lower ring: every env, every step.
        st["lo_ring"][r_lo * LO_F:(r_lo + 1) * LO_F] = torch.cat([
            goal_obs(goal, obs).T, goal_obs(goal_new, next_obs).T,
            torch.stack([a1.to(f32), intrinsic, done_f]),
            torch.zeros(LO_F - 25, n, device=dev)])
        if learn_lo:
            batch = FT.ring_batch(st["lo_ring"], lo_rounds[i:i + 1],
                                  cols[2 * i:2 * i + 1], B, LO_F, dl[0])
            st["loss"] = FT.learn_plain(st, "l_", batch, sync_lo, t_lo, cfg,
                                        dl)

        # Option end; the upper ring where it ended.
        extr = extr + r1
        opt_end = done | (goal_new == goal_status(next_obs))
        r_up = gstep % R_up
        rows = slice(r_up * UP_F, (r_up + 1) * UP_F)
        st["up_ring"][rows] = torch.where(opt_end[None], torch.cat([
            next_obs.T, next_obs.T,
            torch.stack([goal_new.to(f32), extr, done_f]),
            torch.zeros(UP_F - 23, n, device=dev)]), st["up_ring"][rows])
        if i >= first_open and bool(opt_end.any()):
            batch = FT.ring_batch(st["up_ring"], up_rounds[i:i + 1],
                                  cols[2 * i + 1:2 * i + 2], B, UP_F, du[0])
            FT.learn_plain(st, "u_", batch, lc_up % cfg.target_sync == 0,
                           lc_up + 1, cfg, du)
            lc_up += 1

        # Metrics: every reward counts, the win is tested on the post-step
        # obs.
        ep = s[10] + r1
        won = done & (next_obs[:, 8] > next_obs[:, 3])
        met = st["met"]
        st["met"] = torch.stack([met[0] + done_f,
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
        st["state"] = torch.cat([torch.stack([
            npos[:, 0], npos[:, 1], nvel[:, 0], nvel[:, 1], nx1, ny1, nx2,
            ny2, torch.where(done, 0, ns.winner).to(f32),
            torch.where(done, 0, ns.t).to(f32), ep, goal_new.to(f32),
            goal_op.to(f32), torch.where(opt_end, 0.0, extr),
            opt_end.to(f32)]), s[15:16]])
    _set_upper_learns(st["state"], lc_up)
    return st


def fused_hdqn_chunk(cfg, env_params, carry, num_steps, seed, *,
                     greedy=False, lo_rounds=None, up_rounds=None,
                     cols=None) -> dict:
    """Run ``num_steps`` hierarchical training steps; returns the new
    carry.

    ``greedy=True`` makes every actor pure argmax and skips the Philox
    draws; with explicit ``lo_rounds``/``up_rounds`` (i32 ``[num_steps]``)
    and ``cols`` (i32 ``[2 * num_steps]``, the interleaved lower/upper
    lane windows used when ``learn_batch < n``) the chunk is then
    deterministic.  A carry on the CPU runs the plain version; on the card
    K7 runs, one to five launches per step, with no read-back inside the
    chunk.  The input carry is left as it was.
    """
    st = chunk_state(cfg, env_params, carry, num_steps, seed, greedy=greedy,
                     lo_rounds=lo_rounds, up_rounds=up_rounds, cols=cols)
    return _finish(carry, st, num_steps)


def chunk_state(cfg, env_params, carry, num_steps, seed, *, greedy=False,
                lo_rounds=None, up_rounds=None, cols=None) -> dict:
    """The flat working state after a chunk, not yet folded into a carry:
    K7 on the card, the plain version on the CPU (``parallel.spmd``
    averages it over the ranks before the fold)."""
    if carry["state"].device.type == "cpu":
        return _plain_state(cfg, env_params, carry, num_steps, seed, greedy,
                            lo_rounds, up_rounds, cols)
    lo_rounds, up_rounds, cols, dtype = _prepare(
        cfg, env_params, carry, num_steps, seed, greedy, lo_rounds,
        up_rounds, cols)
    st = working_state(carry, dtype)
    launch_hdqn(st, carry, cfg, env_params, num_steps, seed, greedy,
                lo_rounds, up_rounds, cols)
    return st


def launch_hdqn(st, carry, cfg, env_params, num_steps, seed, greedy,
                lo_rounds, up_rounds, cols, act_geom=None) -> None:
    """Issue K7's kernels for ``num_steps`` steps on the current stream,
    updating the flat working state ``st`` (see :func:`working_state`) in
    place, state row 15 included; the act kernel in ``act_geom`` (by
    default ``fused_trainer.act_geometry``'s for the upper and the lower
    net)."""
    n, B, R_up = carry["n"], carry.get("B", carry["n"]), carry["R_up"]
    dev = kernels.require_cuda(*(st[k] for k in (
        *SETS, "u_pc", "l_pc", "opp_uc", "opp_lc", "state", "lo_ring",
        "up_ring", "met", "loss")))
    du, dl = FT._dims(carry["u_p"]), FT._dims(carry["l_p"])
    if du[0] != C.OBS_DIM or dl[0] != C.OBS_DIM + 1 or du[1:3] != dl[1:3]:
        raise ValueError("K7 needs a 10-input meta net and an 11-input low "
                         "net of the same hidden widths")
    g = act_geom or FT.act_geometry(n, (du, dl), st["u_pc"].element_size(),
                                    sm_count(dev), *FT.act_seats(cfg.opponent))
    lower_steps, first_open = _chunk_schedule(carry, env_params, seed,
                                              num_steps, cfg.target_sync)
    prior = upper_learns(st["state"])  # the one read-back before the steps
    lower = FT.Learner(st, "l_", dl, B, 1, cfg, dev)
    upper = FT.Learner(st, "u_", du, B, 1, cfg, dev)
    lo_rounds_d, up_rounds_d, cols_d = (
        torch.as_tensor(x, dtype=torch.int32, device=dev)
        for x in (lo_rounds, up_rounds, cols))
    any_end = torch.zeros(num_steps, dtype=torch.int32, device=dev)
    # Adam's bias corrections of the upper learner for each count it can
    # reach in this chunk.
    bias = torch.tensor([FT.adam_bias_corrections(prior + 1 + k)
                         for k in range(max(num_steps - first_open, 1))],
                        dtype=torch.float32, device=dev)
    up_loss = torch.zeros((), dtype=torch.float32, device=dev)  # discarded
    k0, k1 = philox.seed_key(seed)
    stream = kernels.stream_ptr(dev)
    act_fn = kernels.function("hdqn_trainer", "mgt_hdqn_act", _ACT_ARGS)
    ptr = kernels.ptr
    frozen = cfg.opponent == FT.OPP_FROZEN
    opp_u = st["opp_uc"] if frozen else st["u_pc"]
    opp_l = st["opp_lc"] if frozen else st["l_pc"]
    act_args = (n, du[1], du[2], du[3], dl[3], g.rows, g.rm, g.rn,
                g.resident, g.chunk, g.smem,
                int(st["u_pc"].dtype == torch.bfloat16),
                FT.OPP_MODES[cfg.opponent], int(greedy),
                int(env_params.random_start))
    env_args = (env_params.max_steps, *rewards_cfg(env_params))
    thr = greedy_threshold(cfg.epsilon)
    for i, r_lo, learn_lo, sync_lo, t_lo in lower_steps:
        gstep = carry["steps"] + i
        rc = act_fn(ptr(st["u_pc"]), ptr(st["l_pc"]), ptr(opp_u), ptr(opp_l),
                    ptr(st["state"]), ptr(st["lo_ring"]), ptr(st["up_ring"]),
                    ptr(st["met"]), ptr(any_end[i:]), *act_args,
                    gstep & philox.MASK32, r_lo, gstep % R_up, thr, k0, k1,
                    *env_args, stream)
        kernels.check("hdqn_trainer", rc, "hdqn_act_env_store launch")
        kernels.launch_counts["hdqn_act_env_store"] += 1
        if learn_lo:
            lower.launch(st["lo_ring"], LO_F, lo_rounds_d[i:],
                         cols_d[2 * i:], st["loss"],
                         ("hdqn_learn_fwd_lower", "hdqn_learn_grad_lower"),
                         sync=sync_lo, t=t_lo)
        if i >= first_open:
            upper.launch(st["up_ring"], UP_F, up_rounds_d[i:],
                         cols_d[2 * i + 1:], up_loss,
                         ("hdqn_learn_fwd_upper", "hdqn_learn_grad_upper"),
                         gate=(any_end, bias, i, first_open, prior))
    ended = int((any_end[first_open:] != 0).sum().item())
    _set_upper_learns(st["state"], prior + ended)
