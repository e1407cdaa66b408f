"""K6's plain version and ``evaluate_fused``'s outcome reduction, in plain
PyTorch.

Frozen copy of ``ops/fused_policy_rollout.py`` and ``agents/evaluate.py``
of ``merging_gym_tpu_torch`` at commit 79f5ae92604b, with its imports of
the port replaced by the copies in this folder. Nothing here imports the
port or JAX.

Where the copy loops over slices, it now sums whole tensors in the
same order (``nets.seq_sum``); each such change keeps every product and
sum of the original and their order.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from perfbench.reference import constants as C
from perfbench.reference import philox
from perfbench.reference.env import (EnvParams, autoreset_step, observe, random_reset_vals,
                                     reset_batch, swap_obs)
from perfbench.reference.nets import (cast_weights, compute_dtype_of, greedy_threshold,
                                      mlp_plain, select, seq_sum)

BITS_BLOCK = 256    # steps whose Philox words are drawn in one call


def draw_steps(step0: int, steps: int, num_envs: int, key, device):
    """``philox.draw(s, num_envs, STREAM_ACTIONS, key)`` for the steps
    ``step0 .. step0 + steps - 1`` at once, each word ``[steps, num_envs]``
    (a change of this copy, which drew step by step: each word depends on
    its counter alone, so the bits are the same)."""
    env = torch.arange(num_envs, dtype=torch.int64, device=device)
    s = torch.arange(step0, step0 + steps, dtype=torch.int64, device=device)
    c0 = (s[:, None] & philox.MASK32).expand(steps, num_envs)
    c1 = env[None, :].expand(steps, num_envs)
    c2 = torch.full_like(c0, philox.STREAM_ACTIONS)
    return philox.philox4x32_10(c0, c1, c2, torch.zeros_like(c0), key)


OUTCOME_COUNTS = ("episodes", "p1_first", "p2_first", "collisions",
                  "timeouts")


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
        if not greedy and s % BITS_BLOCK == 0:
            block = draw_steps(s, min(BITS_BLOCK, num_steps - s), N, key, dev)
        bits = ((None,) * 4 if greedy else
                tuple(w[s % BITS_BLOCK] for w in block))
        if w2 is None:
            a1 = select(mlp_plain(w1, obs, dtype), bits[0], bits[1], greedy,
                        thr)
            a2 = torch.full_like(a1, C.ACTION_NONE)
        else:
            q1, q2 = mlp_plain_pair(w1, w2, obs, swap_obs(obs), dtype)
            a1 = select(q1, bits[0], bits[1], greedy, thr)
            a2 = select(q2, bits[2], bits[3], greedy, thr)
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


def _prepare(params1, params2, env_params, compute_dtype, device):
    env_params = env_params or EnvParams()
    dtype = compute_dtype_of(compute_dtype)
    d_in = params1["fc0"]["w"].shape[0]
    if d_in != C.OBS_DIM:
        raise ValueError(f"policy nets take {C.OBS_DIM} inputs, got {d_in}")
    dev = params1["fc0"]["w"].device if device is None else torch.device(device)
    return env_params, dtype, dev


def empty_events(T, N, dev):
    """Kernel output buffers (int32 events) for T steps of N envs."""
    return {"actions": torch.empty(T, 2, N, dtype=torch.int32, device=dev),
            "rewards": torch.empty(T, 2, N, dtype=torch.float32, device=dev),
            "done": torch.empty(T, N, dtype=torch.int32, device=dev),
            "winner": torch.empty(T, N, dtype=torch.int32, device=dev),
            "collision": torch.empty(T, N, dtype=torch.int32, device=dev)}


def as_events(out):
    """int32 event buffers -> the bool ``done``/``collision`` of the API."""
    return {**out, "done": out["done"].bool(),
            "collision": out["collision"].bool()}


def fused_outcomes(done, winner, collision, rewards) -> torch.Tensor:
    """The outcome counts and finished-episode return sums of a fused
    rollout's events (``done``/``collision`` bool[T, N], ``winner``
    i32[T, N], ``rewards`` f32[T, 2, N]) on their own device: f64[7], the
    ``OUTCOME_COUNTS`` (exact int64 sums) then player 1's and player 2's
    return sums (f32 sums, as the JAX package's numpy takes them).  A
    finished episode's return is every reward up to its env's last done
    step; the tail after it belongs to an unfinished episode.
    """
    counts = torch.stack([
        done.sum(), (done & (winner == 1)).sum(), (done & (winner == 2)).sum(),
        (done & collision).sum(), (done & (winner == 0) & ~collision).sum()])
    steps = torch.arange(done.shape[0], device=done.device)[:, None]
    last_done = torch.where(done, steps, -1).amax(dim=0)          # [N]
    in_finished = steps <= last_done                              # [T, N]
    ret_sums = (rewards * in_finished[:, None, :]).sum(dim=(0, 2))
    return torch.cat([counts.double(), ret_sums.double()])


def _finalize(counts, ret_sums):
    eps = max(counts["episodes"], 1)
    return {
        **counts,
        "p1_first_rate": counts["p1_first"] / eps,
        "p2_first_rate": counts["p2_first"] / eps,
        "collision_rate": counts["collisions"] / eps,
        "timeout_rate": counts["timeouts"] / eps,
        "mean_return_p1": float(ret_sums[0]) / eps,
        "mean_return_p2": float(ret_sums[1]) / eps,
    }


def mlp_plain_pair(w1: list, w2: list, x1, x2, dtype):
    """``mlp_plain(w1, x1)`` and ``mlp_plain(w2, x2)`` of two nets of one
    shape in one pass over stacked operands: every product and sum is the
    one ``mlp_plain`` makes, in its order, with half the launches (a
    change of this copy: the reference runs a whole matchup in every run).
    """
    h = torch.stack([x1, x2]).to(torch.float32).to(dtype)       # [2, N, K]
    for i in range(3):
        w = torch.stack([w1[2 * i], w2[2 * i]])                  # [2, K, O]
        b = torch.stack([w1[2 * i + 1], w2[2 * i + 1]])          # [2, O]
        wf = w.to(torch.float32)
        acc = seq_sum(h.to(torch.float32)[:, :, :, None] * wf[:, None], 2)
        h = acc.to(dtype) + b[:, None, :]
        if i < 2:
            h = torch.clamp_min(h, 0.0)
    q = h.to(torch.float32)
    return q[0], q[1]
