"""K9's plain version: the fused recurrent DQN (DRQN) trainer's chunk, in
plain PyTorch.

Frozen copy of ``ops/fused_drqn.py`` (``fused_drqn_init``,
``fused_drqn_chunk_plain``, ``_grads_plain``, the window flush, the ring
and ``_schedule``) and of ``nn/lstm.py:drqn_init`` of
``merging_gym_tpu_torch`` at commit e973796041560, with its imports of the
port replaced by the copies in this folder, and without the greedy mode
and the injected sample draws, which no cell uses.  Nothing here imports
the port or JAX.

Where the copy looped over slices, it sums whole tensors in the same order
(``nets.seq_sum``: one ``cumsum`` on the card); each such change keeps
every product and sum of the original and their order.  The input side's
gate term ``x2 w_ih`` is formed for every timestep before the recurrence,
as the learner's ``in_kernel`` forms it; each step then adds it in the
original order.  The learner's batch enters through :func:`learn_math`
with the windows on the last axis, and both seats' picks through
:func:`select`, module-level names that ``perfbench/faults.py`` plants
faults in.

The net is the published DRQN (Hausknecht & Stone, arXiv:1507.06527) at
the widths the reference declares (``scripts/main.py:49-74``): fc1 10 ->
200 (ReLU, U(0, 1) weights), fc2 200 -> 16, one LSTM layer 16 -> 16 (torch
gate order i, f, g, o), fc3 16 -> 16 (ReLU), fc4 16 -> 5; 7,949 f32
parameters.  Truncated BPTT over windows of L steps and one bootstrap
observation from zero state, burn-in and first-done masks, per-timestep
Double-DQN targets, Adam.  Departures from the published DRQN, all of the
port's:

- the gradient flows back through the burn-in steps (their loss terms are
  masked, their states are not detached);
- ``b_ih`` and ``b_hh`` stay two parameters with their own moments (they
  receive the same gradient), so the parameters round-trip to torch's
  ``nn.LSTM`` and to the JAX package;
- the window keeps 16 rows a slot (obs 10, action, reward, done, 3 rows of
  padding), the TPU's layout.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import constants as C
from perfbench.reference import env as core_env
from perfbench.reference import philox
from perfbench.reference.dqn import (OPP_FROZEN, OPP_L0, OPP_SELFPLAY,
                                     _adam_plain, _batch_sum, _init_env_rows,
                                     _outer_sum)
from perfbench.reference.env import lon2coord, random_reset_vals
from perfbench.reference.nets import (greedy_threshold, linear_params, select,
                                      seq_sum)

HID = 16            # LSTM width (main.py:52-53)
H1 = 200            # fc1 width (main.py:60-61)
IN_DIM = C.OBS_DIM  # 10
A = C.NUM_ACTIONS   # 5
SLOT = 16           # rows per window slot
ENV_ROWS = 11 + 4 * HID  # 75: pos 2, vel 2, xy 4, winner, t, reward, h/c x 2

# (name, shape) of the flat parameter layout, in order.
LAYOUT = (("fc1.w", (IN_DIM, H1)), ("fc1.b", (H1,)),
          ("fc2.w", (H1, HID)), ("fc2.b", (HID,)),
          ("lstm.w_ih", (HID, 4 * HID)), ("lstm.b_ih", (4 * HID,)),
          ("lstm.w_hh", (HID, 4 * HID)), ("lstm.b_hh", (4 * HID,)),
          ("fc3.w", (HID, HID)), ("fc3.b", (HID,)),
          ("fc4.w", (HID, A)), ("fc4.b", (A,)))
P = sum(math.prod(s) for _, s in LAYOUT)  # 7,949

# Windows per summation tile of the learner's gradient sums.
LEARN_WINDOWS = 4


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def views(flat: torch.Tensor) -> list:
    """The twelve ``[in, out]`` views of a flat parameter buffer."""
    out, o = [], 0
    for _, shape in LAYOUT:
        k = math.prod(shape)
        out.append(flat[o:o + k].view(shape))
        o += k
    return out


def lstm_cell_init(generator, input_size, hidden_size, device):
    """torch ``nn.LSTM`` single-layer init: U(-k, k), k = 1/sqrt(hidden),
    drawn in the order w_ih, w_hh, b_ih, b_hh."""
    k = 1.0 / math.sqrt(hidden_size)

    def u(*shape):
        return torch.empty(*shape, dtype=torch.float32,
                           device=device).uniform_(-k, k, generator=generator)

    w_ih = u(input_size, 4 * hidden_size)
    w_hh = u(hidden_size, 4 * hidden_size)
    return {"w_ih": w_ih, "w_hh": w_hh, "b_ih": u(4 * hidden_size),
            "b_hh": u(4 * hidden_size)}


def drqn_init(generator, num_inputs, num_actions, device) -> dict:
    """fc1 and fc2 with U(0, 1) weights, the LSTM and fc3/fc4 with torch's
    defaults."""
    return {
        "fc1": linear_params(generator, num_inputs, H1, device=device,
                             weight_init="uniform01"),
        "fc2": linear_params(generator, H1, HID, device=device,
                             weight_init="uniform01"),
        "lstm": lstm_cell_init(generator, HID, HID, device),
        "fc3": linear_params(generator, HID, HID, device=device,
                             weight_init="torch"),
        "fc4": linear_params(generator, HID, num_actions, device=device,
                             weight_init="torch"),
    }


def params_to_flat(params: dict, device) -> torch.Tensor:
    """A :func:`drqn_init` dict -> one flat f32 buffer (:data:`LAYOUT`)."""
    parts = []
    for name, shape in LAYOUT:
        layer, key = name.split(".")
        x = params[layer][key]
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.array(x, np.float32))
        parts.append(x.to(device=device, dtype=torch.float32).reshape(-1))
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# Plain arithmetic of the kernels
# ---------------------------------------------------------------------------

def _acc(x, w):
    """``sum_k x[..., k] * w[k, :]`` in k order from 0, each multiply and
    add rounded: every forward product (the dense layers, both gate
    products) goes through here."""
    return seq_sum(x[..., :, None] * w, -2, from_zero=True)


def _back(d, w):
    """``sum_j w[k, j] * d[..., j]`` in j order from 0."""
    return seq_sum(d[..., :, None] * w.T, -2, from_zero=True)


def _relu(x):
    return torch.clamp_min(x, 0.0)


def _sigmoid(x):
    """``1 / (1 + exp(-x))`` as one IEEE division."""
    return torch.ones_like(x) / (1.0 + torch.exp(-x))


def _gates(v, gx, h):
    """``((x2 w_ih + b_ih) + h w_hh) + b_hh``, ``gx`` = ``x2 w_ih``."""
    return (gx + v[5] + _acc(h, v[6])) + v[7]


def _tail(g, c):
    """LSTM elementwise tail: gate pre-activations [..., 64] and the
    previous cell -> (gi, gf, gg, go, c_new, tanh(c_new), h_new)."""
    gi, gf = _sigmoid(g[..., 0:HID]), _sigmoid(g[..., HID:2 * HID])
    gg, go = torch.tanh(g[..., 2 * HID:3 * HID]), _sigmoid(g[..., 3 * HID:])
    c_new = gf * c + gi * gg
    tc = torch.tanh(c_new)
    return gi, gf, gg, go, c_new, tc, go * tc


def cell_fwd(flat, x, h, c):
    """One recurrent actor step: x [n, 10], h/c [n, 16] -> (q, h, c)."""
    v = views(flat)
    x2 = _acc(_relu(_acc(x, v[0]) + v[1]), v[2]) + v[3]
    *_, c_new, _, h_new = _tail(_gates(v, _acc(x2, v[4]), h), c)
    q = _acc(_relu(_acc(h_new, v[8]) + v[9]), v[10]) + v[11]
    return q, h_new, c_new


def _unroll(v, X):
    """One net's learner forward over windows X [B, T1, 10]: the input side
    over all timesteps, then the recurrence from zero state."""
    B, T1 = X.shape[0], X.shape[1]
    z1 = _acc(X, v[0]) + v[1]
    x2 = _acc(_relu(z1), v[2]) + v[3]
    gx = _acc(x2, v[4])
    h = torch.zeros(B, HID, device=X.device)
    c = torch.zeros(B, HID, device=X.device)
    steps = []
    for t in range(T1):
        gi, gf, gg, go, c_new, tc, h = _tail(_gates(v, gx[:, t], h), c)
        steps.append((gi, gf, gg, go, c, tc, h))
        c = c_new
    cells = [torch.stack(s, dim=1) for s in zip(*steps)]
    z3 = _acc(cells[6], v[8]) + v[9]
    q = _acc(_relu(z3), v[10]) + v[11]
    return {"z1": z1, "x2": x2, "cells": cells, "z3": z3, "q": q}


def _masks(done, burn_in):
    """Past burn-in and before the first in-window episode end: f32
    [B, L] of 0/1."""
    ended = torch.zeros_like(done[:, 0])
    cols = []
    for t in range(done.shape[1]):
        cols.append(1.0 - ended if t >= burn_in else torch.zeros_like(ended))
        ended = torch.maximum(ended, done[:, t])
    return torch.stack(cols, dim=1)


def _grads_plain(p, tp, batch, *, gamma, burn_in, windows):
    """Gradient (flat layout), loss and valid count of one learn.
    ``batch`` rows-first: obs [B, L+1, 10], action [B, L], reward [B, L],
    done [B, L] (f32)."""
    f32 = torch.float32
    X = batch["obs"].to(f32)
    act = batch["action"].to(torch.int64)
    rew, done = batch["reward"].to(f32), batch["done"].to(f32)
    B, L = act.shape
    v = views(p)
    fe, ft = _unroll(v, X), _unroll(views(tp), X)

    # Valid count as an integer, then 2 / msum as one IEEE division.
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

    # Per-tile sums over the tile's windows, rows window by window in t
    # order, then the tiles in order.
    tile = windows * L

    def rows(x):
        return x.reshape(B * L, -1)

    def out(a, b):
        return _outer_sum(rows(a), rows(b), tile)

    def bsum(d):
        return _batch_sum(rows(d), tile)

    parts = [out(X[:, :L], dz1), bsum(dz1), out(_relu(z1), dx2), bsum(dx2),
             out(fe["x2"][:, :L], da), bsum(da), out(hprev, da), bsum(da),
             out(h, dz3), bsum(dz3), out(_relu(z3), dq), bsum(dq)]
    grad = torch.cat([x.reshape(-1) for x in parts])
    loss = bsum(lterm)[0] / msum
    return grad, loss, msum


def learn_math(p, tp, m, v, batch, t, *, gamma, lr, burn_in):
    """One BPTT Double-DQN + Adam step on flat buffers; returns ``(new_p,
    new_m, new_v, loss)``.  ``batch`` env-last: obs ``[L+1, 10, B]``,
    action, reward and done ``[L, B]`` (f32), the windows on the last axis;
    ``t`` the 1-based Adam step."""
    rows = {"obs": batch["obs"].permute(2, 0, 1), "action": batch["action"].T,
            "reward": batch["reward"].T, "done": batch["done"].T}
    grad, loss, _ = _grads_plain(p, tp, rows, gamma=gamma, burn_in=burn_in,
                                 windows=LEARN_WINDOWS)
    new_p, new_m, new_v = _adam_plain(p, m, v, grad, int(t), lr)
    return new_p, new_m, new_v, loss


def slab_batch(slab: torch.Tensor, L: int) -> dict:
    """A sampled window slab ``[(L + 1) * 16, B]`` -> :func:`learn_math`'s
    batch."""
    s = slab.reshape(L + 1, SLOT, slab.shape[1])
    return {"obs": s[:, :IN_DIM], "action": s[1:, IN_DIM],
            "reward": s[1:, IN_DIM + 1], "done": s[1:, IN_DIM + 2]}


# ---------------------------------------------------------------------------
# Carry
# ---------------------------------------------------------------------------

def _obs_rows(e):
    """The 10 obs rows of env rows ``e`` (pos 2, vel 2, xy 4, ...)."""
    return torch.stack([
        e[6] - e[4], e[7] - e[5], e[3] - e[2], C.END_POINT - e[0], e[2],
        e[4] - e[6], e[5] - e[7], e[2] - e[3], C.END_POINT - e[1], e[3]])


def fused_drqn_init(seed: int, cfg, env_params, num_envs: int,
                    opp_params=None, *, learn_batch=None,
                    device=None) -> dict:
    """Fresh training state: ``cfg.memory_capacity`` windows, R = capacity //
    num_envs ring rounds; ``learn_batch`` (default ``num_envs``) whole
    windows per learn.  The nets and random starts draw from a generator
    seeded with ``seed`` on ``device`` (default ``cuda``)."""
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
    if cfg.opponent == OPP_FROZEN and opp_params is None:
        raise ValueError("frozen opponent needs params")
    L = int(cfg.seq_len)
    dev = torch.device("cuda" if device is None else device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    p = params_to_flat(drqn_init(generator, IN_DIM, A, dev), dev)
    tp = params_to_flat(drqn_init(generator, IN_DIM, A, dev), dev)
    opp = params_to_flat(opp_params, dev) if opp_params is not None else p
    n = num_envs
    env = torch.zeros(ENV_ROWS, n, device=dev)
    env[0:8] = _init_env_rows(env_params, generator, n)
    WF = (L + 1) * SLOT
    win = torch.zeros(WF, n, device=dev)
    win[0:IN_DIM] = _obs_rows(env[0:8])   # slot 0: the first observation
    return {
        "p": p, "tp": tp, "m": torch.zeros_like(p), "v": torch.zeros_like(p),
        "opp": opp, "env": env, "win": win,
        "ring": torch.zeros(R * WF, n, device=dev),
        "ring_hbm": int(R * WF * n * 4 > 24 * 1024 * 1024),
        "R": R, "n": n, "B": B, "L": L, "warm": 0, "learns": 0, "steps": 0,
        "env_steps": 0, "episodes": 0.0, "collisions": 0.0, "wins": 0.0,
        "sum_ep_reward": 0.0, "last_loss": 0.0,
    }


def chunk_learns(carry, num_steps) -> int:
    """Learn count added by a ``num_steps`` chunk (ring-full gated)."""
    full_at = carry["R"] * carry["L"] - 1
    prior = carry.get("steps", 0)
    warmup_left = 0 if carry["warm"] else max(full_at - prior, 0)
    return max(num_steps - warmup_left, 0)


def apply_chunk(carry, out, num_steps, met_sum, loss) -> dict:
    """Fold a chunk's outputs back into the carry dict."""
    steps = carry.get("steps", 0) + num_steps
    full_at = carry["R"] * carry["L"] - 1
    return {
        **carry, **out,
        "warm": 1 if steps >= full_at else 0,
        "steps": steps,
        "learns": carry["learns"] + chunk_learns(carry, num_steps),
        "env_steps": carry["env_steps"] + num_steps * carry["n"],
        "episodes": carry["episodes"] + float(met_sum[0]),
        "collisions": carry["collisions"] + float(met_sum[1]),
        "wins": carry["wins"] + float(met_sum[2]),
        "sum_ep_reward": carry["sum_ep_reward"] + float(met_sum[3]),
        "last_loss": float(loss),
    }


def _schedule(carry, num_steps, target_sync):
    """Per step ``(i, wl, flush?, ring round, learns?, syncs?, Adam t)``:
    the window phase, the flush on its last step into round ``(s // L) %
    R``, and the learn gate, open from global step R*L - 1."""
    warm, prior = int(carry["warm"]), int(carry["learns"])
    L, R = carry["L"], carry["R"]
    base = carry.get("steps", 0) % (L * R)
    full_at = R * L - 1
    for i in range(num_steps):
        s = base + i
        learn = bool(warm) or s >= full_at
        lc = prior + (i if warm else i - (full_at - base))
        yield (i, s % L, s % L == L - 1, (s // L) % R, learn,
               learn and lc % target_sync == 0, lc + 1)


# ---------------------------------------------------------------------------
# One chunk
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
    return apply_chunk(carry, out, num_steps, met, float(st["loss"]))


def _draws(carry, num_steps, seed):
    """The learner's ``(rounds, cols)`` of every step, drawn on the host
    from ``seed ^ 0xD7D7``."""
    R, n, B = carry["R"], carry["n"], carry["B"]
    g = torch.Generator().manual_seed(seed ^ 0xD7D7)
    rounds = torch.randint(0, R, (num_steps,), generator=g)
    cols = torch.randint(0, n // B, (num_steps,), generator=g)
    return rounds.tolist(), cols.tolist()


def fused_drqn_chunk_plain(cfg, env_params, carry, num_steps, seed) -> dict:
    """``num_steps`` Phi(eps)-greedy DRQN training steps from ``carry``;
    returns the new carry (the input carry is left as it was)."""
    if cfg.opponent not in (OPP_L0, OPP_SELFPLAY, OPP_FROZEN):
        raise ValueError(f"unknown opponent mode {cfg.opponent!r}")
    rounds, cols = _draws(carry, num_steps, seed)
    st = working_state(carry)
    n, B, L = carry["n"], carry["B"], carry["L"]
    WF = (L + 1) * SLOT
    key = philox.seed_key(seed)
    thr = greedy_threshold(cfg.epsilon)
    dev = st["env"].device
    f32 = torch.float32
    for i, wl, emit, r_cur, learn, sync, t in _schedule(
            carry, num_steps, cfg.target_sync):
        gstep = carry["steps"] + i
        env = st["env"]
        pos, vel = env[0:2], env[2:4]
        obs = _obs_rows(env[0:8]).T                              # [n, 10]
        hc = env[11:].T.reshape(n, 4, HID)

        # Both seats' recurrent actors.
        bits = philox.draw(gstep, n, philox.STREAM_ACTIONS, key, dev)
        q1, h1, c1 = cell_fwd(st["p"], obs, hc[:, 0], hc[:, 1])
        a1 = select(q1, bits[0], bits[1], False, thr)
        if cfg.opponent == OPP_L0:
            a2 = torch.full_like(a1, C.ACTION_NONE)
            h2, c2 = hc[:, 2], hc[:, 3]
        else:
            opp = st["p"] if cfg.opponent == OPP_SELFPLAY else st["opp"]
            q2, h2, c2 = cell_fwd(opp, core_env.swap_obs(obs), hc[:, 2],
                                  hc[:, 3])
            a2 = select(q2, bits[2], bits[3], False, thr)

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
            slab = st["ring"][rounds[i] * WF:(rounds[i] + 1) * WF,
                              cols[i] * B:(cols[i] + 1) * B]
            st["p"], st["m"], st["v"], st["loss"] = learn_math(
                st["p"], st["tp"], st["m"], st["v"], slab_batch(slab, L), t,
                gamma=cfg.gamma, lr=cfg.lr, burn_in=cfg.burn_in)

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
