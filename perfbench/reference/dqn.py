"""K5's plain version: the fused Double-DQN trainer's chunk, in plain PyTorch.

Frozen copy of ``ops/fused_trainer.py`` of ``merging_gym_tpu_torch`` at
commit 79f5ae92604b, with its imports of the port replaced by the copies
in this folder. Nothing here imports the port or JAX.

Where the copy loops over slices, it now sums whole tensors in the
same order (``nets.seq_sum``); each such change keeps every product and
sum of the original and their order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import constants as C
from perfbench.reference import env as core_env
from perfbench.reference import philox
from perfbench.reference.env import lon2coord, random_reset_vals, reset_batch, true_div
from perfbench.reference.nets import (compute_dtype_of, greedy_threshold, mlp_plain,
                                      mlp_plain_layers, qnet_init, select, seq_sum,
                                      tile_size)

OPP_L0 = "L0"
OPP_SELFPLAY = "selfplay"
OPP_FROZEN = "frozen"
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
NUM_F = 24
ENV_ROWS = 11
K5_TILE = 16


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


def learn_tile(dims, elem_size: int) -> int:
    """Lanes per learner block: the largest power of two up to
    ``K5_TILE`` whose shared-memory tile fits (it divides every batch,
    a multiple of 128)."""
    d_in, h1, h2, a = dims
    tile = tile_size(K5_TILE, (2 * d_in + 4 * a + h1 + h2 + 4) * 4,
                             (d_in + 2 * h1 + 2 * h2 + a) * elem_size)
    return 1 << (tile.bit_length() - 1)


def _tile_sum(parts):
    return seq_sum(parts, 0, from_zero=True)


def _batch_sum(x, tile):
    """Sum over the batch axis in the kernels' order: each tile of
    ``tile`` lanes in lane order, then the tiles in order."""
    xt = x.reshape(x.shape[0] // tile, tile, *x.shape[1:])
    return _tile_sum(seq_sum(xt, 1, from_zero=True))


def _outer_sum(h, d, tile):
    """``sum_b h[b, :, None] * d[b, None, :]`` in the kernels' order."""
    ht = h.to(torch.float32).reshape(h.shape[0] // tile, tile, -1)
    dt = d.to(torch.float32).reshape(d.shape[0] // tile, tile, -1)
    part = seq_sum(ht[:, :, :, None] * dt[:, :, None, :], 1, from_zero=True)
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
    dz2 = seq_sum(w2.T[None] * dqc[:, :, None], 1, from_zero=True)
    dz2 = dz2 * (h2.to(f32) > 0.0).to(f32)                       # [B, H2]
    dz2c = dz2.to(dtype).to(f32)
    dz1 = seq_sum(w1.T[None] * dz2c[:, :, None], 1, from_zero=True)
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
    dev = torch.device("cuda" if device is None else device)
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
    out = {k: _transposed(st[k], dims) for k in ("p", "tp", "m", "v")}
    out["env"], out["ring"] = st["env"], st["ring"]
    met = st["met"].to(torch.float64).sum(dim=1).tolist()
    return apply_chunk(carry, out, num_steps, met, float(st["loss"]))


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
    rounds, cols, dtype = _prepare(cfg, env_params, carry, num_steps, seed,
                                   greedy, rounds, cols)
    dims = _dims(carry["p"])
    st = working_state(carry, dtype)
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
    return st
