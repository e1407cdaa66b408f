"""K8's plain version: the fused Rainbow trainer's chunk, in plain PyTorch.

Frozen copy of ``ops/fused_rainbow.py`` of ``merging_gym_tpu_torch`` at
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
from perfbench.reference import dqn as FT
from perfbench.reference import env as core_env
from perfbench.reference import philox
from perfbench.reference.env import lon2coord, random_reset_vals
from perfbench.reference.nets import (NOISY_LAYERS, NUM_ATOMS, TRUNK, V_MAX, V_MIN, greedy_threshold,
                                      mlp_plain, phi, rainbow_init, rainbow_sample_noise,
                                      scale_noise, seq_sum)

A = 5
ATOMS = NUM_ATOMS
IN_DIM = 10
H0, H1 = TRUNK                              # 32, 64
NOISY_OUT = (H1, ATOMS, H1, A * ATOMS)      # value1, value2, adv1, adv2
NUM_F = FT.NUM_F                            # 24 ring fields per round
ENV_ROWS = 14   # pos 2, vel 2, xy 4, winner, t, ep_reward, synced chunks,
                # per-lane episode counts, PER running max priority
DELTA_Z = (V_MAX - V_MIN) / (ATOMS - 1)

TRUNK_P = IN_DIM * H0 + H0 + H0 * H1 + H1   # 2,464
P_OFF, E_OFF = [], []
_p, _e = TRUNK_P, 0
for _out in NOISY_OUT:
    P_OFF.append(_p)
    E_OFF.append(_e)
    _p += 2 * H1 * _out + 2 * _out
    _e += H1 * _out + _out
NUM_P, NUM_E = _p, _e                       # 58,884 and 28,210
NUM_G = TRUNK_P + NUM_E                     # gradient layout: trunk + mu
P_OFF, E_OFF = tuple(P_OFF), tuple(E_OFF)

LEARN_TILE = 16      # lanes per summation tile of the learner's batch
                     # sums (rb_learn_fwd / rb_learn_grad), 8 for a PER
                     # batch that 16 does not divide
STREAM_NOISE = 8
STREAM_FROZEN = philox.STREAM_OPPONENT

def _trunk_views(flat):
    o = 0
    out = []
    for shape in ((IN_DIM, H0), (H0,), (H0, H1), (H1,)):
        size = math.prod(shape)
        out.append(flat[o:o + size].view(shape))
        o += size
    return out


def flat_to_params(flat: torch.Tensor) -> dict:
    """A flat parameter buffer -> the ``nn.rainbow_net`` dict (views)."""
    w0, b0, w1, b1 = _trunk_views(flat)
    out = {"linear1": {"w": w0, "b": b0}, "linear2": {"w": w1, "b": b1}}
    for name, off, d_out in zip(NOISY_LAYERS, P_OFF, NOISY_OUT):
        w = H1 * d_out
        out[name] = {
            "w_mu": flat[off:off + w].view(H1, d_out),
            "w_sigma": flat[off + w:off + 2 * w].view(H1, d_out),
            "b_mu": flat[off + 2 * w:off + 2 * w + d_out],
            "b_sigma": flat[off + 2 * w + d_out:off + 2 * w + 2 * d_out]}
    return out


def _tensor(x, device):
    if torch.is_tensor(x):
        return x.to(dtype=torch.float32, device=device)
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def params_to_flat(params: dict, device=None) -> torch.Tensor:
    """``nn.rainbow_net`` dict (tensors or arrays) -> flat f32 buffer."""
    parts = [params["linear1"]["w"], params["linear1"]["b"],
             params["linear2"]["w"], params["linear2"]["b"]]
    for name in NOISY_LAYERS:
        p = params[name]
        parts += [p["w_mu"], p["w_sigma"], p["b_mu"], p["b_sigma"]]
    return torch.cat([_tensor(x, device).reshape(-1)
                      for x in parts]).contiguous()


def flat_to_noise(flat: torch.Tensor) -> dict:
    """A flat element-layout buffer -> ``{layer: {w_eps, b_eps}}`` (views);
    also the view of effective weights ``{layer: {w, b}}`` by key."""
    out = {}
    for name, off, d_out in zip(NOISY_LAYERS, E_OFF, NOISY_OUT):
        w = H1 * d_out
        out[name] = {"w_eps": flat[off:off + w].view(H1, d_out),
                     "b_eps": flat[off + w:off + w + d_out]}
    return out


def noise_to_flat(noise: dict, device=None) -> torch.Tensor:
    parts = []
    for name in NOISY_LAYERS:
        parts += [noise[name]["w_eps"], noise[name]["b_eps"]]
    return torch.cat([_tensor(x, device).reshape(-1)
                      for x in parts]).contiguous()


def _index_maps(device):
    """Per parameter: its gradient index and, for a sigma, its element (-1
    otherwise); per element: the parameter indices of its mu and sigma."""
    g_idx = np.arange(NUM_P, dtype=np.int64)
    e_idx = np.full(NUM_P, -1, np.int64)
    mu_idx = np.zeros(NUM_E, np.int64)
    sig_idx = np.zeros(NUM_E, np.int64)
    for po, eo, d_out in zip(P_OFF, E_OFF, NOISY_OUT):
        w = H1 * d_out
        ew = np.arange(w)
        eb = w + np.arange(d_out)
        for p0, e in ((po, ew), (po + w, ew), (po + 2 * w, eb),
                      (po + 2 * w + d_out, eb)):
            g_idx[p0 + np.arange(len(e))] = TRUNK_P + eo + e
        e_idx[po + w + ew] = eo + ew
        e_idx[po + 2 * w + d_out + np.arange(d_out)] = eo + eb
        mu_idx[eo + ew] = po + ew
        sig_idx[eo + ew] = po + w + ew
        mu_idx[eo + eb] = po + 2 * w + np.arange(d_out)
        sig_idx[eo + eb] = po + 2 * w + d_out + np.arange(d_out)
    return {k: torch.as_tensor(v, device=device) for k, v in
            (("g", g_idx), ("e", e_idx), ("mu", mu_idx), ("sig", sig_idx))}


_MAPS: dict = {}


def _maps(device):
    key = str(device)
    if key not in _MAPS:
        _MAPS[key] = _index_maps(device)
    return _MAPS[key]


def effective_weights(p: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """The noisy layers' ``mu + sigma * eps`` in the element layout."""
    mp = _maps(p.device)
    return p[mp["mu"]] + p[mp["sig"]] * eps


def support_values(device=None) -> torch.Tensor:
    """The kernel's support ``V_MIN + DELTA_Z * i`` in f32, two roundings
    (``fused_rainbow.py:137-140``)."""
    i = torch.arange(ATOMS, dtype=torch.float32, device=device)
    return V_MIN + DELTA_Z * i


def _net(p, weff):
    """Trunk views of ``p`` and ``(W, B)`` of each noisy layer in ``weff``."""
    w0, b0, w1, b1 = _trunk_views(p)
    eff = flat_to_noise(weff)
    return (w0, b0, w1, b1), [(eff[k]["w_eps"], eff[k]["b_eps"])
                              for k in NOISY_LAYERS]


def _dense(x, w, b, relu):
    """``y[r, j] = sum_k x[r, k] * w[k, j]`` in k order from 0, then + b."""
    acc = seq_sum(x[:, :, None] * w, 1, from_zero=True)
    y = acc + b
    return torch.clamp_min(y, 0.0) if relu else y


def rb_forward(p, weff, x) -> dict:
    """The noisy dueling C51 forward of ``x`` f32[N, 10] (already scaled):
    the hidden layers and ``dist`` f32[N, A, ATOMS]."""
    (w0, b0, w1, b1), noisy = _net(p, weff)
    h1 = _dense(x, w0, b0, True)
    h2 = _dense(h1, w1, b1, True)
    hv1 = _dense(h2, *noisy[0], True)
    zv2 = _dense(hv1, *noisy[1], False)
    ha1 = _dense(h2, *noisy[2], True)
    adv = _dense(ha1, *noisy[3], False).view(-1, A, ATOMS)
    mean = seq_sum(adv, 1, from_zero=True) * (1.0 / A)
    logits = (zv2[:, None, :] + adv) - mean[:, None, :]
    lm = torch.amax(logits, dim=-1, keepdim=True)
    e = torch.exp(logits - lm)
    s = seq_sum(e.movedim(-1, 0), 0, from_zero=True)[..., None]
    return {"h1": h1, "h2": h2, "hv1": hv1, "ha1": ha1, "dist": e / s}


def rb_q(dist) -> torch.Tensor:
    """E[Z] per action, f32[N, A]."""
    z = support_values(dist.device)
    return seq_sum((dist * z).movedim(-1, 0), 0, from_zero=True)


def _projection(next_probs, reward, done, gamma, faithful):
    """Hat-form projection (``fused_rainbow.py:273-287``), f32[N, ATOMS]."""
    z = support_values(next_probs.device)
    mass = next_probs * z if faithful else next_probs
    nd = 1.0 - done.to(torch.float32)
    tz = torch.clamp(reward[:, None] + (nd[:, None] * gamma) * z,
                     V_MIN, V_MAX)
    b = (tz - V_MIN) * (1.0 / DELTA_Z)
    if faithful:
        mass = mass * (torch.floor(b) != torch.ceil(b)).to(torch.float32)
    iv = torch.arange(ATOMS, dtype=torch.float32, device=z.device)
    return seq_sum(mass[:, :, None] * torch.clamp_min(
        1.0 - torch.abs(b[:, :, None] - iv), 0.0), 1, from_zero=True)


def learn_tile(batch: int) -> int:
    """Lanes per summation tile of the learner's batch sums: 16, or 8
    where 16 does not divide the batch (a PER batch is a multiple of 8)."""
    return LEARN_TILE if batch % LEARN_TILE == 0 else LEARN_TILE // 2


def _grads_plain(p, tp, wp, wt, batch, weights, *, gamma, obs_scale,
                 faithful):
    """Gradient (``NUM_G`` layout), loss and per-lane CE of one C51 learn
    on ``batch`` (rows-first: obs [B, 10], action, reward, next_obs,
    done), as the learner's kernels (``rb_learn_fwd``, ``rb_learn_grad``)
    compute them."""
    f32 = torch.float32
    scale = 1.0 if obs_scale is None else float(obs_scale)
    x = batch["obs"].to(f32) * scale
    xn = batch["next_obs"].to(f32) * scale
    act = batch["action"].to(torch.int64)
    B = x.shape[0]
    tile = learn_tile(B)
    dev = x.device
    w = (torch.ones(B, dtype=f32, device=dev) if weights is None
         else weights.to(f32))

    ft = rb_forward(tp, wt, xn)
    star = torch.argmax(rb_q(ft["dist"]), dim=-1)
    next_probs = ft["dist"][torch.arange(B, device=dev), star]
    proj = _projection(next_probs, batch["reward"].to(f32), batch["done"],
                       gamma, faithful)

    f = rb_forward(p, wp, x)
    dsel = f["dist"][torch.arange(B, device=dev), act]
    clipped = torch.clamp(dsel, 0.01, 0.99)
    ce = -seq_sum((proj * torch.log(clipped)).movedim(-1, 0), 0,
                  from_zero=True)
    inr = ((dsel > 0.01) & (dsel < 0.99)).to(f32)
    g = (-(proj / clipped) * inr) * (w * (1.0 / B))[:, None]
    s = seq_sum((g * dsel).movedim(-1, 0), 0, from_zero=True)
    dl = dsel * g - dsel * s[:, None]
    onehot = (act[:, None] == torch.arange(A, device=dev)).to(f32)
    dza2 = ((onehot - 1.0 / A)[:, :, None] * dl[:, None, :]).reshape(B, -1)

    (w0, b0, w1, b1), noisy = _net(p, wp)

    def back(dz, W):  # sum_j W[k, j] * dz[b, j] in j order
        return seq_sum(W.T[None] * dz[:, :, None], 1, from_zero=True)

    def mask(h):
        return (h > 0.0).to(f32)

    dzv1 = back(dl, noisy[1][0]) * mask(f["hv1"])
    dza1 = back(dza2, noisy[3][0]) * mask(f["ha1"])
    dz2 = (back(dzv1, noisy[0][0]) + back(dza1, noisy[2][0])) * mask(f["h2"])
    dz1 = back(dz2, w1) * mask(f["h1"])
    out = FT._outer_sum
    bsum = FT._batch_sum
    parts = [out(x, dz1, tile), bsum(dz1, tile), out(f["h1"], dz2, tile),
             bsum(dz2, tile)]
    for h, dz in ((f["h2"], dzv1), (f["hv1"], dl), (f["h2"], dza1),
                  (f["ha1"], dza2)):
        parts += [out(h, dz, tile), bsum(dz, tile)]
    grad = torch.cat([t.reshape(-1) for t in parts])
    loss = FT.true_div(bsum(ce * w, tile), float(B))
    return grad, loss, ce


def _adam_full(p, m, v, grad, eps, t, lr):
    """Adam over every parameter: mu and trunk gradients from ``grad``,
    sigma gradients ``dW * eps`` (``fused_rainbow.py:364-379``)."""
    mp = _maps(p.device)
    g = grad[mp["g"]]
    sig = mp["e"] >= 0
    g = torch.where(sig, g * eps[mp["e"].clamp_min(0)], g)
    return FT._adam_plain(p, m, v, g, t, lr)


def _noise_counters(net: int, dev) -> tuple:
    """The (index, stream) counters of one net's twelve noise vectors, in
    the order ``fresh_noise`` draws them, and their lengths."""
    sizes, idx, streams = [], [], []
    for layer, d_out in enumerate(NOISY_OUT):
        s = STREAM_NOISE + 12 * net + 3 * layer
        for k, size in enumerate((H1, d_out, d_out)):
            sizes.append(size)
            idx.append(torch.arange(size, dtype=torch.int64, device=dev))
            streams.append(torch.full((size,), s + k, dtype=torch.int64,
                                      device=dev))
    return sizes, torch.cat(idx), torch.cat(streams)


def fresh_noise(gstep: int, net: int, key, dev) -> torch.Tensor:
    """One net's factorised noise in the element layout: per layer
    ``outer(f(in), f(out))`` and an independent bias vector.  The twelve
    vectors' Philox words are drawn in one call (a change of this copy,
    which drew them one by one: each word depends on its counter alone,
    so the bits are the same)."""
    sizes, idx, streams = _noise_counters(net, dev)
    w = philox.philox4x32_10(torch.full_like(idx, gstep & philox.MASK32),
                             idx, streams, torch.zeros_like(idx), key)
    u0 = (w[0] >> 8).to(torch.float32) * (1.0 / 16777216.0)
    u1 = (w[1] >> 8).to(torch.float32) * (1.0 / 16777216.0)
    r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u0, 1e-7)))
    f = scale_noise(r * torch.cos((2.0 * 3.14159265358979) * u1)).split(sizes)
    parts = []
    for layer in range(len(NOISY_OUT)):
        fin, fout, fb = f[3 * layer:3 * layer + 3]
        parts += [(fout[None, :] * fin[:, None]).reshape(-1), fb]
    return torch.cat(parts)


def fused_rainbow_init(seed: int, cfg, env_params, num_envs: int,
                       opp_params=None, *, learn_batch=None, ring_hbm=None,
                       device=None) -> dict:
    """Fresh training state for K8 (the JAX ``fused_rainbow_init``, with
    its validation).

    ``cfg``: ``agents.rainbow.RainbowConfig``.  The learner batch is
    ``num_envs`` unless ``learn_batch`` (a multiple of 128 dividing
    ``num_envs``: a uniformly drawn lane window); with ``cfg.per`` it is
    the number of prioritised draws, default ``cfg.batch_size`` rounded up
    to a multiple of 8.  ``cfg.memory_capacity`` must be ``k * num_envs``
    with ``k >= n_step + 1``.  The net, both noise sets and random starts
    draw from a generator seeded with ``seed`` on ``device`` (default
    ``cuda``).
    """
    if cfg.num_actions != A or cfg.num_atoms != ATOMS:
        raise ValueError(f"fused_rainbow is compiled for {A} actions x "
                         f"{ATOMS} atoms")
    if num_envs % 128 != 0:
        raise ValueError(f"num_envs must be a multiple of 128, got {num_envs}")
    if cfg.n_step < 1:
        raise ValueError(f"n_step must be >= 1, got {cfg.n_step}")
    if cfg.per:
        B = (-(-cfg.batch_size // 8) * 8 if learn_batch is None
             else int(learn_batch))
        if B % 8 != 0 or B < 8:
            raise ValueError("with per, learn_batch must be a positive "
                             f"multiple of 8, got {B}")
    else:
        B = num_envs if learn_batch is None else int(learn_batch)
        if B % 128 != 0 or num_envs % B != 0:
            raise ValueError("learn_batch must be a multiple of 128 dividing "
                             f"num_envs, got learn_batch={B} "
                             f"num_envs={num_envs}")
    R = cfg.memory_capacity // num_envs
    if R < cfg.n_step + 1 or cfg.memory_capacity != R * num_envs:
        raise ValueError("memory_capacity must be k*num_envs with "
                         f"k >= n_step+1 = {cfg.n_step + 1}, got "
                         f"capacity={cfg.memory_capacity} num_envs={num_envs}")
    if (cfg.opponent == FT.OPP_FROZEN) != (opp_params is not None):
        raise ValueError("opp_params must be given exactly when "
                         f"opponent='frozen' (got {cfg.opponent!r})")
    n = num_envs
    if ring_hbm is None:  # the JAX rule, recorded only
        ring_hbm = (not cfg.per) and R * NUM_F * n * 4 > 24 * 1024 * 1024
    if ring_hbm and cfg.per:
        raise ValueError("ring_hbm supports the uniform path only; PER's "
                         "full-grid priority scan is VMEM-resident (see "
                         "docstring)")
    dev = torch.device("cuda" if device is None else device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    p = params_to_flat(rainbow_init(generator, cfg.obs_dim, A, ATOMS), dev)
    eps = noise_to_flat(rainbow_sample_noise(generator, A, ATOMS), dev)
    teps = noise_to_flat(rainbow_sample_noise(generator, A, ATOMS), dev)
    env = torch.zeros(ENV_ROWS, n, dtype=torch.float32, device=dev)
    env[0:8] = FT._init_env_rows(env_params, generator, n)
    env[13] = 1.0   # PER running max priority (per_init)
    return {
        "p": p, "tp": p.clone(), "m": torch.zeros_like(p),
        "v": torch.zeros_like(p), "eps": eps, "teps": teps,
        "opp": FT.params_to_t(opp_params, dev) if opp_params is not None
        else None,
        "env": env,
        "ring": torch.zeros(R * NUM_F, n, dtype=torch.float32, device=dev),
        "R": R, "n": n, "B": B, "ring_hbm": int(bool(ring_hbm)),
        "warm": 0, "learns": 0, "steps": 0, "env_steps": 0,
        "episodes": 0.0, "collisions": 0.0, "wins": 0.0, "sum_ep_reward": 0.0,
        "last_loss": 0.0,
    }


def fill_schedule(carry, num_steps) -> torch.Tensor:
    """Rounds stored after step i's ring write: min(steps + i + 1, R)."""
    return torch.clamp(carry["steps"] + torch.arange(num_steps) + 1,
                       max=carry["R"])


def draw_start_rounds(carry, num_steps, generator, n_step) -> torch.Tensor:
    """Uniform n-step start rounds (the JAX ``draw_start_rounds``): an age
    in ``[n_step - 1, stored - 1]`` mapped to its ring position."""
    R = carry["R"]
    u = torch.rand(num_steps, generator=generator, dtype=torch.float32)
    stored = fill_schedule(carry, num_steps)
    if n_step == 1:
        rounds = torch.floor(u * stored.to(torch.float32)).to(torch.int64)
        return torch.minimum(rounds, stored - 1)
    navail = torch.clamp_min(stored - (n_step - 1), 1)
    a = (n_step - 1) + torch.minimum(
        torch.floor(u * navail.to(torch.float32)).to(torch.int64), navail - 1)
    i = torch.arange(num_steps)
    return torch.remainder(carry["steps"] + i - a, R)


def apply_rainbow_chunk(carry, out, num_steps, met_sum, loss, nwarm=1):
    """Fold a chunk's outputs (``out``: p, tp, m, v, eps, teps, env, ring)
    into the carry: the warm gate, learns and metrics (``nwarm`` =
    ``cfg.n_step`` warm-up steps before the first learn)."""
    steps = carry["steps"] + num_steps
    warmup_left = 0 if carry["warm"] else max(nwarm - carry["steps"], 0)
    return {
        **carry, **out,
        "warm": 1 if steps >= nwarm else 0,
        "steps": steps,
        "learns": carry["learns"] + max(num_steps - warmup_left, 0),
        "env_steps": carry["env_steps"] + num_steps * carry["n"],
        "episodes": carry["episodes"] + float(met_sum[0]),
        "collisions": carry["collisions"] + float(met_sum[1]),
        "wins": carry["wins"] + float(met_sum[2]),
        "sum_ep_reward": carry["sum_ep_reward"] + float(met_sum[3]),
        "last_loss": float(loss),
    }


def _schedule(carry, num_steps, n_step):
    """Per step ``(i, ring round, learns?, Adam t, rounds stored)`` from the
    host counters (``fused_rainbow.py:713-715,721``)."""
    R, warm, prior = carry["R"], carry["warm"], carry["learns"]
    base = carry["steps"] % R
    filled = min(carry["steps"], R)
    for i in range(num_steps):
        learn = bool(warm) or base + i >= n_step
        lc = prior + (i if warm else i - (n_step - base))
        yield i, (base + i) % R, learn, lc + 1, min(filled + i + 1, R)


def _prepare(cfg, env_params, carry, num_steps, seed, greedy, rounds, cols,
             us):
    R, n = carry["R"], carry["n"]
    B = carry.get("B", n)
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps} (a "
                         "zero-step chunk would return the carry unchanged)")
    if rounds is None:
        rounds = draw_start_rounds(carry, num_steps,
                                   torch.Generator().manual_seed(seed ^ 0x51C),
                                   cfg.n_step)
    col_hi = 1 if cfg.per else n // B
    if cols is None:
        cols = torch.randint(0, col_hi, (num_steps,),
                             generator=torch.Generator().manual_seed(
                                 seed ^ 0xC01))
    if us is None:
        us = (torch.rand(num_steps, generator=torch.Generator().manual_seed(
            seed ^ 0xBE7)) if cfg.per else torch.zeros(num_steps))
    rounds = np.asarray(rounds, dtype=np.int32)
    cols = np.asarray(cols, dtype=np.int32)
    us = np.asarray(us, dtype=np.float32)
    if (rounds.shape != (num_steps,) or cols.shape != (num_steps,)
            or us.shape != (num_steps,)):
        raise ValueError("rounds/cols must be i32 [num_steps] and us "
                         "f32 [num_steps]")
    if (rounds.min() < 0 or rounds.max() >= R or cols.min() < 0
            or cols.max() >= col_hi):
        raise ValueError(f"rounds must lie in [0, {R}) and cols in "
                         f"[0, {col_hi}) (out-of-range values would train "
                         "on the wrong slab)")
    if us.min() < 0.0 or us.max() >= 1.0:
        raise ValueError("us must lie in [0, 1)")
    if env_params.random_start and greedy:
        raise ValueError("random starts need the Philox draws, which "
                         "greedy mode skips; drop one of the two")
    if cfg.opponent not in (FT.OPP_L0, FT.OPP_SELFPLAY, FT.OPP_FROZEN):
        raise ValueError(f"unknown opponent mode {cfg.opponent!r}")
    if carry.get("ring_hbm") and cfg.per:
        raise ValueError("ring_hbm carry with per config")
    return rounds, cols, us


def working_state(carry) -> dict:
    """Working copies of a carry's tensors (the carry stays untouched),
    with the effective weights of both nets."""
    st = {k: carry[k].to(torch.float32).contiguous().clone()
          for k in ("p", "tp", "m", "v", "eps", "teps", "env", "ring")}
    st["opp"] = (FT._flat(carry["opp"]).contiguous()
                 if carry.get("opp") is not None else None)
    dev = st["env"].device
    st["wp"] = effective_weights(st["p"], st["eps"])
    st["wt"] = effective_weights(st["tp"], st["teps"])
    st["met"] = torch.zeros(4, carry["n"], dtype=torch.float32, device=dev)
    st["loss"] = torch.zeros((), dtype=torch.float32, device=dev)
    return st


def _finish(carry, st, num_steps, n_step, last_learned):
    out = {k: st[k] for k in ("p", "tp", "m", "v", "eps", "teps", "env",
                              "ring")}
    met = st["met"].to(torch.float64).sum(dim=1).tolist()
    loss = float(st["loss"]) if last_learned else 0.0
    return apply_rainbow_chunk(carry, out, num_steps, met, loss,
                               nwarm=n_step)


def _sync_start(env):
    """``(episode total, synced chunks)`` at a chunk's start: the integer
    sum of the per-lane counts of row 12, and row 11."""
    return (int(env[12].to(torch.float64).sum().item()),
            float(env[11, 0].item()))


def _obs_of(env):
    pos, vel = env[0:2], env[2:4]
    x1, y1, x2, y2 = env[4], env[5], env[6], env[7]
    return torch.stack([x2 - x1, y2 - y1, vel[1] - vel[0],
                        C.END_POINT - pos[0], vel[0], x1 - x2, y1 - y2,
                        vel[0] - vel[1], C.END_POINT - pos[1], vel[1]],
                       dim=1)


def fused_rainbow_chunk_plain(cfg, env_params, carry, num_steps, seed, *,
                              greedy=False, rounds=None, cols=None,
                              us=None) -> dict:
    """Plain PyTorch version of K8 (see :func:`fused_rainbow_chunk`)."""
    st, learned = _plain_state(cfg, env_params, carry, num_steps, seed,
                               greedy, rounds, cols, us)
    return _finish(carry, st, num_steps, cfg.n_step, learned)


def _plain_state(cfg, env_params, carry, num_steps, seed, greedy, rounds,
                 cols, us) -> tuple:
    rounds, cols, us = _prepare(cfg, env_params, carry, num_steps, seed,
                                greedy, rounds, cols, us)
    st = working_state(carry)
    n, R, B = carry["n"], carry["R"], carry.get("B", carry["n"])
    ns = cfg.n_step
    key = philox.seed_key(seed)
    dev = st["env"].device
    f32 = torch.float32
    scale = 1.0 if cfg.obs_scale is None else float(cfg.obs_scale)
    thr = greedy_threshold(cfg.epsilon) if cfg.epsilon is not None else None
    thr70 = int(phi(0.7) * 4294967296.0)
    total, synced = _sync_start(st["env"])
    inv_sync = np.float32(1.0 / cfg.target_sync_episodes)
    learned = False
    for i, r_cur, learn, t, stored in _schedule(carry, num_steps, ns):
        gstep = carry["steps"] + i
        env = st["env"]
        obs = _obs_of(env)                                        # [n, 10]
        maxp = env[13]

        # Actors: argmax of E[Z] under the current noise.
        def act(o):
            q = rb_q(rb_forward(st["p"], st["wp"], o * scale)["dist"])
            return torch.argmax(q, dim=-1).to(torch.int32)

        bits = (philox.draw(gstep, n, philox.STREAM_ACTIONS, key, dev)
                if thr is not None and not greedy else None)
        a1 = act(obs)
        if bits is not None:
            a1 = torch.where(bits[0] < thr, a1, (bits[1] % A).to(torch.int32))
        if cfg.opponent == FT.OPP_L0:
            a2 = torch.full_like(a1, C.ACTION_NONE)
        elif cfg.opponent == FT.OPP_SELFPLAY:
            k = cfg.opponent_roll
            a2 = act(torch.cat([obs[:, k:], obs[:, :k]], dim=1))
            if bits is not None:
                a2 = torch.where(bits[2] < thr, a2,
                                 (bits[3] % A).to(torch.int32))
        else:
            dims = FT._dims(carry["opp"])
            q2 = mlp_plain(FT._natural(st["opp"], dims),
                           core_env.swap_obs(obs), f32)
            a2 = torch.argmax(q2, dim=-1).to(torch.int32)
            if not greedy:
                fb = philox.draw(gstep, n, STREAM_FROZEN, key, dev)
                a2 = torch.where(fb[0] < thr70, a2,
                                 (fb[1] % A).to(torch.int32))

        # Env step.
        state = core_env.EnvState(
            pos=env[0:2].T, vel=env[2:4].T, acc=torch.zeros(n, 2, device=dev),
            t=env[9].to(torch.int32), winner=env[8].to(torch.int32),
            done=torch.zeros(n, dtype=torch.bool, device=dev),
            r_acc=torch.zeros(n, 2, device=dev))
        ns_, ts = core_env.step(env_params, state,
                                torch.stack([a1, a2], dim=-1))
        done, r1 = ts.done, ts.rewards[:, 0]

        # Unconditional ring store; PER's pad row is maxp ** alpha.
        pad = _pow(maxp, cfg.per_alpha) if cfg.per else torch.zeros_like(r1)
        st["ring"][r_cur * NUM_F:(r_cur + 1) * NUM_F] = torch.cat([
            obs.T, ts.obs.T, torch.stack([a1.to(f32), r1, done.to(f32), pad])])

        # Metrics (win on the pre-step obs) and the per-lane episode count.
        ep = env[10] + r1
        won = done & (obs[:, 8] > obs[:, 3])
        met = st["met"]
        st["met"] = torch.stack([met[0] + done.to(f32),
                                 met[1] + ts.collision.to(f32),
                                 met[2] + won.to(f32),
                                 met[3] + torch.where(done, ep, 0.0)])
        ep = torch.where(done, 0.0, ep)
        ep_cum = env[12] + done.to(f32)
        total += int(done.sum().item())

        # Auto-reset.
        if env_params.random_start:
            pos_r, vel_r = random_reset_vals(gstep, n, key, f32, dev)
        else:
            pos_r = torch.full((n, 2), C.START_POINT, device=dev)
            vel_r = torch.full((n, 2), C.START_VEL, device=dev)
        d = done[:, None]
        npos = torch.where(d, pos_r, ns_.pos)
        nvel = torch.where(d, vel_r, ns_.vel)
        nx1, ny1 = lon2coord(npos[:, 0], +1.0)
        nx2, ny2 = lon2coord(npos[:, 1], -1.0)
        st["env"] = torch.stack([
            npos[:, 0], npos[:, 1], nvel[:, 0], nvel[:, 1], nx1, ny1, nx2,
            ny2, torch.where(done, 0, ns_.winner).to(f32),
            torch.where(done, 0, ns_.t).to(f32), ep, env[11], ep_cum,
            env[13]])

        # Learner.
        learned = learn
        if learn:
            ring = st["ring"]
            if cfg.per:
                rowi = torch.arange(R, device=dev)
                age = (r_cur - rowi + R) % R
                valid = (age >= ns - 1) & (age <= stored - 1)
                P = torch.where(valid[:, None], ring[NUM_F - 1::NUM_F], 0.0)
                cdf, tot_p = per_cdf(P)
                u = ((torch.arange(B, dtype=f32, device=dev) + float(us[i]))
                     * (tot_p * float(np.float32(1.0 / B))))
                r_b, l_b, p_sel = per_pick(P, u, cdf)
                pmin = torch.min(torch.where(P > 0.0, P, torch.inf))
                w = per_weights(p_sel, pmin, tot_p, stored, ns, n,
                                cfg.per_beta)
            else:
                r_b = torch.full((B,), int(rounds[i]), device=dev)
                l_b = int(cols[i]) * B + torch.arange(B, device=dev)
                w = None
            slabs = [ring.view(R, NUM_F, n)[(r_b + k) % R, :, l_b].T
                     for k in range(ns)]
            b = nstep_batch_from_slabs(slabs, cfg.gamma)
            rows = {"obs": b["obs"].T, "next_obs": b["next_obs"].T,
                    "action": b["action"], "reward": b["reward"],
                    "done": b["done"]}
            grad, st["loss"], ce = _grads_plain(
                st["p"], st["tp"], st["wp"], st["wt"], rows, w,
                gamma=cfg.gamma, obs_scale=cfg.obs_scale,
                faithful=cfg.faithful_c51)
            st["p"], st["m"], st["v"] = _adam_full(
                st["p"], st["m"], st["v"], grad, st["eps"], t, cfg.lr)

        # Post: PER write-back, fresh noise, target sync, effective weights.
        if learn and cfg.per:
            newp_pre = torch.clamp_min(ce + 1e-5, 1e-8)
            ring.view(R, NUM_F, n)[r_b, NUM_F - 1, l_b] = _pow(newp_pre,
                                                               cfg.per_alpha)
            st["env"][13] = torch.maximum(maxp, torch.max(newp_pre))
        if learn and not greedy:
            st["eps"] = fresh_noise(gstep, 0, key, dev)
            st["teps"] = fresh_noise(gstep, 1, key, dev)
        chunks = float(np.floor(np.float32(total) * inv_sync))
        if chunks > synced:
            st["tp"] = st["p"].clone()
        synced = max(synced, chunks)
        st["env"][11] = synced
        st["wp"] = effective_weights(st["p"], st["eps"])
        st["wt"] = effective_weights(st["tp"], st["teps"])
    return st, learned


def _pow(x, e: float):
    """``x ** e`` as ``exp(e * log(max(x, 1e-30)))`` (``fused_rainbow.py:
    514-517``)."""
    return torch.exp(e * torch.log(torch.clamp_min(x, 1e-30)))


def nstep_batch_from_slabs(slabs, gamma):
    """n-step transitions from ``n_step`` consecutive ring slabs
    (``[24, B]`` each, temporal order): the return truncated at the first
    episode end, done = any end in the window, the bootstrap obs of the
    stop round (``fused_rainbow.py:389-415``).  Env-last batch."""
    g0 = slabs[0]
    ret = torch.zeros_like(g0[21])
    nxt = torch.zeros_like(g0[10:20])
    alive = torch.ones_like(g0[22])
    n_step = len(slabs)
    for k, s in enumerate(slabs):
        done_k = s[22]
        ret = ret + (float(np.float32(gamma ** k)) * s[21]) * alive
        sel = alive * done_k if k < n_step - 1 else alive
        nxt = nxt + sel[None, :] * s[10:20]
        alive = alive * (1.0 - done_k)
    return {"obs": g0[0:10], "action": g0[20].to(torch.int32),
            "reward": ret, "next_obs": nxt, "done": alive < 0.5}


def per_cdf(P: torch.Tensor):
    """The cdf of a priority grid ``P`` f32[R, n] (invalid slots zeroed) in
    round-major order, as ``rb_per_pick`` computes it: each 128-lane chunk
    of a round summed in lane order from 0 (``local``), the chunk sums
    added in order (``C``), and ``cdf = C_excl + local`` inside a chunk.
    Returns ``(cdf f32[R * n], total)``."""
    R, n = P.shape
    chunks = P.reshape(R * (n // 128), 128)
    local = torch.zeros_like(chunks)
    acc = torch.zeros_like(chunks[:, 0])
    for j in range(128):
        acc = acc + chunks[:, j]
        local[:, j] = acc
    c_excl = torch.zeros_like(acc)
    run = torch.zeros((), dtype=torch.float32, device=P.device)
    for c in range(chunks.shape[0]):
        c_excl[c] = run
        run = run + acc[c]
    return (c_excl[:, None] + local).reshape(-1), run


def per_pick(P: torch.Tensor, u: torch.Tensor, cdf=None):
    """Proportional inverse-CDF pick (``fused_rainbow.py:427-478``): for
    targets ``u`` f32[B], the flat index ``searchsorted(cdf, u,
    side='right')``, clipped, over :func:`per_cdf`'s cdf in round-major
    order.  Returns ``(round, lane, p_sel)``."""
    R, n = P.shape
    if cdf is None:
        cdf, _ = per_cdf(P)
    idx = torch.clamp(torch.searchsorted(cdf, u, right=True), 0, R * n - 1)
    return idx // n, idx % n, P.reshape(-1)[idx]


def per_weights(p_sel, pmin, total, stored, n_step, n, beta):
    """Max-weight-normalised importance weights (``fused_rainbow.py:
    743-748``)."""
    nvalid = float(np.float32(stored - (n_step - 1))) * float(np.float32(n))
    nvalid = torch.tensor(nvalid, dtype=torch.float32, device=p_sel.device)
    ratio = nvalid / total
    w = _pow(p_sel * ratio, -beta)
    return w * _pow(pmin * ratio, beta)
