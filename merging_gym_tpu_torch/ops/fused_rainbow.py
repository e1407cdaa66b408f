"""The whole Rainbow (C51 + NoisyNet + Dueling) trainer on the card (K8).

Replaces ``merging_gym_tpu/ops/fused_rainbow.py:_kernel`` (``pallas_call``
at :909 ``_call`` and :959 ``_call_hbm``, entry ``fused_rainbow_chunk``)
with its helpers ``_rb_fwd``, ``_rb_q``, ``_projection``,
``rainbow_learn_math``, ``nstep_batch_from_slabs``, ``per_pick``,
``per_gather_slabs`` and ``_fresh_eps``.  Per training step: the noisy
dueling C51 actor for the ego (argmax of E[Z] under the current noise,
optionally Phi(eps)-greedy), the opponent (the same net on the LEFT-rotated
obs, L0, or a frozen MLP through the Phi(0.7)-greedy pick), the env step,
the unconditional store of a ``[24]`` slab into an R-round ring (with PER,
its pad row 23 holds the transition's priority ``maxp ** alpha``, maxp read
before this step's learn), and once ``n_step + 1`` rounds are stored a
learn: PER's stratified inverse-CDF pick or the host-drawn (round, lane
window), the n-step reconstruction from consecutive slabs, the target net
on the bootstrap obs (selection and evaluation), the hat-form projection
with the faithful mass quirk, the online CE on the clamped selected-action
distribution, hand backprop through clamp, softmax, the dueling combine
and the four noisy layers (sigma gradients dW * eps), Adam, the PER
priority write-back; then fresh noise for both nets (outside greedy mode,
only after a learn), the episodic hard target sync (checked on every step)
and the auto-reset.

On the H100 a step is a sequence of hand-written kernels
(``kernels/csrc/rainbow_trainer.cu``) issued by :func:`fused_rainbow_chunk`
on the current stream, K5's design: ``rb_act`` (act / env / store, a few
envs a block, geometry :func:`act_geometry`), on a
learning step ``rb_per_pick`` (PER only, one block, its grid in shared
memory or a workspace: :func:`pick_launcher`, geometry
:func:`pick_geometry`), ``rb_learn_fwd`` (each sampled
lane's forwards and backward, a few lanes a block, its row factors to a
workspace; :class:`Learner`, geometry :func:`learn_geometry`) and
``rb_learn_grad`` (every gradient summed over the workspace in the plain
version's order, Adam fused), and on every step ``rb_post`` (noise,
target sync, effective weights and the online ones transposed, PER
write-back; a tile of one matrix a block: :func:`post_launcher`, geometry
:func:`post_geometry`).  The learn gate, the learn count and Adam's bias corrections
depend only on host counters.  The target sync depends on the data: the
act kernel adds each step's finished episodes to ``ep_step[i]`` (integer
atomics, so the sum does not depend on order) and ``rb_post`` decides the
sync from them; the chunk reads the card back at its start (the episode
total and the synced count) and at its end (metrics).

The plain version (:func:`fused_rainbow_chunk_plain`) repeats the kernels'
arithmetic and summation order: every sum runs in index order from 0, each
product and add rounded on its own, and the batch sums of the learner go
over ``learn_tile(B)`` lanes in lane order, then over the tiles in
order.  On
the card the two agree bit for bit.

Layout.  The JAX kernel packs the four noisy layers' ``[out, in]`` blocks
row-wise into ``[464, 64]`` arrays with 51 atoms padded to 56 rows; that
padding exists only for Mosaic's sublane alignment (``fused_rainbow.py:
31-38``).  The port keeps one flat f32 buffer per parameter set, in the
nested-dict order of ``nn.rainbow_net`` with ``[in, out]`` weights:
``linear1`` w, b; ``linear2`` w, b; then per noisy layer (value1,
value2, advantage1, advantage2) ``w_mu, w_sigma, b_mu, b_sigma`` --
58,884 floats, no pads (``P_OFF``).  Noise, the effective weights
``mu + sigma * eps`` and the noisy part of the gradient share an element
layout of 28,210 floats: per noisy layer ``w [in, out]`` then ``b``
(``E_OFF``).  The kernels read the effective weights, formed once per
change (after a learn, a noise draw or a sync) by ``rb_post``, not once
per env.  ``rainbow_carry_from_numpy`` converts JAX's packed carry.

The episode total of the target sync: JAX keeps per-lane f32 counts (env
row 12) and sums them in f32 each step.  The port keeps the same row but
sums it as integers (exact; JAX's f32 sum is exact below 2**24 episodes),
then applies the kernel's f32 rule ``floor(total * (1 / sync_eps))``.

Randomness: Philox4x32-10 at counter ``(global step, index, stream, 0)``
under the chunk's seed.  Stream 0: the ego's Phi(eps) pick (words 0, 1)
and the self-play opponent's (words 2, 3), index = env; stream 1: the
random start; stream 2: the frozen opponent's Phi(0.7) pick (words 0,
1); streams ``8 + 12 * net + 3 * layer + kind`` (net 0 online, 1 target;
layer 0-3 in the order above; kind 0 the input vector, 1 the output
vector, 2 the bias vector), index = the vector's element: each normal is
Box-Muller on words 0 and 1.  The host streams ``rounds`` (``seed ^
0x51C``), ``cols`` (``seed ^ 0xC01``) and ``us`` (``seed ^ 0xBE7``) come
from CPU ``torch.Generator``s and stay injectable.  ``ring_hbm`` is
recorded in the carry and changes nothing: the ring always lives in
device memory, and JAX's ``_call_hbm`` computes what ``_call`` computes.
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
from merging_gym_tpu_torch.nn.noisy import scale_noise
from merging_gym_tpu_torch.nn.rainbow_net import (NOISY_LAYERS, NUM_ATOMS,
                                                  TRUNK, V_MAX, V_MIN,
                                                  rainbow_init,
                                                  rainbow_sample_noise)
from merging_gym_tpu_torch.ops import fused_mlp as FM
from merging_gym_tpu_torch.ops import fused_trainer as FT
from merging_gym_tpu_torch.ops import philox
from merging_gym_tpu_torch.ops.fused_actor import greedy_threshold, phi
from merging_gym_tpu_torch.ops.fused_mlp import mlp_plain
from merging_gym_tpu_torch.ops.fused_rollout import (random_reset_vals,
                                                     rewards_cfg)

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

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_ACT_ARGS = [_P] * 7 + [_I] * 16 + [_U] * 5 + [_F] * 2 + [_I] + [_F] * 5 + [_P]
_PICK_ARGS = ([_P] * 5 + [_I] * 8 + [ctypes.c_longlong] + [_F] * 2
              + [_P])
_FWD_ARGS = [_P] * 13 + [_I] * 6 + [_F] * 3 + [_I] * 2 + [_P]
_GRAD_ARGS = [_P] * 6 + [_I] * 2 + [_F] * 8 + [_I] * 2 + [_P]
_POST_ARGS = [_P] * 13 + [_I] * 11 + [_U] * 3 + [_F] * 3 + [_P]

# ---------------------------------------------------------------------------
# Layouts: flat parameter / noise buffers <-> nested dicts <-> JAX packing
# ---------------------------------------------------------------------------

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


# JAX packing (merging_gym_tpu/ops/fused_rainbow.py:117-225): value1 rows
# 0:64, value2 64:120 (51 of 56), advantage1 120:184, advantage2 184:464
# (five 56-row groups of 51).
_JAX_ROWS = (0, 64, 120, 184)
_AP = 56


def _unpack_rows(block, layer):
    """Rows of a packed ``[464, k]`` block that hold ``layer``'s outputs,
    in output order."""
    block = np.asarray(block, np.float32)
    off, d_out = _JAX_ROWS[layer], NOISY_OUT[layer]
    if layer < 3:
        return block[off:off + d_out]
    return np.concatenate([block[off + a * _AP:off + a * _AP + ATOMS]
                           for a in range(A)])


def params_from_packed(p8) -> dict:
    """JAX's packed 8-tuple ``(t0T, t0b, t1T, t1b, nmuT, nmub, nsgT, nsgb)``
    (numpy) -> the ``nn.rainbow_net`` dict (numpy)."""
    t0T, t0b, t1T, t1b, nmuT, nmub, nsgT, nsgb = (np.asarray(a, np.float32)
                                                  for a in p8)
    out = {"linear1": {"w": t0T.T, "b": t0b[:, 0]},
           "linear2": {"w": t1T.T, "b": t1b[:, 0]}}
    for layer, name in enumerate(NOISY_LAYERS):
        out[name] = {"w_mu": _unpack_rows(nmuT, layer).T,
                     "w_sigma": _unpack_rows(nsgT, layer).T,
                     "b_mu": _unpack_rows(nmub, layer)[:, 0],
                     "b_sigma": _unpack_rows(nsgb, layer)[:, 0]}
    return out


def noise_from_packed(eps2) -> dict:
    """JAX's packed noise ``(epsT [464, 64], epsb [464, 1])`` -> dict."""
    epsT, epsb = eps2
    return {name: {"w_eps": _unpack_rows(epsT, layer).T,
                   "b_eps": _unpack_rows(epsb, layer)[:, 0]}
            for layer, name in enumerate(NOISY_LAYERS)}


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


# ---------------------------------------------------------------------------
# Plain version of the arithmetic (the kernels' order)
# ---------------------------------------------------------------------------

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


def _seq_sum(terms):
    """``0 + t0 + t1 + ...`` in order (every kernel sum starts at 0)."""
    acc = torch.zeros_like(terms[0])
    for t in terms:
        acc = acc + t
    return acc


def _dense(x, w, b, relu):
    """``y[r, j] = sum_k x[r, k] * w[k, j]`` in k order from 0, then + b."""
    acc = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32,
                      device=x.device)
    for k in range(w.shape[0]):
        acc = acc + x[:, k:k + 1] * w[k]
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
    mean = _seq_sum([adv[:, a] for a in range(A)]) * (1.0 / A)
    logits = (zv2[:, None, :] + adv) - mean[:, None, :]
    lm = torch.amax(logits, dim=-1, keepdim=True)
    e = torch.exp(logits - lm)
    s = _seq_sum([e[..., j:j + 1] for j in range(ATOMS)])
    return {"h1": h1, "h2": h2, "hv1": hv1, "ha1": ha1, "dist": e / s}


def rb_q(dist) -> torch.Tensor:
    """E[Z] per action, f32[N, A]."""
    z = support_values(dist.device)
    return _seq_sum([dist[..., j] * z[j] for j in range(ATOMS)])


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
    return _seq_sum([mass[:, k:k + 1] * torch.clamp_min(
        1.0 - torch.abs(b[:, k:k + 1] - iv), 0.0) for k in range(ATOMS)])


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
    ce = -_seq_sum([proj[:, j] * torch.log(clipped[:, j])
                    for j in range(ATOMS)])
    inr = ((dsel > 0.01) & (dsel < 0.99)).to(f32)
    g = (-(proj / clipped) * inr) * (w * (1.0 / B))[:, None]
    s = _seq_sum([g[:, j] * dsel[:, j] for j in range(ATOMS)])
    dl = dsel * g - dsel * s[:, None]
    onehot = (act[:, None] == torch.arange(A, device=dev)).to(f32)
    dza2 = ((onehot - 1.0 / A)[:, :, None] * dl[:, None, :]).reshape(B, -1)

    (w0, b0, w1, b1), noisy = _net(p, wp)

    def back(dz, W):  # sum_j W[k, j] * dz[b, j] in j order
        return _seq_sum([W[:, j] * dz[:, j:j + 1] for j in range(W.shape[1])])

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


def rainbow_learn_math(p, tp, m, v, eps, teps, batch, t, *, gamma, lr,
                       obs_scale, faithful, weights=None):
    """One C51 + Adam step; returns ``(new_p, new_m, new_v, loss, ce)``.

    The plain learner of K8 with the signature of the JAX
    ``rainbow_learn_math``: flat buffers (``p``, ``tp``, ``m``, ``v``;
    noise ``eps``, ``teps`` in the element layout), ``batch`` env-last
    (obs [10, n], action i32 [n], reward [n], next_obs [10, n], done bool
    [n]; raw obs), ``t`` the 1-based Adam step, ``weights`` the optional
    PER importance weights (the returned ``ce`` stays unweighted).
    """
    rows = {"obs": batch["obs"].T, "next_obs": batch["next_obs"].T,
            "action": batch["action"], "reward": batch["reward"],
            "done": batch["done"]}
    grad, loss, ce = _grads_plain(
        p, tp, effective_weights(p, eps), effective_weights(tp, teps), rows,
        weights, gamma=gamma, obs_scale=obs_scale, faithful=faithful)
    np_, nm, nv = _adam_full(p, m, v, grad, eps, int(t), lr)
    return np_, nm, nv, loss, ce


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


def _pow(x, e: float):
    """``x ** e`` as ``exp(e * log(max(x, 1e-30)))`` (``fused_rainbow.py:
    514-517``)."""
    return torch.exp(e * torch.log(torch.clamp_min(x, 1e-30)))


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


def _normals(gstep, num, stream, key, dev):
    """Box-Muller standard normals from Philox words 0, 1 at ``(gstep,
    i, stream, 0)``, i < num (``fused_rainbow.py:520-530``)."""
    w = philox.draw(gstep, num, stream, key, dev)
    u0 = (w[0] >> 8).to(torch.float32) * (1.0 / 16777216.0)
    u1 = (w[1] >> 8).to(torch.float32) * (1.0 / 16777216.0)
    r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u0, 1e-7)))
    return r * torch.cos((2.0 * 3.14159265358979) * u1)


def fresh_noise(gstep: int, net: int, key, dev) -> torch.Tensor:
    """One net's factorised noise in the element layout: per layer
    ``outer(f(in), f(out))`` and an independent bias vector."""
    parts = []
    for layer, d_out in enumerate(NOISY_OUT):
        s = STREAM_NOISE + 12 * net + 3 * layer
        fin = scale_noise(_normals(gstep, H1, s, key, dev))
        fout = scale_noise(_normals(gstep, d_out, s + 1, key, dev))
        parts += [(fout[None, :] * fin[:, None]).reshape(-1),
                  scale_noise(_normals(gstep, d_out, s + 2, key, dev))]
    return torch.cat(parts)


def pick_plain(ring, us, R, n, B, r_cur, stored, n_step, beta):
    """``rb_per_pick`` alone in plain PyTorch: the PER block of
    :func:`fused_rainbow_chunk_plain` on a ring f32[R * NUM_F, n] with
    offset ``us`` f32[1].  Returns ``(sel i32[2, B], wts f32[B])``."""
    dev = ring.device
    age = (r_cur - torch.arange(R, device=dev) + R) % R
    valid = (age >= n_step - 1) & (age <= stored - 1)
    P = torch.where(valid[:, None], ring[NUM_F - 1::NUM_F], 0.0)
    cdf, total = per_cdf(P)
    u = ((torch.arange(B, dtype=torch.float32, device=dev) + us[0])
         * (total * float(np.float32(1.0 / B))))
    r_b, l_b, p_sel = per_pick(P, u, cdf)
    pmin = torch.min(torch.where(P > 0.0, P, torch.inf))
    w = per_weights(p_sel, pmin, total, stored, n_step, n, beta)
    return torch.stack([r_b, l_b]).to(torch.int32), w


def transposes_plain(p, wp):
    """The online net's effective weights ``wp`` transposed per noisy layer
    (W^T [out, 64] at ``T_OFF[l]``), then its trunk's w1^T [64, 32]: what
    ``rb_post`` forms for the learner's backward."""
    parts = [wp[E_OFF[l]:E_OFF[l] + H1 * o].view(H1, o).t().reshape(-1)
             for l, o in enumerate(NOISY_OUT)]
    w1 = p[IN_DIM * H0 + H0:IN_DIM * H0 + H0 + H0 * H1].view(H0, H1)
    return torch.cat(parts + [w1.t().reshape(-1)])


def post_plain(st, tot, ep_step, ce, sel, *, i, regen, per_wb, check_sync,
               gstep, key, alpha, inv_sync, synced0):
    """``rb_post`` alone in plain PyTorch, on the working state ``st``
    (updated in place: eps, teps, tp, wp, wt, wpt, env rows 11 and 13, the
    ring's priorities) and the i32 episode totals ``tot`` (``tot[i + 1]``
    written): the post block of :func:`fused_rainbow_chunk_plain`, with its
    sync decided as the kernel decides it from ``tot[i]`` and
    ``ep_step[i]`` (the chunk's host running total).  ``sel`` i32[2, B]
    the picked (round, lane) of each CE in ``ce``."""
    n = st["env"].shape[1]
    R = st["ring"].shape[0] // NUM_F
    dev = st["env"].device
    if per_wb:
        pre = torch.clamp_min(ce + 1e-5, 1e-8)
        st["ring"].view(R, NUM_F, n)[sel[0].long(), NUM_F - 1,
                                     sel[1].long()] = _pow(pre, alpha)
        st["env"][13] = torch.maximum(st["env"][13], torch.max(pre))
    if regen:
        st["eps"] = fresh_noise(gstep, 0, key, dev)
        st["teps"] = fresh_noise(gstep, 1, key, dev)
    if check_sync:
        before = int(tot[i])
        now = before + int(ep_step[i])
        synced = float(synced0)
        if i > 0:
            synced = max(synced, float(np.floor(np.float32(before)
                                                * np.float32(inv_sync))))
        chunks = float(np.floor(np.float32(now) * np.float32(inv_sync)))
        if chunks > synced:
            st["tp"] = st["p"].clone()
        st["env"][11] = max(synced, chunks)
        tot[i + 1] = now
    st["wp"] = effective_weights(st["p"], st["eps"])
    st["wt"] = effective_weights(st["tp"], st["teps"])
    st["wpt"] = transposes_plain(st["p"], st["wp"])


# ---------------------------------------------------------------------------
# Carry
# ---------------------------------------------------------------------------

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
    dev = resolve_device(device)
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


def rainbow_carry_from_numpy(carry: dict, device=None) -> dict:
    """A JAX fused-Rainbow carry (packed ``[464, 64]`` blocks, numpy or
    JAX leaves) -> the port's carry on ``device``."""
    dev = resolve_device(device)

    def tensor(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=dev)

    out = {k: carry[k] for k in ("R", "n", "warm", "learns", "steps",
                                 "env_steps")}
    for k in ("p", "tp", "m", "v"):
        out[k] = params_to_flat(params_from_packed(
            [np.asarray(a) for a in carry[k]]), dev)
    for k in ("eps", "teps"):
        out[k] = noise_to_flat(noise_from_packed(
            [np.asarray(a) for a in carry[k]]), dev)
    opp = [np.asarray(a, np.float32) for a in carry["opp"]]
    out["opp"] = (None if opp[0].shape == (1, 1)
                  else tuple(tensor(a) for a in opp))
    out["env"], out["ring"] = tensor(carry["env"]), tensor(carry["ring"])
    out["B"] = int(carry.get("B", carry["n"]))
    out["ring_hbm"] = int(carry.get("ring_hbm", 0))
    for k in ("R", "n", "warm", "learns", "steps", "env_steps"):
        out[k] = int(out[k])
    for k in ("episodes", "collisions", "wins", "sum_ep_reward",
              "last_loss"):
        out[k] = float(carry[k])
    return out


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


# ---------------------------------------------------------------------------
# The act kernel on the card: geometry
# ---------------------------------------------------------------------------

# rb_act (rainbow_trainer.cu:rb_act_kernel): floats a row of a pass of its
# arrays (kActRowFloats: the scaled obs, h1, h2, hv1 | ha1, value2's and
# advantage2's outputs, the distributions and q, each row padded), bytes
# of the online net held whole (the trunk and the effective noisy weights,
# kNumG floats, 16-byte sized), and the tiles of its widest pass (value2
# with advantage2, 306 columns) that the micro-tile aims for: two a thread
# (chip_smoke.py:rb_act_sweep put 4x1 at 8 envs a block 11% ahead of 4x2,
# one a thread, and the rule's pick ahead at 4, 16 and 32 too).
ACT_ROW_FLOATS = 836
ACT_NET_BYTES = (NUM_G * 4 + 15) // 16 * 16         # 122,704
ACT_MIN_TILES = 512


def act_micro_tile(prows: int) -> tuple:
    """(RM, RN) of the act kernel's passes of ``prows`` rows:
    ``FM.micro_tile``'s rule with ``ACT_MIN_TILES`` on its widest pass,
    value2 and advantage2 (64 -> 51 + 255) taken as one layer."""
    return FM.micro_tile((H1, ATOMS + A * ATOMS, 1, 1), prows, ACT_MIN_TILES)


def act_smem(rows: int, seats: int, resident: int, opp_dims=None,
             chunk: int = 0) -> int:
    """Shared-memory bytes of one ``rb_act`` block (``rainbow_trainer.cu:
    RbActSmem``): the online net where it is held, the arrays of ``seats *
    rows`` rows, and with a frozen opponent of widths ``opp_dims`` its
    MLP's layout (``act_tiled.cuh:ActSmem`` for ``rows`` rows, the weights
    streamed through two buffers of ``chunk`` floats)."""
    n = (ACT_NET_BYTES if resident else 0) + seats * rows * ACT_ROW_FLOATS * 4
    if opp_dims is not None:
        n += FT.act_smem((tuple(opp_dims),), rows, 4, 0, chunk, 1)
    return n


def act_tiling(rows: int, seats: int = 1, opp_dims=None,
               resident: int | None = None) -> FT.ActGeometry | None:
    """The act geometry for blocks of ``rows`` envs, ``seats * rows`` rows a
    pass (self-play: 2), a frozen opponent's MLP of widths ``opp_dims``
    streamed (None: no such opponent): the online net held in shared memory
    where it fits (``resident`` forces 1 or 0; at 0 its layers are read
    from global memory), the opponent's weights through two buffers that
    take the rest of the block's shared memory (``FM.weight_chunk``); None
    where that leaves no room."""
    rm, rn = act_micro_tile(seats * rows)
    for held in (1, 0) if resident is None else (resident,):
        smem = act_smem(rows, seats, held)
        if opp_dims is None:
            if smem <= kernels.SMEM_LIMIT:
                return FT.ActGeometry(rows, rm, rn, held, 0, smem)
            continue
        room = kernels.SMEM_LIMIT - act_smem(rows, seats, held, opp_dims)
        chunk = FM.weight_chunk(tuple(opp_dims), room, 4)
        if chunk is not None:
            return FT.ActGeometry(rows, rm, rn, held, chunk, act_smem(
                rows, seats, held, opp_dims, chunk))
    return None


@functools.lru_cache(maxsize=None)
def act_geometry(num_envs: int, sms: int, seats: int = 1,
                 opp_dims=None) -> FT.ActGeometry:
    """``rb_act``'s launch geometry for ``num_envs`` envs on ``sms`` SMs
    (:func:`act_tiling`'s arguments otherwise): the smallest power of two
    of envs a block (at most ``FT.ACT_ROWS_MAX``) that needs no more blocks
    than the card has SMs, halved while nothing fits.  At the CLI's 1,024
    envs on 132 SMs: 8 envs a block in 128 blocks, the online net held."""
    top = 1
    while top < FT.ACT_ROWS_MAX and -(-num_envs // top) > sms:
        top *= 2
    for rows in (top >> i for i in range(top.bit_length())):
        g = act_tiling(rows, seats, opp_dims)
        if g is not None:
            return g
    raise ValueError(f"a frozen opponent of widths {opp_dims} does not fit "
                     f"the {kernels.SMEM_LIMIT} B of shared memory of a block")


# ---------------------------------------------------------------------------
# The learner on the card: geometry, workspace, launches
# ---------------------------------------------------------------------------

# rb_learn_fwd (rainbow_trainer.cu:learn_fwd_kernel) is built for blocks of
# each of LEARN_LANES sampled lanes; its shared memory is two weight
# buffers of CHUNK floats (the widest layer, advantage2, whole) and
# LANE_FLOATS floats a lane (kLaneFloats).
LEARN_LANES = (1, 2, 4, 8)
CHUNK = H1 * A * ATOMS                      # 16,320
LANE_FLOATS = 1764
# rb_learn_grad: 256, 512 or 1,024 threads a block, each summing 16
# entries of a summation tile; its shared memory parks the partial sums of
# the tiles in flight, 64 bytes a thread.
GRAD_THREADS = (256, 512, 1024)

# The workspace (rainbow_trainer.cu:kWs*): one row per sampled lane of
# these column groups in order, each a multiple of 4 floats.  A 1 follows
# each first factor (x and the online net's hidden layers): its bias's
# row.  dl's group ends with the lane's ce * w, the loss's term.
WS_GROUPS = (("x", 12), ("h1", 36), ("h2", 68), ("hv1", 68), ("ha1", 68),
             ("dz1", 32), ("dz2", 64), ("dzv1", 64), ("dl", 52),
             ("dza1", 64), ("dza2", 256))
WS_COLS = {name: sum(w for _, w in WS_GROUPS[:i])
           for i, (name, _) in enumerate(WS_GROUPS)}
WS_WIDTH = sum(w for _, w in WS_GROUPS)     # 784
WS_ONES = (WS_COLS["x"] + IN_DIM, WS_COLS["h1"] + H0, WS_COLS["h2"] + H1,
           WS_COLS["hv1"] + H1, WS_COLS["ha1"] + H1)

# The online net's effective weights transposed, which rb_post forms for
# the learner's backward: per noisy layer W^T [out, 64], then w1^T [64, 32].
T_OFF = tuple(H1 * sum(NOISY_OUT[:i]) for i in range(len(NOISY_OUT) + 1))
NUM_T = T_OFF[-1] + H0 * H1                 # 29,824


class LearnGeometry(NamedTuple):
    """Launch geometry of the learner: ``lanes`` sampled lanes per block of
    ``rb_learn_fwd`` and its ``smem`` bytes; ``grad_threads`` threads per
    block of ``rb_learn_grad`` and its ``grad_smem`` bytes."""
    lanes: int
    smem: int
    grad_threads: int
    grad_smem: int


def learn_smem(lanes: int) -> int:
    """Shared-memory bytes of an ``rb_learn_fwd`` block of ``lanes``
    lanes (``rainbow_trainer.cu:learn_smem``)."""
    return 4 * (2 * CHUNK + lanes * LANE_FLOATS)


def learn_tiling(B: int, lanes: int,
                 grad_threads: int) -> LearnGeometry | None:
    """The geometry of ``lanes`` lanes per forward block and
    ``grad_threads`` threads per gradient block, or None where either is
    not one the kernels are built for, a block does not fit its shared
    memory, or the summation tile does not divide B."""
    smem = learn_smem(lanes)
    if (lanes not in LEARN_LANES or grad_threads not in GRAD_THREADS
            or smem > kernels.SMEM_LIMIT or B <= 0 or B % learn_tile(B)):
        return None
    return LearnGeometry(lanes, smem, grad_threads, 64 * grad_threads)


@functools.lru_cache(maxsize=None)
def learn_geometry(B: int, sm_count: int) -> LearnGeometry:
    """The learner's geometry for a batch of B lanes on ``sm_count`` SMs:
    the fewest of ``LEARN_LANES`` per block that need no more blocks than
    the card has SMs (else the most), as ``ops.fused_trainer.
    learn_geometry`` sizes K5's; the gradients at 256 threads a block, 32
    summation tiles in flight (the fastest of the sweep of chip_smoke.py
    at B 1,024).  Per-lane arithmetic does not
    depend on how lanes are grouped, so every geometry gives the same bits
    (the sweep holds them to it)."""
    if B <= 0 or B % learn_tile(B):
        raise ValueError(f"the learner sums tiles of {learn_tile(B)} "
                         f"lanes; B = {B} is not a multiple")
    lanes = next((n for n in LEARN_LANES if -(-B // n) <= sm_count),
                 LEARN_LANES[-1])
    return learn_tiling(B, lanes, GRAD_THREADS[0])


def new_workspace(B: int, device) -> torch.Tensor:
    """The learner's workspace, B rows of :data:`WS_WIDTH` floats: zeros,
    and the ones of the bias rows (the kernel writes the rest)."""
    ws = torch.zeros(B, WS_WIDTH, device=device)
    ws[:, list(WS_ONES)] = 1.0
    return ws


class Learner:
    """The launches of K8's learner (``rb_learn_fwd`` and ``rb_learn_grad``
    of ``rainbow_trainer.cu``) on the working state ``st`` (see
    :func:`working_state`, with ``wpt``, the online net's transposed
    weights that ``rb_post`` forms) for a batch of B lanes, with its
    workspace.  The state must lie on the card: nothing here runs on the
    CPU.  ``geometry``: a :class:`LearnGeometry` in place of
    :func:`learn_geometry`'s (the sweep of chip_smoke.py)."""

    def __init__(self, st, B: int, geometry=None):
        dev = kernels.require_cuda(*(st[k] for k in (
            "p", "tp", "m", "v", "eps", "wp", "wt", "wpt", "ring", "loss")))
        self.st, self.B, self.tile = st, B, learn_tile(B)
        self.g = geometry or learn_geometry(B, FM.sm_count(dev))
        self.ws = new_workspace(B, dev)
        self.stream = kernels.stream_ptr(dev)
        self.fn = {name: kernels.function("rainbow_trainer",
                                          f"mgt_rb_learn_{name}", args)
                   for name, args in (("fwd", _FWD_ARGS),
                                      ("grad", _GRAD_ARGS))}

    def _launch(self, name, *args):
        rc = self.fn[name](*args, self.stream)
        kernels.check("rainbow_trainer", rc, f"rainbow_learn_{name} launch")
        kernels.launch_counts[f"rainbow_learn_{name}"] += 1

    def launch(self, cfg, rounds, cols, sel, wts, gpow, ce, t):
        """One learn: the batch from the first draw of the i32 device
        streams ``rounds``/``cols`` or, with ``cfg.per``, from ``sel``
        (rounds, lanes) with importance weights ``wts``; ``gpow`` the f32
        discounts gamma ** k, ``t`` Adam's step.  Each lane's CE goes to
        ``ce``, the loss to ``st["loss"]``."""
        st, g, ptr = self.st, self.g, kernels.ptr
        n, B = st["ring"].shape[1], self.B
        scale = 1.0 if cfg.obs_scale is None else float(cfg.obs_scale)
        self._launch("fwd", ptr(st["p"]), ptr(st["tp"]), ptr(st["wp"]),
                     ptr(st["wt"]), ptr(st["wpt"]), ptr(st["ring"]),
                     ptr(rounds), ptr(cols), ptr(sel), ptr(wts), ptr(gpow),
                     ptr(self.ws), ptr(ce), n,
                     st["ring"].shape[0] // NUM_F, B, cfg.n_step,
                     int(cfg.per), int(cfg.faithful_c51), float(cfg.gamma),
                     scale, float(np.float32(1.0 / B)), g.lanes, g.smem)
        c1, c2 = FT.adam_bias_corrections(t)
        self._launch("grad", ptr(self.ws), ptr(st["p"]), ptr(st["m"]),
                     ptr(st["v"]), ptr(st["eps"]), ptr(st["loss"]), B,
                     self.tile, float(cfg.lr), FT.ADAM_B1, FT.ADAM_B2,
                     1.0 - FT.ADAM_B1, 1.0 - FT.ADAM_B2, FT.ADAM_EPS, c1, c2,
                     g.grad_threads, g.grad_smem)


# ---------------------------------------------------------------------------
# The PER pick and the post on the card: geometry, launches
# ---------------------------------------------------------------------------

# rb_per_pick (rainbow_trainer.cu:rb_per_pick_kernel): one block of
# PICK_THREADS threads (kPickThreads); its grid of R * n / 128 chunks of 128
# priorities, each PICK_STRIDE floats apart, then the chunk sums and their
# prefix (pick_floats), held in shared memory where they fit and in a
# global workspace otherwise.
PICK_THREADS = 512
PICK_STRIDE = 132
PICK_SHARED, PICK_GLOBAL = 0, 1


class PickGeometry(NamedTuple):
    """The pick's ``layout`` (:data:`PICK_SHARED` or :data:`PICK_GLOBAL`),
    its ``smem`` bytes and the floats of its workspace (0 in shared
    memory)."""
    layout: int
    smem: int
    ws_floats: int


def pick_floats(R: int, n: int) -> int:
    """Floats of the pick's grid, chunk sums and prefix
    (``rainbow_trainer.cu:pick_floats``)."""
    C = R * (n // 128)
    return C * PICK_STRIDE + 2 * C


def pick_tiling(R: int, n: int, layout: int) -> PickGeometry | None:
    """The pick's geometry in ``layout``, or None where the shared layout
    does not fit a block's shared memory."""
    floats = pick_floats(R, n)
    if layout == PICK_SHARED:
        return (PickGeometry(PICK_SHARED, 4 * floats, 0)
                if 4 * floats <= kernels.SMEM_LIMIT else None)
    return PickGeometry(PICK_GLOBAL, 0, floats)


@functools.lru_cache(maxsize=None)
def pick_geometry(R: int, n: int) -> PickGeometry:
    """The pick's layout for a ring of R rounds of ``n`` lanes: its grid in
    shared memory where it fits (R * n up to 55,424 slots: 34,304 B at the
    CLI's R 8, n 1,024), else in a global workspace (R 16, n 4,096)."""
    if n <= 0 or n % 128 or R <= 0:
        raise ValueError(f"the PER pick takes n a multiple of 128 and R >= 1,"
                         f" got n={n}, R={R}")
    return (pick_tiling(R, n, PICK_SHARED)
            or pick_tiling(R, n, PICK_GLOBAL))


# rb_post (rainbow_trainer.cu:rb_post_kernel): a block owns a tile of
# POST_TILE (in rows, out columns) of one [in][out] matrix: the online net's
# four noisy layers, its trunk's w1 (transposed only), the target net's four
# noisy layers; one block more does the lanes' work.  POST_THREADS threads a
# block, each drawing at most one factor or bias entry and holding
# POST_EPT of the tile's entries (kPostTi, kPostTo, kPostThreads,
# kPostEpt).
POST_MATRICES = tuple((H1, o) for o in NOISY_OUT) + ((H0, H1),) + tuple(
    (H1, o) for o in NOISY_OUT)
POST_TILE = (16, 32)
POST_THREADS = 256
POST_EPT = 2


class PostGeometry(NamedTuple):
    """``rb_post``'s tile of ``ti`` in-rows x ``to`` out-columns,
    ``threads`` a block and ``blocks``."""
    ti: int
    to: int
    threads: int
    blocks: int


def post_blocks() -> int:
    """Blocks of ``rb_post``: every matrix's tiles, and the lanes' block
    (``rainbow_trainer.cu:post_blocks``)."""
    ti, to = POST_TILE
    return 1 + sum((k // ti) * -(-o // to) for k, o in POST_MATRICES)


@functools.lru_cache(maxsize=None)
def post_geometry() -> PostGeometry:
    """``rb_post``'s geometry: tiles of 16 in-rows x 32 out-columns at 256
    threads, 117 blocks (one wave on the H100's 132 SMs), a thread two
    entries and at most one draw."""
    return PostGeometry(*POST_TILE, POST_THREADS, post_blocks())


def pick_launcher(ring, sel, wts, B: int, n_step: int, beta: float,
                  geometry=None):
    """``pick(r_cur, stored, u)``: one ``rb_per_pick`` launch on the ring
    f32[R * NUM_F, n] into ``sel`` i32[2, B] and ``wts`` f32[B], its
    offset the f32 ``u`` (a one-element device tensor); ``geometry`` in
    place of :func:`pick_geometry`'s.  Everything must lie on the card."""
    dev = kernels.require_cuda(ring, sel, wts)
    n = ring.shape[1]
    R = ring.shape[0] // NUM_F
    g = geometry or pick_geometry(R, n)
    ws = (torch.empty(g.ws_floats, dtype=torch.float32, device=dev)
          if g.ws_floats else None)
    fn = kernels.function("rainbow_trainer", "mgt_rb_per_pick", _PICK_ARGS)
    stream, ptr = kernels.stream_ptr(dev), kernels.ptr
    inv_b = float(np.float32(1.0 / B))

    def pick(r_cur, stored, u):
        rc = fn(ptr(ring), ptr(u), ptr(sel), ptr(wts), ptr(ws), n, R, B,
                r_cur, stored, n_step, g.layout, g.smem,
                g.ws_floats, inv_b, float(beta), stream)
        kernels.check("rainbow_trainer", rc, "rainbow_per_pick launch")
        kernels.launch_counts["rainbow_per_pick"] += 1
    return pick


def post_launcher(st, tot, ep_step, ce, sel, B: int, key, alpha: float,
                  inv_sync: float, synced0: float, geometry=None):
    """``post(i, regen, per_wb, check_sync, gstep)``: one ``rb_post``
    launch of step i on the working state ``st`` (with ``wpt``), the i32
    episode totals ``tot`` and per-step counts ``ep_step``, the learn's
    ``ce`` and picks ``sel``; ``geometry`` in place of
    :func:`post_geometry`'s.  Everything must lie on the card."""
    dev = kernels.require_cuda(*(st[k] for k in (
        "p", "tp", "eps", "teps", "wp", "wt", "wpt", "env", "ring")), tot,
        ep_step, ce, sel)
    n, R = st["env"].shape[1], st["ring"].shape[0] // NUM_F
    g = geometry or post_geometry()
    fn = kernels.function("rainbow_trainer", "mgt_rb_post", _POST_ARGS)
    stream, ptr = kernels.stream_ptr(dev), kernels.ptr
    bufs = [st[k] for k in ("p", "tp", "eps", "teps", "wp", "wt", "wpt",
                            "env", "ring")] + [tot, ep_step, ce, sel]

    def post(i, regen, per_wb, check_sync, gstep):
        rc = fn(*(ptr(b) for b in bufs), n, R, B, i, regen, per_wb,
                check_sync, *g, key[0], key[1], gstep, float(alpha),
                float(inv_sync), float(synced0), stream)
        kernels.check("rainbow_trainer", rc, "rainbow_post launch")
        kernels.launch_counts["rainbow_post"] += 1
    return post


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

def fused_rainbow_chunk(cfg, env_params, carry, num_steps, seed, *,
                        greedy=False, rounds=None, cols=None, us=None,
                        act_geom=None) -> dict:
    """Run ``num_steps`` Rainbow training steps; returns the new carry.

    ``rounds`` (i32 ``[num_steps]``, default drawn on the host from ``seed
    ^ 0x51C``): the uniform path's start round per step; ``cols`` the lane
    window when ``learn_batch < num_envs`` (``seed ^ 0xC01``); ``us`` (f32
    in [0, 1), ``seed ^ 0xBE7``) PER's stratified offset per step.
    ``greedy=True`` makes the actors pure argmax, skips every Philox draw
    and keeps the noise; with explicit streams the chunk is then
    deterministic.  A carry on the CPU runs the plain version; on the card
    K8 runs, 2 launches per warm-up step and 4 (uniform) or 5 (PER) per
    learning step, with no read-back inside the chunk.  The input carry is
    left as it was.  ``act_geom``: the act kernel's launch geometry in
    place of :func:`act_geometry`'s (a forced partial last block in the
    card's checks); the plain version has none.
    """
    st, learned = chunk_state(cfg, env_params, carry, num_steps, seed,
                              greedy=greedy, rounds=rounds, cols=cols, us=us,
                              act_geom=act_geom)
    return _finish(carry, st, num_steps, cfg.n_step, learned)


def chunk_state(cfg, env_params, carry, num_steps, seed, *, greedy=False,
                rounds=None, cols=None, us=None, act_geom=None) -> tuple:
    """``(st, learned)``: the working state (:func:`working_state`) after a
    chunk, not yet folded into a carry, and whether its last step learned:
    K8 on the card, the plain version on the CPU (``parallel.spmd``
    averages it over the ranks before the fold)."""
    if carry["env"].device.type == "cpu":
        return _plain_state(cfg, env_params, carry, num_steps, seed, greedy,
                            rounds, cols, us)
    rounds, cols, us = _prepare(cfg, env_params, carry, num_steps, seed,
                                greedy, rounds, cols, us)
    st = working_state(carry)
    learned = launch_rainbow(st, carry, cfg, env_params, num_steps, seed,
                             greedy, rounds, cols, us, act_geom=act_geom)
    return st, learned


def launch_rainbow(st, carry, cfg, env_params, num_steps, seed, greedy,
                   rounds, cols, us, geometry=None, act_geom=None) -> bool:
    """Issue K8's kernels for ``num_steps`` steps on the current stream,
    updating the working state ``st`` (see :func:`working_state`) in
    place; returns whether the last step learned.  ``geometry``: the
    learner's, in place of :func:`learn_geometry`'s; ``act_geom``: the act
    kernel's, in place of :func:`act_geometry`'s."""
    n, B = carry["n"], carry.get("B", carry["n"])
    ns = cfg.n_step
    frozen = cfg.opponent == FT.OPP_FROZEN
    names = ("p", "tp", "m", "v", "eps", "teps", "wp", "wt", "env", "ring",
             "met", "loss")
    dev = kernels.require_cuda(*(st[k] for k in names),
                               *((st["opp"],) if frozen else ()))
    opp_dims = FT._dims(carry["opp"]) if frozen else (IN_DIM, 1, 1, A)
    if frozen and (opp_dims[0] != IN_DIM or opp_dims[3] != A):
        raise ValueError("the frozen opponent must be a 10 -> 5 Q-net")
    st["wpt"] = torch.empty(NUM_T, dtype=torch.float32, device=dev)
    learner = Learner(st, B, geometry)
    seats = 2 if cfg.opponent == FT.OPP_SELFPLAY else 1
    g = act_geom or act_geometry(n, FM.sm_count(dev), seats,
                                 opp_dims if frozen else None)
    total0, synced0 = _sync_start(st["env"])
    tot = torch.zeros(num_steps + 1, dtype=torch.int32)
    tot[0] = total0
    tot = tot.to(dev)
    ep_step = torch.zeros(num_steps, dtype=torch.int32, device=dev)
    rounds_d = torch.as_tensor(rounds, dtype=torch.int32, device=dev)
    cols_d = torch.as_tensor(cols, dtype=torch.int32, device=dev)
    us_d = torch.as_tensor(us, dtype=torch.float32, device=dev)
    ce = torch.zeros(B, dtype=torch.float32, device=dev)
    sel = torch.zeros(2, B, dtype=torch.int32, device=dev)
    wts = torch.ones(B, dtype=torch.float32, device=dev)
    key = philox.seed_key(seed)
    stream = kernels.stream_ptr(dev)
    act = kernels.function("rainbow_trainer", "mgt_rb_act", _ACT_ARGS)
    pick = (pick_launcher(st["ring"], sel, wts, B, ns, cfg.per_beta)
            if cfg.per else None)
    post = post_launcher(st, tot, ep_step, ce, sel, B, key,
                         cfg.per_alpha,
                         float(np.float32(1.0 / cfg.target_sync_episodes)),
                         synced0)
    ptr = kernels.ptr
    scale = 1.0 if cfg.obs_scale is None else float(cfg.obs_scale)
    opp_code = {FT.OPP_L0: 0, FT.OPP_SELFPLAY: 1, FT.OPP_FROZEN: 2}[
        cfg.opponent]
    has_eps = cfg.epsilon is not None and not greedy
    thr = greedy_threshold(cfg.epsilon) if cfg.epsilon is not None else 0
    thr70 = int(phi(0.7) * 4294967296.0)
    gpow = torch.tensor([float(np.float32(cfg.gamma ** k)) for k in range(ns)],
                        dtype=torch.float32).to(dev)
    env_args = (env_params.max_steps, *rewards_cfg(env_params))

    # The effective weights of the carry's nets, before the first step.
    post(0, 0, 0, 0, 0)
    learned = False
    for i, r_cur, learn, t, stored in _schedule(carry, num_steps, ns):
        gstep = (carry["steps"] + i) & philox.MASK32
        rc = act(ptr(st["p"]), ptr(st["wp"]), ptr(st["opp"]), ptr(st["env"]),
                 ptr(st["ring"]), ptr(st["met"]), ptr(ep_step[i:]), n,
                 g.rows, g.rm, g.rn, g.resident, g.chunk, g.smem, opp_code,
                 cfg.opponent_roll, int(has_eps), int(not greedy),
                 int(env_params.random_start), int(cfg.per), r_cur,
                 opp_dims[1], opp_dims[2], gstep, thr, thr70, *key, scale,
                 float(cfg.per_alpha), *env_args, stream)
        kernels.check("rainbow_trainer", rc, "rainbow_act launch")
        kernels.launch_counts["rainbow_act"] += 1
        learned = learn
        if learn:
            if cfg.per:
                pick(r_cur, stored, us_d[i:])
            learner.launch(cfg, rounds_d[i:], cols_d[i:], sel, wts, gpow, ce,
                           t)
        post(i, int(learn and not greedy), int(learn and cfg.per), 1, gstep)
    return learned
