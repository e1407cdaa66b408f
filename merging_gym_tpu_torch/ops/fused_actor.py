"""Q-net forward and Phi(eps)-greedy actions as one kernel launch (K4).

Replaces ``merging_gym_tpu/ops/fused_actor.py:_actor_kernel``
(``pallas_call`` at :83, entry ``fused_eps_greedy_actions``), the actor
of the step-loop DQN trainer (``agents.dqn._choose_actions``).  On the
card it is ``kernels/csrc/fused_actor.cu``: a block runs K3's forward of
its rows (``kernels/csrc/qnet_tiled.cuh``, with K3's launch geometry,
``ops.fused_mlp.qnet_geometry``), then one thread per row takes the
first-occurrence argmax and the Phi(eps)-greedy pick; only the int32
actions leave the card.

The pick is the reference's ``randn() <= eps`` rule (main.py:105) as one
uniform draw: keep the greedy action iff a uint32 word is below
``Phi(eps) * 2**32``, else take another word modulo the action count.
Row ``r`` draws the Philox words at counter ``(0, r, 0, 0)`` under the
caller's seed (``ops.philox``), so the kernel and the plain version below
pick the same actions.  The TPU kernel drew from the TPU's PRNG, which
no other device reproduces: against it the actions agree in distribution
(P(greedy) = Phi(0.7) = 0.758), and exactly where the greedy arm is kept.

:func:`select` is the one definition of the pick that K4, K5 and K6
(and their plain versions) share; on the card it is ``phi_select`` of
``mlp.cuh``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from merging_gym_tpu_torch import kernels
from merging_gym_tpu_torch.ops import philox
from merging_gym_tpu_torch.ops.fused_mlp import (cast_weights,
                                                 compute_dtype_of, mlp_plain,
                                                 qnet_geometry, qnet_widths,
                                                 sm_count)

_ACTOR_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
               + [ctypes.c_uint32] * 3 + [ctypes.c_void_p])


def phi(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def greedy_threshold(epsilon: float) -> int:
    """uint32 threshold below which a Phi(eps)-greedy draw stays greedy."""
    return min(int(phi(epsilon) * 4294967296.0), 4294967295)


def select(q, mask_bits, rand_bits, greedy: bool, threshold: int):
    """First-occurrence argmax of ``q`` [N, A], or the Phi(eps)-greedy pick:
    the argmax where ``mask_bits < threshold``, else ``rand_bits % A``."""
    a = torch.argmax(q, dim=-1).to(torch.int32)
    if greedy:
        return a
    rand = (rand_bits % q.shape[-1]).to(torch.int32)
    return torch.where(mask_bits < threshold, a, rand)


def eps_greedy_pick(q: torch.Tensor, seed: int, epsilon: float):
    """K4's pick on Q-values ``q`` [N, A]: row ``r`` draws the Philox
    words at counter ``(0, r, 0, 0)`` under ``seed`` for :func:`select`
    (``parallel.spmd`` picks on its tensor-parallel Q-values with it)."""
    bits = philox.draw(0, q.shape[0], philox.STREAM_ACTIONS,
                       philox.seed_key(seed), q.device)
    return select(q, bits[0], bits[1], False, greedy_threshold(epsilon))


def fused_eps_greedy_actions_plain(params: dict, obs: torch.Tensor,
                                   seed: int, epsilon: float = 0.7,
                                   compute_dtype: str = "float32"):
    """Plain PyTorch version of K4 (see :func:`fused_eps_greedy_actions`)."""
    dtype = compute_dtype_of(compute_dtype)
    q = mlp_plain(cast_weights(params, dtype, obs.device), obs, dtype)
    return eps_greedy_pick(q, seed, epsilon)


def fused_eps_greedy_actions(params: dict, obs: torch.Tensor, seed: int,
                             epsilon: float = 0.7,
                             compute_dtype: str = "float32") -> torch.Tensor:
    """Actions ``i32[B]`` for observations ``f[B, in]`` in one launch (K4).

    ``params``: Q-net dict ``{fc0, fc1, fc2: {w, b}}``; ``seed``: int, to
    be varied per call.  ``compute_dtype="bfloat16"`` runs the forward in
    bf16 (the JAX step-loop actor's ``compute_dtype``).  CPU tensors run
    the plain version; CUDA tensors launch K4.
    """
    if obs.device.type == "cpu":
        return fused_eps_greedy_actions_plain(params, obs, seed, epsilon,
                                              compute_dtype)
    dtype = compute_dtype_of(compute_dtype)
    weights = cast_weights(params, dtype, obs.device)
    x = obs.to(torch.float32).contiguous()
    out = torch.empty(x.shape[0], dtype=torch.int32, device=obs.device)
    launch_actor(weights, x, out, seed, epsilon)
    return out


def launch_actor(weights: list, x: torch.Tensor, out: torch.Tensor,
                 seed: int, epsilon: float) -> None:
    """Launch K4: ``x`` f32[B, in] -> ``out`` i32[B] (preallocated)."""
    dev = kernels.require_cuda(x, out, *weights)
    widths = qnet_widths(weights, x)
    g = qnet_geometry(x.shape[0], widths, weights[0].element_size(),
                      sm_count(dev), q_per_row=widths[3])
    k0, k1 = philox.seed_key(seed)
    fn = kernels.function("fused_actor", "mgt_fused_actor", _ACTOR_ARGS)
    rc = fn(kernels.ptr(x), *map(kernels.ptr, weights), kernels.ptr(out),
            x.shape[0], *widths, int(weights[0].dtype == torch.bfloat16),
            g.rows, g.rm, g.rn, g.chunk, g.smem, greedy_threshold(epsilon),
            k0, k1, kernels.stream_ptr(dev))
    kernels.check("fused_actor", rc, "fused_actor launch")
    kernels.launch_counts["fused_actor"] += 1
