"""Rainbow network: dueling noisy C51 head over a small MLP trunk.

Counterpart of ``merging_gym_tpu/nn/rainbow_net.py`` and of the reference
``RainbowDQN`` (scripts/ranbowdqn.py:498-548): a 10 -> 32 -> 64 trunk
(torch-default init), then noisy value (64 -> 64 -> atoms) and noisy
advantage (64 -> 64 -> actions*atoms) streams, the dueling combine and a
softmax over atoms.  Params keep the JAX nested-dict layout (``linear1``,
``linear2``, ``noisy_value1``, ...; weights ``[in, out]``), so the JAX
package's params and ``model_zoo/RB_*/params.npz`` carry across unchanged.
Noise is an explicit dict (see ``nn.noisy``); ``noise=None`` is eval mode.
The matrix products are ``torch.matmul``: JAX computes this net outside
any Pallas kernel, and the step-loop learner differentiates it.
"""

from __future__ import annotations

import torch

from merging_gym_tpu_torch.nn.init import linear_params
from merging_gym_tpu_torch.nn.mlp import qnet_params_from_numpy
from merging_gym_tpu_torch.nn.noisy import (noisy_apply, noisy_init,
                                            noisy_sample_noise)

NUM_ATOMS = 51              # ranbowdqn.py:32
V_MIN, V_MAX = -10.0, 10.0  # ranbowdqn.py:33-34
TRUNK = (32, 64)            # ranbowdqn.py:508-509
NOISY_LAYERS = ("noisy_value1", "noisy_value2", "noisy_advantage1",
                "noisy_advantage2")


def support(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.linspace(V_MIN, V_MAX, NUM_ATOMS, dtype=dtype, device=device)


def noisy_shapes(num_actions: int = 5, num_atoms: int = NUM_ATOMS) -> tuple:
    """``(name, in, out)`` of the four noisy layers."""
    h = TRUNK[1]
    return (("noisy_value1", h, h), ("noisy_value2", h, num_atoms),
            ("noisy_advantage1", h, h),
            ("noisy_advantage2", h, num_atoms * num_actions))


def rainbow_init(generator: torch.Generator, num_inputs: int,
                 num_actions: int, num_atoms: int = NUM_ATOMS,
                 std_init: float = 0.4, dtype=torch.float32,
                 device=None) -> dict:
    """Params drawn from ``generator`` (trunk first, then the four noisy
    layers in the order of :func:`noisy_shapes`)."""
    params = {
        "linear1": linear_params(generator, num_inputs, TRUNK[0], dtype,
                                 device, weight_init="torch"),
        "linear2": linear_params(generator, TRUNK[0], TRUNK[1], dtype,
                                 device, weight_init="torch"),
    }
    for name, d_in, d_out in noisy_shapes(num_actions, num_atoms):
        params[name] = noisy_init(generator, d_in, d_out, std_init, dtype,
                                  device)
    return params


def rainbow_sample_noise(generator: torch.Generator, num_actions: int,
                         num_atoms: int = NUM_ATOMS,
                         dtype=torch.float32) -> dict:
    """One noise dict for all four noisy layers (``reset_noise``,
    ranbowdqn.py:537-541)."""
    return {name: noisy_sample_noise(generator, d_in, d_out, dtype)
            for name, d_in, d_out in noisy_shapes(num_actions, num_atoms)}


def rainbow_apply(params: dict, x: torch.Tensor, noise: dict | None = None,
                  num_actions: int = 5, num_atoms: int = NUM_ATOMS):
    """Forward pass -> ``f[..., actions, atoms]`` softmax distributions
    (ranbowdqn.py:517-535)."""
    def dense(p, h):
        return torch.matmul(h.float(), p["w"].float()).to(h.dtype) + p["b"]

    h = torch.relu(dense(params["linear1"], x))
    h = torch.relu(dense(params["linear2"], h))

    def noisy(name, h):
        return noisy_apply(params[name], h,
                           None if noise is None else noise[name])

    value = noisy("noisy_value2", torch.relu(noisy("noisy_value1", h)))
    adv = noisy("noisy_advantage2", torch.relu(noisy("noisy_advantage1", h)))
    value = value[..., None, :]
    adv = adv.reshape(adv.shape[:-1] + (num_actions, num_atoms))
    logits = value + adv - torch.mean(adv, dim=-2, keepdim=True)
    return torch.softmax(logits, dim=-1)


def rainbow_q_values(dist: torch.Tensor, sup: torch.Tensor | None = None):
    """E[Z] per action: the greedy-action scores (ranbowdqn.py:543-548)."""
    if sup is None:
        sup = support(dist.dtype, dist.device)
    return torch.sum(dist * sup, dim=-1)


def rainbow_params_from_numpy(params: dict, device=None) -> dict:
    """JAX/numpy nested Rainbow params (the layout of
    ``model_zoo/RB_*/params.npz``, e.g. ``['noisy_advantage2']['w_mu']``
    of shape ``(64, 255)``) -> the port's params on ``device``."""
    return qnet_params_from_numpy(params, device)


def rainbow_noise_from_numpy(noise: dict, device=None) -> dict:
    """JAX/numpy nested noise (``{layer: {w_eps, b_eps}}``) -> tensors."""
    return qnet_params_from_numpy(noise, device)
