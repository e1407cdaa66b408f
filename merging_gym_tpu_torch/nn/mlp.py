"""The reference Q-net: input -> 200 -> 100 -> outputs with ReLU.

Counterpart of ``merging_gym_tpu/nn/mlp.py``.  Params keep the JAX
package's nested-dict layout ``{fc0, fc1, fc2: {w: [in, out], b: [out]}}``
so that ``model_zoo/*/params.npz`` and JAX params carry across unchanged.
``qnet_apply`` is the hand-written fused kernel K3 on the card
(``ops.fused_mlp``) and its plain version on the CPU; it has no gradient.
The learner of ``agents.dqn`` differentiates :func:`qnet_apply_autograd`
instead, as the JAX learner differentiates its plain ``qnet_apply``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from merging_gym_tpu_torch.device import resolve_device
from merging_gym_tpu_torch.nn.init import linear_params
from merging_gym_tpu_torch.ops.fused_mlp import (compute_dtype_of,
                                                 qnet_apply_fused)

HIDDEN = (200, 100)  # main.py:34-38


def qnet_init(generator: torch.Generator, num_inputs: int, num_outputs: int,
              hidden=HIDDEN, dtype=torch.float32, device=None) -> dict:
    """Init the reference MLP Q-net (main.py:30-47) from ``generator``."""
    dims = (num_inputs,) + tuple(hidden) + (num_outputs,)
    return {f"fc{i}": linear_params(generator, dims[i], dims[i + 1], dtype,
                                    device)
            for i in range(len(dims) - 1)}


def qnet_apply(params: dict, x: torch.Tensor,
               compute_dtype: str = "float32") -> torch.Tensor:
    """Forward ``x: f[..., in] -> f32[..., out]``.

    ``compute_dtype="bfloat16"`` runs with bf16 weights and activations,
    f32 accumulation and a cast back to bf16 after each layer's product
    (``merging_gym_tpu/nn/mlp.py:38`` under ``agents/dqn.py``'s
    ``_compute_cast``); the Q-values return as f32.
    """
    return qnet_apply_fused(params, x, compute_dtype)


def qnet_apply_autograd(params: dict, x: torch.Tensor,
                        compute_dtype: str = "float32") -> torch.Tensor:
    """Differentiable forward ``x: f[..., in] -> f32[..., out]`` with
    ``torch.matmul``, for the learner of ``agents.dqn``.

    The JAX learner differentiates ``merging_gym_tpu/nn/mlp.py:qnet_apply``
    (an XLA computation, no Pallas kernel); this is its counterpart, with
    the same compute-dtype contract: params and activations cast to
    ``compute_dtype``, products accumulated in f32 and cast back to
    ``compute_dtype`` before each bias add, Q-values returned as f32.
    The matmuls run in full f32 (TF32 stays off).
    """
    dtype = compute_dtype_of(compute_dtype)
    h = x.to(dtype)
    n = len(params)
    for i in range(n):
        w = params[f"fc{i}"]["w"].to(dtype)
        b = params[f"fc{i}"]["b"].to(dtype)
        h = torch.matmul(h.float(), w.float()).to(dtype) + b
        if i < n - 1:
            h = torch.relu(h)
    return h.float()


def qnet_params_from_numpy(params: dict, device=None,
                           dtype=torch.float32) -> dict:
    """JAX/numpy nested param dict -> the port's params on ``device``."""
    device = resolve_device(device)
    return {layer: {k: torch.tensor(np.asarray(v), dtype=dtype,
                                    device=device)
                    for k, v in p.items()}
            for layer, p in params.items()}


class QNet(nn.Module):
    """``nn.Module`` holding one Q-net's params; ``forward`` is
    :func:`qnet_apply`.  On the card the forward is the K3 kernel, which
    has no backward, as the JAX K3 has none: call it under
    ``torch.no_grad()``.  The learner differentiates
    :func:`qnet_apply_autograd`."""

    def __init__(self, params: dict):
        super().__init__()
        self.layers = nn.ModuleDict({
            name: nn.ParameterDict({k: nn.Parameter(v) for k, v in p.items()})
            for name, p in params.items()})

    def params(self) -> dict:
        return {name: {"w": layer["w"], "b": layer["b"]}
                for name, layer in self.layers.items()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qnet_apply(self.params(), x)
