"""NoisyNet linear layer (functional, explicit noise).

Counterpart of ``merging_gym_tpu/nn/noisy.py`` and of the reference
``NoisyLinear`` (scripts/ranbowdqn.py:440-496): mu/sigma parameters and
Gaussian noise with the ``sign(x)*sqrt(|x|)`` scaling.  Noise is explicit
data, sampled by :func:`noisy_sample_noise` from a ``torch.Generator`` and
passed to :func:`noisy_apply`; ``noise=None`` is the eval-mode (mu-only)
path (ranbowdqn.py:468-473).  Weights are ``[in, out]``, as in JAX.
"""

from __future__ import annotations

import math

import torch

from merging_gym_tpu_torch.device import resolve_device


def noisy_init(generator: torch.Generator, in_features: int,
               out_features: int, std_init: float = 0.4,
               dtype=torch.float32, device=None) -> dict:
    """Parameter init per ranbowdqn.py:477-484: mu U(-r, r) with
    r = 1/sqrt(in), sigma filled with std_init/sqrt(fan)."""
    device = resolve_device(generator.device if device is None else device)
    r = 1.0 / math.sqrt(in_features)

    def uniform(*shape):
        return torch.empty(*shape, dtype=dtype, device=device).uniform_(
            -r, r, generator=generator)

    return {
        "w_mu": uniform(in_features, out_features),
        "w_sigma": torch.full((in_features, out_features),
                              std_init / math.sqrt(in_features), dtype=dtype,
                              device=device),
        "b_mu": uniform(out_features),
        "b_sigma": torch.full((out_features,),
                              std_init / math.sqrt(out_features), dtype=dtype,
                              device=device),
    }


def scale_noise(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * sqrt(|x|) (ranbowdqn.py:493-496)."""
    return torch.sign(x) * torch.sqrt(torch.abs(x))


def noisy_sample_noise(generator: torch.Generator, in_features: int,
                       out_features: int, dtype=torch.float32) -> dict:
    """Factorised noise: ``w_eps = outer(f(eps_in), f(eps_out))`` and an
    independent bias vector (ranbowdqn.py:486-491)."""
    dev = generator.device

    def draw(size):
        return scale_noise(torch.randn(size, generator=generator,
                                       dtype=dtype, device=dev))

    eps_in, eps_out = draw(in_features), draw(out_features)
    return {"w_eps": torch.outer(eps_in, eps_out), "b_eps": draw(out_features)}


def noisy_apply(params: dict, x: torch.Tensor, noise: dict | None = None):
    """Linear layer with (optionally) noisy weights (ranbowdqn.py:460-475)."""
    if noise is None:
        w, b = params["w_mu"], params["b_mu"]
    else:
        w = params["w_mu"] + params["w_sigma"] * noise["w_eps"]
        b = params["b_mu"] + params["b_sigma"] * noise["b_eps"]
    return torch.matmul(x.float(), w.float()).to(x.dtype) + b
