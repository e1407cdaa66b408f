"""Parameter initialisers reproducing the reference's torch init schemes.

Counterpart of ``merging_gym_tpu/nn/init.py``.  The reference Q-nets
override only the weight init to U(0, 1) (scripts/main.py:34-39) while
biases keep torch's ``nn.Linear`` default U(-1/sqrt(fan_in), 1/sqrt(fan_in));
the Rainbow trunk keeps the default for both (ranbowdqn.py:508-509).
"""

from __future__ import annotations

import math

import torch

from merging_gym_tpu_torch.device import resolve_device


def linear_params(generator: torch.Generator, fan_in: int, fan_out: int,
                  dtype=torch.float32, device=None, *,
                  weight_init: str = "uniform01") -> dict:
    """One dense layer ``{w: [fan_in, fan_out], b: [fan_out]}``: biases
    U(-k, k) with k = 1/sqrt(fan_in); weights U(0, 1) (``"uniform01"``, the
    reference Q-net scheme) or U(-k, k) (``"torch"``, nn.Linear's default).

    Draws come from ``generator``, on its device unless ``device`` says
    otherwise.
    """
    if device is None:
        device = generator.device
    device = resolve_device(device)
    k = 1.0 / math.sqrt(fan_in)
    lo, hi = {"uniform01": (0.0, 1.0), "torch": (-k, k)}[weight_init]
    w = torch.empty(fan_in, fan_out, dtype=dtype, device=device).uniform_(
        lo, hi, generator=generator)
    b = torch.empty(fan_out, dtype=dtype, device=device).uniform_(
        -k, k, generator=generator)
    return {"w": w, "b": b}
