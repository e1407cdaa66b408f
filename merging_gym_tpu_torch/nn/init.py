"""Parameter initialiser reproducing the reference Q-net's torch init.

Counterpart of ``merging_gym_tpu/nn/init.py``.  The reference Q-nets
override only the weight init to U(0, 1) (scripts/main.py:34-39) while
biases keep torch's ``nn.Linear`` default U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
"""

from __future__ import annotations

import math

import torch

from merging_gym_tpu_torch.device import resolve_device


def linear_params(generator: torch.Generator, fan_in: int, fan_out: int,
                  dtype=torch.float32, device=None) -> dict:
    """One dense layer ``{w: [fan_in, fan_out], b: [fan_out]}``: weights
    U(0, 1), biases U(-k, k) with k = 1/sqrt(fan_in).

    Draws come from ``generator``, on its device unless ``device`` says
    otherwise.
    """
    if device is None:
        device = generator.device
    device = resolve_device(device)
    k = 1.0 / math.sqrt(fan_in)
    w = torch.empty(fan_in, fan_out, dtype=dtype, device=device).uniform_(
        0.0, 1.0, generator=generator)
    b = torch.empty(fan_out, dtype=dtype, device=device).uniform_(
        -k, k, generator=generator)
    return {"w": w, "b": b}
