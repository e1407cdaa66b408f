"""LSTM recurrent Q-network: the reference's DRQN, made to run.

Counterpart of ``merging_gym_tpu/nn/lstm.py``.  The reference defines a
``DRQN`` (scripts/main.py:49-74) that can never run (an undefined
``Flatten``, an unused Conv2d, never instantiated); its intended
architecture, minus the dead conv path, is kept:

    fc1: obs -> 200 (ReLU, U(0,1) weights)   # main.py:60-61
    fc2: 200 -> 16                            # main.py:62-63
    lstm: 16 -> 16 (single layer)             # main.py:52-54,58
    fc3: 16 -> 16 (ReLU)                      # main.py:65
    fc4: 16 -> num_actions                    # main.py:66

7,949 parameters at 10 inputs and 5 actions (fc1 2,200, fc2 3,216, LSTM
2,176, fc3 272, fc4 85).  Params are nested dicts of tensors with the JAX
package's keys and ``[in, out]`` layout; the cell is a function and a
sequence is a Python loop (the JAX ``lax.scan``).  torch's LSTM init
(U(-1/sqrt(h), 1/sqrt(h)) for both weights and both biases) and gate order
i, f, g, o are kept.  The products are ``torch.matmul``, so autograd
differentiates them (the step-loop learner, ``agents.drqn``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from merging_gym_tpu_torch.device import resolve_device
from merging_gym_tpu_torch.nn.init import linear_params

LSTM_HIDDEN = 16  # main.py:52-53


def lstm_cell_init(generator: torch.Generator, input_size: int,
                   hidden_size: int, dtype=torch.float32,
                   device=None) -> dict:
    """torch ``nn.LSTM`` single-layer init: U(-k, k), k = 1/sqrt(hidden),
    drawn from ``generator`` in the order w_ih, w_hh, b_ih, b_hh."""
    device = resolve_device(generator.device if device is None else device)
    k = 1.0 / math.sqrt(hidden_size)

    def u(*shape):
        return torch.empty(*shape, dtype=dtype, device=device).uniform_(
            -k, k, generator=generator)

    w_ih = u(input_size, 4 * hidden_size)
    w_hh = u(hidden_size, 4 * hidden_size)
    return {"w_ih": w_ih, "w_hh": w_hh, "b_ih": u(4 * hidden_size),
            "b_hh": u(4 * hidden_size)}


def lstm_cell_apply(params: dict, x: torch.Tensor, carry):
    """One LSTM step, torch gate order i, f, g, o: ``(h, (h, c))``."""
    h, c = carry
    gates = (torch.matmul(x, params["w_ih"]) + params["b_ih"]
             + torch.matmul(h, params["w_hh"]) + params["b_hh"])
    i, f, g, o = torch.split(gates, gates.shape[-1] // 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, (h, c)


def lstm_zero_carry(batch_shape, hidden_size: int = LSTM_HIDDEN,
                    dtype=torch.float32, device=None):
    z = torch.zeros(*batch_shape, hidden_size, dtype=dtype,
                    device=resolve_device(device))
    return (z, z)


def drqn_init(generator: torch.Generator, num_inputs: int, num_actions: int,
              dtype=torch.float32, hidden: int = LSTM_HIDDEN,
              device=None) -> dict:
    """fc1 and fc2 with U(0, 1) weights (the reference Q-net scheme), the
    LSTM and fc3/fc4 with torch's defaults.  ``hidden`` widens the LSTM/fc3
    trunk past the reference's 16, as the JAX ``drqn_init`` allows."""
    kw = dict(dtype=dtype, device=device)
    return {
        "fc1": linear_params(generator, num_inputs, 200, **kw,
                             weight_init="uniform01"),
        "fc2": linear_params(generator, 200, hidden, **kw,
                             weight_init="uniform01"),
        "lstm": lstm_cell_init(generator, hidden, hidden, **kw),
        "fc3": linear_params(generator, hidden, hidden, **kw,
                             weight_init="torch"),
        "fc4": linear_params(generator, hidden, num_actions, **kw,
                             weight_init="torch"),
    }


def _dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p["w"]) + p["b"]


def drqn_step(params: dict, obs: torch.Tensor, carry):
    """One timestep: obs [..., num_inputs] -> (q [..., A], new carry)."""
    h = torch.relu(_dense(params["fc1"], obs))
    h = _dense(params["fc2"], h)
    h, carry = lstm_cell_apply(params["lstm"], h, carry)
    h = torch.relu(_dense(params["fc3"], h))
    return _dense(params["fc4"], h), carry


def drqn_unroll(params: dict, obs_seq: torch.Tensor, carry):
    """obs_seq [T, ..., num_inputs] -> (q [T, ..., A], final carry)."""
    qs = []
    for t in range(obs_seq.shape[0]):
        q, carry = drqn_step(params, obs_seq[t], carry)
        qs.append(q)
    return torch.stack(qs), carry


def drqn_params_from_numpy(params: dict, device=None,
                           dtype=torch.float32) -> dict:
    """A JAX ``drqn_init`` dict as numpy arrays (the layout of a JAX
    ``--algo drqn`` ``params.npz``) -> the port's params on ``device``."""
    device = resolve_device(device)
    return {layer: {k: torch.tensor(np.asarray(v), dtype=dtype,
                                    device=device)
                    for k, v in p.items()}
            for layer, p in params.items()}
