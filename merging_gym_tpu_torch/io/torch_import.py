"""Reference ``.pth`` state dicts <-> the port's param dicts.

Counterpart of ``merging_gym_tpu/io/torch_import.py``: loads the
reference's saved nets (``eval.pth`` / ``target.pth`` of a DQN run,
scripts/main.py:244-245; also ``meta_eval.pth`` / ``meta_target.pth`` of
an h-DQN run, hdqn.py:362-366; a ``RainbowDQN`` state dict,
ranbowdqn.py:699-700) as the param dicts the port's nets take
(``nn.mlp.qnet_params_from_numpy``'s and the Rainbow net's layout) on an
explicit device, and exports a Q-net back to a state dict.  A torch
``nn.Linear`` stores ``weight`` as ``[out, in]``, the port's dense layers
``w`` as ``[in, out]``, so weights transpose on the way through.  Files
load with ``weights_only=True``: no pickled code runs.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from merging_gym_tpu_torch.device import resolve_device

# Reference Q-net layer names (main.py:34-38) -> the port's fc0..fc2.
_QNET_LAYERS = ("fc1", "fc2", "out")
# Reference Rainbow module names (ranbowdqn.py:508-515) map 1:1 to ours.
_RAINBOW_DENSE = ("linear1", "linear2")
_RAINBOW_NOISY = ("noisy_value1", "noisy_value2", "noisy_advantage1",
                  "noisy_advantage2")


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _tensor(t, device, dtype, transpose=False):
    t = torch.as_tensor(t).detach()
    return (t.T if transpose else t).to(device=device,
                                        dtype=dtype).contiguous()


def qnet_from_state_dict(state_dict, device=None,
                         dtype=torch.float32) -> dict:
    """Torch ``Net`` state dict -> the port's Q-net params on ``device``."""
    dev = resolve_device(device)
    return {f"fc{i}": {
        "w": _tensor(state_dict[f"{name}.weight"], dev, dtype, True),
        "b": _tensor(state_dict[f"{name}.bias"], dev, dtype)}
        for i, name in enumerate(_QNET_LAYERS)}


def _cpu_copy(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    return torch.tensor(np.asarray(x))


def qnet_to_state_dict(params) -> dict:
    """The port's (or numpy) Q-net params -> torch ``Net`` state dict on
    the CPU (for ``.pth`` export)."""
    sd = {}
    for i, name in enumerate(_QNET_LAYERS):
        p = params[f"fc{i}"]
        sd[f"{name}.weight"] = _cpu_copy(p["w"]).T.contiguous()
        sd[f"{name}.bias"] = _cpu_copy(p["b"])
    return sd


def load_qnet_pth(path, device=None, dtype=torch.float32) -> dict:
    """One ``.pth`` file (e.g. ``.../eval.pth``) -> Q-net params."""
    return qnet_from_state_dict(_load(path), device, dtype)


def load_reference_dqn(run_dir, device=None, dtype=torch.float32):
    """A reference DQN run directory (eval.pth + target.pth, main.py:85-87)
    -> ``(eval_params, target_params)``."""
    return tuple(load_qnet_pth(os.path.join(run_dir, f), device, dtype)
                 for f in ("eval.pth", "target.pth"))


def load_reference_hdqn(run_dir, device=None, dtype=torch.float32) -> dict:
    """A reference h-DQN run directory (hdqn.py:69-71, 152-154, 362-366) ->
    the lower eval/target nets (11 inputs) and the meta eval/target nets
    (3 outputs)."""
    files = {"lower_eval": "eval.pth", "lower_target": "target.pth",
             "meta_eval": "meta_eval.pth", "meta_target": "meta_target.pth"}
    return {k: load_qnet_pth(os.path.join(run_dir, f), device, dtype)
            for k, f in files.items()}


def rainbow_from_state_dict(state_dict, device=None,
                            dtype=torch.float32) -> dict:
    """Torch ``RainbowDQN`` state dict -> the port's Rainbow params."""
    dev = resolve_device(device)
    params = {name: {
        "w": _tensor(state_dict[f"{name}.weight"], dev, dtype, True),
        "b": _tensor(state_dict[f"{name}.bias"], dev, dtype)}
        for name in _RAINBOW_DENSE}
    for name in _RAINBOW_NOISY:
        params[name] = {
            "w_mu": _tensor(state_dict[f"{name}.weight_mu"], dev, dtype, True),
            "w_sigma": _tensor(state_dict[f"{name}.weight_sigma"], dev, dtype,
                               True),
            "b_mu": _tensor(state_dict[f"{name}.bias_mu"], dev, dtype),
            "b_sigma": _tensor(state_dict[f"{name}.bias_sigma"], dev, dtype)}
    return params


def load_rainbow_pth(path, device=None, dtype=torch.float32) -> dict:
    """One ``RainbowDQN`` ``.pth`` file -> the port's Rainbow params."""
    return rainbow_from_state_dict(_load(path), device, dtype)
