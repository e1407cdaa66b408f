"""Reference ``.pth`` run directories of the zoo's nets, for the ``play``
tests: ``model_zoo/L2`` as a DQN run (``eval.pth``, ``target.pth``),
``model_zoo/HD_L1`` as an h-DQN run (the lower net as ``eval.pth`` /
``target.pth``, the meta net as ``meta_eval.pth`` / ``meta_target.pth``)
and ``model_zoo/RB_L0`` as a Rainbow run (``eval.pth``, a ``RainbowDQN``
state dict: the inverse of ``io.torch_import.rainbow_from_state_dict``,
which the package does not need).  Imports no JAX."""

import os

import numpy as np
import torch

from merging_gym_tpu_torch.io.checkpoint import load_params_npz
from merging_gym_tpu_torch.io.torch_import import qnet_to_state_dict

ZOO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "model_zoo")


def zoo(name: str) -> dict:
    return load_params_npz(os.path.join(ZOO, name, "params.npz"))


def rainbow_state_dict(params: dict) -> dict:
    """Rainbow params (``[in, out]`` weights) -> a ``RainbowDQN`` state
    dict (``nn.Linear`` weights ``[out, in]``, the noisy layers' mu and
    sigma)."""
    sd = {}
    for name, p in params.items():
        p = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
        if "w" in p:
            sd[f"{name}.weight"] = p["w"].T.contiguous()
            sd[f"{name}.bias"] = p["b"]
            continue
        sd[f"{name}.weight_mu"] = p["w_mu"].T.contiguous()
        sd[f"{name}.weight_sigma"] = p["w_sigma"].T.contiguous()
        sd[f"{name}.bias_mu"] = p["b_mu"]
        sd[f"{name}.bias_sigma"] = p["b_sigma"]
    return sd


def write_run_dirs(root: str) -> dict:
    """``{"dqn": dir, "hdqn": dir, "rainbow": dir}`` under ``root``."""
    dirs = {m: os.path.join(root, m) for m in ("dqn", "hdqn", "rainbow")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    l2 = qnet_to_state_dict(zoo("L2"))
    for f in ("eval.pth", "target.pth"):
        torch.save(l2, os.path.join(dirs["dqn"], f))
    hd = zoo("HD_L1")
    for f, net in (("eval.pth", "lower"), ("target.pth", "lower"),
                   ("meta_eval.pth", "upper"), ("meta_target.pth", "upper")):
        torch.save(qnet_to_state_dict(hd[net]), os.path.join(dirs["hdqn"], f))
    torch.save(rainbow_state_dict(zoo("RB_L0")),
               os.path.join(dirs["rainbow"], "eval.pth"))
    return dirs
