"""Device selection for the port's entry points.

Every entry point runs on ``cuda`` unless the caller asks for the CPU.
Without a card and without that request it raises: nothing carries on
silently on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; raise if CUDA was asked for and is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --cpu) to run "
            "the plain PyTorch versions on the CPU")
    return dev


def tensor_device(obj, device=None) -> torch.device:
    """Device of ``obj`` if it is a tensor (or a dict holding tensors),
    else :func:`resolve_device` of ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.device
    if isinstance(obj, dict):
        for v in obj.values():
            if isinstance(v, (torch.Tensor, dict)):
                return tensor_device(v, device)
    return resolve_device(device)
