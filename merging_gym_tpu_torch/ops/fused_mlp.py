"""The whole Q-net forward as one kernel launch (K3).

Replaces ``merging_gym_tpu/ops/fused_mlp.py:_mlp_kernel`` (``pallas_call``
at :60, entry ``qnet_apply_fused``).  On the card it is
``kernels/csrc/qnet_mlp.cu``: a block owns a tile of rows, keeps the tile's
activations in shared memory and reads the weights through L1/L2, so x is
read once and q written once.  Products accumulate in f32 on the CUDA
cores, in input order, one rounding per multiply and per add (no TF32, no
FMA): the plain version below does the same arithmetic, so the two agree
bit for bit on the card, and the policy-rollout kernel (K6) shares the
same device code (``kernels/csrc/mlp.cuh``), so ``evaluate`` and
``evaluate_fused`` pick the same greedy actions.

``compute_dtype="bfloat16"``: weights and activations in bf16, f32
accumulation, each layer's sum rounded to bf16 before its bf16 bias add,
Q-values returned as f32 (the JAX package's ``compute_dtype`` contract).
"""

from __future__ import annotations

import ctypes

import torch

from merging_gym_tpu_torch import kernels

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_MLP_ARGS = ([ctypes.c_void_p] * 8
             + [ctypes.c_int] * 7 + [ctypes.c_void_p])
# Rows per block; fewer where a wide net's tile would not fit.
K3_TILE_ROWS = 32


def compute_dtype_of(name) -> torch.dtype:
    key = str(name).replace("torch.", "")
    if key not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")
    return _DTYPES[key]


def cast_weights(params: dict, dtype: torch.dtype, device=None) -> list:
    """``[w0, b0, w1, b1, w2, b2]`` contiguous in ``dtype``."""
    out = []
    for i in range(3):
        p = params[f"fc{i}"]
        for k in ("w", "b"):
            out.append(torch.as_tensor(p[k], device=device).to(
                torch.float32).to(dtype).contiguous())
    return out


def mlp_plain_layers(weights: list, x: torch.Tensor,
                     dtype: torch.dtype) -> list:
    """The kernels' MLP, keeping every layer: ``[x, h1, h2]`` in ``dtype``
    (the input cast and the two ReLU outputs), then q f32[B, A]."""
    h = x.to(torch.float32).to(dtype)
    layers = [h]
    for i in range(3):
        w, b = weights[2 * i], weights[2 * i + 1]
        wf = w.to(torch.float32)
        acc = h[:, 0:1].to(torch.float32) * wf[0]
        for k in range(1, w.shape[0]):
            acc = acc + h[:, k:k + 1].to(torch.float32) * wf[k]
        h = acc.to(dtype) + b
        if i < 2:
            h = torch.clamp_min(h, 0.0)
        layers.append(h)
    layers[-1] = h.to(torch.float32)
    return layers


def mlp_plain(weights: list, x: torch.Tensor, dtype: torch.dtype):
    """Plain version of the kernels' MLP: ``x`` f[B, in] -> f32[B, A]."""
    return mlp_plain_layers(weights, x, dtype)[-1]


def qnet_apply_plain(params: dict, x: torch.Tensor,
                     compute_dtype: str = "float32") -> torch.Tensor:
    """Plain PyTorch version of K3: f[..., in] -> f32[..., A]."""
    dtype = compute_dtype_of(compute_dtype)
    lead = x.shape[:-1]
    q = mlp_plain(cast_weights(params, dtype, x.device),
                  x.reshape(-1, x.shape[-1]), dtype)
    return q.reshape(*lead, q.shape[-1])


def qnet_apply_fused(params: dict, x: torch.Tensor,
                     compute_dtype: str = "float32") -> torch.Tensor:
    """Fused forward of the 3-layer ReLU Q-net, f[..., in] -> f32[..., A].

    CPU tensors run the plain version; CUDA tensors launch K3.  K3 has no
    backward: on the card, call it with gradients off.
    """
    if x.device.type == "cpu":
        return qnet_apply_plain(params, x, compute_dtype)
    dtype = compute_dtype_of(compute_dtype)
    weights = cast_weights(params, dtype, x.device)
    if torch.is_grad_enabled() and (x.requires_grad or any(
            w.requires_grad for w in weights)):
        raise NotImplementedError(
            "the K3 kernel has no backward; call it under torch.no_grad()")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32).contiguous()
    out = torch.empty(x2.shape[0], weights[4].shape[1], dtype=torch.float32,
                      device=x.device)
    launch_mlp(weights, x2, out)
    return out.reshape(*lead, out.shape[-1])


def launch_mlp(weights: list, x: torch.Tensor, out: torch.Tensor) -> None:
    """Launch K3: ``x`` f32[B, in] -> ``out`` f32[B, A] (preallocated)."""
    dev = kernels.require_cuda(x, out, *weights)
    w0, w1, w2 = weights[0], weights[2], weights[4]
    d_in, h1, h2, a = w0.shape[0], w0.shape[1], w1.shape[1], w2.shape[1]
    if x.shape[1] != d_in or w1.shape[0] != h1 or w2.shape[0] != h2:
        raise ValueError("Q-net shapes do not chain")
    tile = kernels.tile_size(K3_TILE_ROWS, 0,
                             (d_in + h1 + h2) * weights[0].element_size())
    fn = kernels.function("qnet_mlp", "mgt_qnet_mlp", _MLP_ARGS)
    rc = fn(kernels.ptr(x), *map(kernels.ptr, weights), kernels.ptr(out),
            x.shape[0], d_in, h1, h2, a,
            int(weights[0].dtype == torch.bfloat16), tile,
            kernels.stream_ptr(dev))
    kernels.check("qnet_mlp", rc, "qnet_mlp launch")
    kernels.launch_counts["qnet_mlp"] += 1
