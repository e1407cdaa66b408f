"""The whole Q-net forward as one kernel launch (K3).

Replaces ``merging_gym_tpu/ops/fused_mlp.py:_mlp_kernel`` (``pallas_call``
at :60, entry ``qnet_apply_fused``).  On the card it is
``kernels/csrc/qnet_mlp.cu`` around the register-tiled forward of
``kernels/csrc/qnet_tiled.cuh``: a block owns ``rows`` rows and keeps their
activations in shared memory, each thread sums a micro-tile of outputs,
and the weights stream through shared memory in chunks; x is read once and
q written once.  :func:`qnet_geometry` sizes the blocks from the batch and
the card's SM count.  Products accumulate in f32 on the CUDA cores, in
input order, one rounding per multiply and per add (no TF32, no FMA): the
plain version below does the same arithmetic, so the two agree bit for
bit on the card, and so does the policy-rollout kernel (K6, which runs
the same micro-tiles), so ``evaluate`` and ``evaluate_fused`` pick the same
greedy actions.

``compute_dtype="bfloat16"``: weights and activations in bf16, f32
accumulation, each layer's sum rounded to bf16 before its bf16 bias add,
Q-values returned as f32 (the JAX package's ``compute_dtype`` contract).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from merging_gym_tpu_torch import kernels

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_MLP_ARGS = ([ctypes.c_void_p] * 8
             + [ctypes.c_int] * 11 + [ctypes.c_void_p])

QNET_ROWS_MAX = 32
# (rows, columns) of a thread's micro-tile, in order of preference (most
# reuse first); kernels/csrc/qnet_tiled.cuh:MGT_QNET_TILES instantiates them.
QNET_TILES = ((8, 4), (8, 2), (4, 2), (4, 1), (2, 1), (1, 4), (1, 1))
QNET_MIN_TILES = 96  # micro-tiles of the largest layer per block: 3 warps


class QnetGeometry(NamedTuple):
    """Launch geometry of K3 and K4: ``rows`` of x per block, ``rm`` x
    ``rn`` micro-tiles, ``chunk`` elements per weight buffer and ``smem``
    bytes of shared memory per block."""
    rows: int
    rm: int
    rn: int
    chunk: int
    smem: int


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def qnet_smem(widths, rows: int, chunk: int, elem: int,
              q_per_row: int = 0) -> int:
    """Shared-memory bytes of one block (qnet_tiled.cuh:QnetSmem): two
    weight buffers, the x, h1 and h2 tiles with rows padded to
    ``act_stride``, and ``q_per_row`` f32 per row."""
    n = _align16(2 * chunk * elem)
    for k in widths[:3]:
        n += _align16(rows * ((k + 3) // 4 * 4 + 4) * elem)
    return n + rows * q_per_row * 4


def qnet_tiling(widths: tuple, rows: int, elem: int, q_per_row: int = 0,
                extra: int = 0,
                min_tiles: int = QNET_MIN_TILES) -> QnetGeometry | None:
    """The geometry of blocks of ``rows`` rows of a Q-net of ``widths``
    (in, h1, h2, a) in ``elem``-byte weights, or None where the tiles leave
    no room for two weight buffers of one k-row of the widest layer.
    ``extra`` bytes follow the layout, and ``min_tiles`` replaces
    ``QNET_MIN_TILES`` (the learner's, which runs this forward,
    ``ops/fused_trainer.py:learn_tiling``).

    The buffers take the rest of the block's shared memory
    (:func:`weight_chunk`).  The micro-tile is :func:`micro_tile`'s.
    """
    chunk = weight_chunk(widths, kernels.SMEM_LIMIT - extra - qnet_smem(
        widths, rows, 0, elem, q_per_row), elem)
    if chunk is None:
        return None
    rm, rn = micro_tile(widths, rows, min_tiles)
    return QnetGeometry(rows, rm, rn, chunk,
                        qnet_smem(widths, rows, chunk, elem, q_per_row)
                        + extra)


def weight_chunk(widths: tuple, room: int, elem: int) -> int | None:
    """Elements of each of two weight buffers in ``room`` bytes: up to the
    largest layer, in multiples of 8 elements (the second buffer then
    starts 16-byte aligned, as its ``cp.async`` copies need), or None
    where they cannot hold one k-row of the widest layer."""
    layers = tuple(zip(widths[:3], widths[1:]))
    full = -(-max(k * j for k, j in layers) // 8) * 8
    chunk = min(full, room // (2 * elem) // 8 * 8)
    return chunk if chunk >= max(j for _, j in layers) else None


def micro_tile(widths: tuple, rows: int, min_tiles: int) -> tuple:
    """(RM, RN) for blocks of ``rows`` rows of a Q-net of ``widths``: the
    first of ``QNET_TILES`` with RM <= rows that gives the largest layer at
    least ``min_tiles`` tiles, else the one that gives it the most."""
    layers = tuple(zip(widths[:3], widths[1:]))
    j_main = max(layers, key=lambda kj: kj[0] * kj[1])[1]
    fits = [(rm, rn) for rm, rn in QNET_TILES if rm <= rows]
    tiles = {t: -(-rows // t[0]) * -(-j_main // t[1]) for t in fits}
    return next((t for t in fits if tiles[t] >= min_tiles),
                max(fits, key=tiles.get))


@functools.lru_cache(maxsize=None)
def qnet_geometry(batch: int, widths: tuple, elem: int, sm_count: int,
                  q_per_row: int = 0) -> QnetGeometry:
    """K3's and K4's launch geometry for ``batch`` rows on ``sm_count``
    SMs: :func:`qnet_tiling` of the smallest power of two of rows per block
    (at most ``QNET_ROWS_MAX``) that needs no more blocks than the card has
    SMs -- one full block per SM, each streaming the weights once (the
    rows sweep of chip_smoke.py times the others) -- halved while its tiles
    do not fit shared memory.
    """
    top = 1
    while top < QNET_ROWS_MAX and -(-batch // top) > sm_count:
        top *= 2
    for rows in (top >> i for i in range(top.bit_length())):
        g = qnet_tiling(widths, rows, elem, q_per_row)
        if g is not None:
            return g
    raise ValueError(f"a Q-net of widths {tuple(widths)} does not fit the "
                     f"{kernels.SMEM_LIMIT} B of shared memory of a block")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def qnet_widths(weights: list, x: torch.Tensor) -> tuple:
    """(in, h1, h2, a) of ``weights``; raises if they and x do not chain."""
    w0, w1, w2 = weights[0], weights[2], weights[4]
    d_in, h1, h2, a = w0.shape[0], w0.shape[1], w1.shape[1], w2.shape[1]
    if x.shape[1] != d_in or w1.shape[0] != h1 or w2.shape[0] != h2:
        raise ValueError("Q-net shapes do not chain")
    return d_in, h1, h2, a


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


def launch_mlp(weights: list, x: torch.Tensor, out: torch.Tensor,
               geometry: QnetGeometry | None = None) -> None:
    """Launch K3: ``x`` f32[B, in] -> ``out`` f32[B, A] (preallocated), in
    ``geometry`` (by default :func:`qnet_geometry`'s)."""
    dev = kernels.require_cuda(x, out, *weights)
    widths = qnet_widths(weights, x)
    g = geometry or qnet_geometry(x.shape[0], widths,
                                  weights[0].element_size(), sm_count(dev))
    fn = kernels.function("qnet_mlp", "mgt_qnet_mlp", _MLP_ARGS)
    rc = fn(kernels.ptr(x), *map(kernels.ptr, weights), kernels.ptr(out),
            x.shape[0], *widths, int(weights[0].dtype == torch.bfloat16),
            g.rows, g.rm, g.rn, g.chunk, g.smem, kernels.stream_ptr(dev))
    kernels.check("qnet_mlp", rc, "qnet_mlp launch")
    kernels.launch_counts["qnet_mlp"] += 1
