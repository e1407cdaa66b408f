"""Philox4x32-10 counter-based random bits, in plain PyTorch.

Frozen copy of ``ops/philox.py`` of ``merging_gym_tpu_torch`` at commit
79f5ae92604b, with its imports of the port replaced by the copies in this
folder. Nothing here imports the port or JAX.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85

STREAM_ACTIONS = 0
STREAM_RESET = 1
STREAM_OPPONENT = 2
STREAM_GOAL = 3


def seed_key(seed: int) -> tuple[int, int]:
    seed &= (1 << 64) - 1
    return seed & MASK32, seed >> 32


def philox4x32_10(c0, c1, c2, c3, key: tuple[int, int]):
    """Ten Philox rounds on int64 tensors holding uint32 counters."""
    k0, k1 = key
    for _ in range(10):
        p0 = c0 * _M0
        p1 = c2 * _M1
        hi0, lo0 = (p0 >> 32) & MASK32, p0 & MASK32
        hi1, lo1 = (p1 >> 32) & MASK32, p1 & MASK32
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & MASK32, (k1 + _W1) & MASK32
    return c0, c1, c2, c3


def draw(step: int, num_envs: int, stream: int, key: tuple[int, int],
         device) -> tuple:
    """The four uint32 words for counter ``(step, env, stream, 0)`` of
    every env ``0 <= env < num_envs``."""
    env = torch.arange(num_envs, dtype=torch.int64, device=device)
    return philox4x32_10(torch.full_like(env, step & MASK32), env,
                         torch.full_like(env, stream), torch.zeros_like(env),
                         key)
