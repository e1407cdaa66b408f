"""Philox4x32-10 counter-based random bits, in plain PyTorch.

The same generator as ``kernels/csrc/philox.cuh``: the plain versions of
the kernels draw from this one, so a kernel and its plain version see the
same bits in every random mode.  It replaces the TPU's ``pltpu.prng_*``
streams, which no other device reproduces.

Values are uint32 held in int64 tensors.  The product of two uint32 can
pass 2**63 and wrap, but its low 64 bits stay exact, which is all that
``mulhilo`` needs.

Counter layout used by every kernel: ``(step, env, stream, 0)`` under the
key ``(seed mod 2**32, seed >> 32)``.  Streams: 0 = actions / Phi(eps)
selection bits, 1 = random-start reset values.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85

STREAM_ACTIONS = 0
STREAM_RESET = 1


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
