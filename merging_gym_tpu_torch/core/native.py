"""ctypes bindings for the native (C++) env core.

Counterpart of ``merging_gym_tpu/core/native.py``, over the port's copy of
the C++ core (``merging_gym_tpu_torch/native/merging_core.cpp``): a
compiled batch-stepping env with the exact reference semantics, a KKT QP
solver standing in for quadprog, and a serial rollout loop.  The shared
library is built with ``g++`` at first use into ``kernels/_build/``
(written to a temporary file and renamed, so concurrent first uses do not
race), with ``-ffp-contract=off`` so that no compiler fuses a multiply and
an add and the core stays bit-equal to the float64 oracle.  Without a
compiler every entry point raises.

This is the host-side runtime: human play, single-env evaluation and CPU
trajectory generation skip the device round-trip, and the C core is a
second, independent parity oracle in tests.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

from merging_gym_tpu_torch.kernels import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native", "merging_core.cpp")
_SO_PATH = os.path.join(BUILD_DIR, "libmerging_core.so")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off"]

_STATE_DTYPE = np.dtype([
    ("pos1", np.float64), ("vel1", np.float64), ("acc1", np.float64),
    ("pos2", np.float64), ("vel2", np.float64), ("acc2", np.float64),
    ("r1_acc", np.float64), ("r2_acc", np.float64),
    ("time_stamp", np.float64),
    ("t", np.int32), ("winner", np.int32), ("done", np.int32),
], align=True)

_OUT_DTYPE = np.dtype([
    ("obs", np.float64, (10,)), ("r1", np.float64), ("r2", np.float64),
    ("done", np.int32), ("collision", np.int32), ("winner", np.int32),
], align=True)

_lib = None


def _build():
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, _SRC],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed to build the native core "
                               f"(rc {r.returncode}):\n{r.stderr[-4000:]}")
        os.replace(tmp, _SO_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library():
    """Load (building if needed) the native library; raises on failure."""
    global _lib
    if _lib is not None:
        return _lib
    if (not os.path.exists(_SO_PATH)
            or os.path.getmtime(_SO_PATH) < os.path.getmtime(_SRC)):
        _build()
    lib = ctypes.CDLL(_SO_PATH)
    lib.merge_reset.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.merge_reset.restype = None
    lib.merge_observe.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p]
    lib.merge_observe.restype = None
    lib.merge_step.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_int] + [
                                   ctypes.c_double] * 5 + [ctypes.c_void_p]
    lib.merge_step.restype = None
    lib.merge_rollout.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int] + [
                                      ctypes.c_double] * 5 + [
                                      ctypes.c_void_p, ctypes.c_void_p]
    lib.merge_rollout.restype = ctypes.c_int
    lib.eq_qp_solve.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    lib.eq_qp_solve.restype = ctypes.c_int
    lib.mpc_1d_action.argtypes = [ctypes.c_double] * 3
    lib.mpc_1d_action.restype = ctypes.c_double
    _lib = lib
    return lib


def _ptr(arr):
    return arr.ctypes.data_as(ctypes.c_void_p)


class NativeMergeEnv:
    """Batch env over the C core, API-parallel to the numpy oracle."""

    def __init__(self, num_envs: int = 1,
                 rewards=(2.0, 1.0, -10.0, 0.001, 0.0)):
        self._lib = load_library()
        self.num_envs = num_envs
        self.rewards = tuple(float(r) for r in rewards)
        self._state = np.zeros(num_envs, _STATE_DTYPE)
        self._out = np.zeros(num_envs, _OUT_DTYPE)
        self.reset()

    def reset(self):
        self._lib.merge_reset(_ptr(self._state), self.num_envs)
        return self.observe()

    def reset_envs(self, mask):
        """Reset the envs where ``mask`` holds to the C core's start state."""
        for i in np.flatnonzero(mask):
            self._lib.merge_reset(_ptr(self._state[i:i + 1]), 1)

    def observe(self) -> np.ndarray:
        obs = np.zeros((self.num_envs, 10))
        self._lib.merge_observe(_ptr(self._state), self.num_envs, _ptr(obs))
        return obs

    def _actions(self, a):
        a = np.ascontiguousarray(a, np.int32)
        if a.shape != (self.num_envs,):
            raise ValueError(f"actions of shape {a.shape} for "
                             f"{self.num_envs} envs")
        return a

    def step(self, a1, a2):
        """a1, a2: int arrays [num_envs]; negatives mean None."""
        a1, a2 = self._actions(a1), self._actions(a2)
        self._lib.merge_step(_ptr(self._state), _ptr(a1), _ptr(a2),
                             self.num_envs, *self.rewards, _ptr(self._out))
        o = self._out
        return (o["obs"].copy(), np.stack([o["r1"], o["r2"]], -1).copy(),
                o["done"].astype(bool).copy(),
                o["collision"].astype(bool).copy(), o["winner"].copy())

    @property
    def state(self) -> np.ndarray:
        return self._state

    def rollout(self, a1_seq, a2_seq):
        """Single-env serial rollout; returns (steps, obs, rewards)."""
        if self.num_envs != 1:
            raise ValueError("rollout runs one env")
        a1 = np.ascontiguousarray(a1_seq, np.int32)
        a2 = np.ascontiguousarray(a2_seq, np.int32)
        if a1.shape != a2.shape or a1.ndim != 1:
            raise ValueError("a1_seq and a2_seq must be 1-D of one length")
        T = len(a1)
        obs = np.zeros((T, 10))
        rew = np.zeros((T, 2))
        steps = self._lib.merge_rollout(
            _ptr(self._state), _ptr(a1), _ptr(a2), T, *self.rewards,
            _ptr(obs), _ptr(rew))
        return steps, obs[:steps], rew[:steps]


def mpc_1d_action(v0: float, vt: float, t: float = 3.0) -> float:
    """Native QP solve of the reference MPC (helper.py:152-191)."""
    return float(load_library().mpc_1d_action(v0, vt, t))


def eq_qp(P, q, A, b):
    """Native dense equality-constrained QP solve."""
    lib = load_library()
    P = np.ascontiguousarray(P, np.float64)
    q = np.ascontiguousarray(q, np.float64)
    A = np.ascontiguousarray(np.atleast_2d(A), np.float64)
    b = np.ascontiguousarray(np.atleast_1d(b), np.float64)
    n, m = P.shape[0], A.shape[0]
    if P.shape != (n, n) or q.shape != (n,) or A.shape[1] != n or \
            b.shape != (m,) or n + m > 256:
        raise ValueError("eq_qp: P n x n, q n, A m x n, b m, n + m <= 256")
    u = np.zeros(n)
    if lib.eq_qp_solve(_ptr(P), _ptr(q), _ptr(A), _ptr(b), n, m, _ptr(u)):
        raise np.linalg.LinAlgError("singular KKT system")
    return u
