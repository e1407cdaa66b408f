"""Hand-written CUDA kernels for Hopper, built with nvcc, bound with ctypes.

The sources are in ``csrc/``; each ``.cu`` file becomes one shared library
with a plain C interface, compiled for ``sm_90a`` at first use into
``_build/`` (listed in ``.gitignore``).  Flags: ``-O3 -fmad=false`` and no
fast math, so every f32 add and multiply is rounded on its own, as in the
plain PyTorch versions, and ``sinf``/``logf`` are the accurate library
functions.  A missing ``nvcc`` or a failed build raises; nothing falls back.

``launch_counts`` holds one integer per kernel; each wrapper adds one where
it launches its kernel, and nowhere else (a replay of a CUDA graph adds
the launches it holds).  ``graph_counts`` says how often K5's chunk graph
(``ops.fused_trainer.ChunkGraph``) was captured and replayed.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
LIBRARIES = ("env_rollout", "qnet_mlp", "policy_rollout", "fused_actor",
             "dqn_trainer", "hdqn_trainer", "rainbow_trainer",
             "drqn_trainer")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

SMEM_LIMIT = 232448  # dynamic shared memory one block can use on sm_90

launch_counts = {"env_rollout": 0, "env_counters": 0, "qnet_mlp": 0,
                 "policy_rollout": 0, "fused_actor": 0,
                 # K5's three per-step kernels: act/env/store, the
                 # learner's forward/backward and its gradients + Adam
                 "dqn_act_env_store": 0, "dqn_learn_fwd": 0,
                 "dqn_learn_grad": 0,
                 # K7's five: its act/env/store kernel and the learner
                 # kernels of dqn_trainer.cu for its lower and upper nets
                 "hdqn_act_env_store": 0, "hdqn_learn_fwd_lower": 0,
                 "hdqn_learn_grad_lower": 0, "hdqn_learn_fwd_upper": 0,
                 "hdqn_learn_grad_upper": 0,
                 # K8's five: act/env/store, the PER pick, the learner's
                 # forward/backward and its gradients + Adam, and the noise
                 # / sync / weights pass
                 "rainbow_act": 0, "rainbow_per_pick": 0,
                 "rainbow_learn_fwd": 0, "rainbow_learn_grad": 0,
                 "rainbow_post": 0,
                 # K9's four: act/env/window/flush, the learner's input
                 # side, its recurrence, its gradients + Adam
                 "drqn_act": 0, "drqn_learn_in": 0, "drqn_learn_rec": 0,
                 "drqn_learn_grad": 0}

graph_counts = {"dqn_chunk_capture": 0, "dqn_chunk_replay": 0}

_libs: dict = {}
_funcs: dict = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "cannot be built")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    path = _lib_path(name)
    if not os.path.exists(path):
        return True
    built = os.path.getmtime(path)
    return any(os.path.getmtime(os.path.join(CSRC, f)) > built
               for f in os.listdir(CSRC))


def build(names=LIBRARIES, force: bool = False) -> dict:
    """Compile the named libraries, one ``nvcc`` each, all at once.

    Returns ``{name: seconds}`` for the ones compiled.  The compiler's
    register/shared-memory report goes to ``_build/<name>.log``.
    """
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        log = open(os.path.join(BUILD_DIR, f"{name}.log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       tmp, log, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, log, t0) in procs.items():
        rc = proc.wait()
        seconds[name] = time.perf_counter() - t0
        log.close()
        if rc == 0:
            os.replace(tmp, _lib_path(name))
        else:
            os.unlink(tmp)
            with open(log.name) as f:
                failed.append(f"{name} (nvcc rc={rc}):\n{f.read()[-4000:]}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def function(lib: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of library ``lib``, built if needed."""
    key = (lib, name)
    fn = _funcs.get(key)
    if fn is None:
        if lib not in _libs:
            build([lib])
            _libs[lib] = ctypes.CDLL(_lib_path(lib))
        fn = getattr(_libs[lib], name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _funcs[key] = fn
    return fn


def check(lib: str, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        err = getattr(_libs[lib], "mgt_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({err(rc).decode()})")


def tile_size(preferred: int, f32_bytes_per_row: int,
              bytes_per_row: int) -> int:
    """Rows per block whose shared-memory tile fits the block's 227 KB."""
    per_row = f32_bytes_per_row + bytes_per_row
    tile = min(preferred, SMEM_LIMIT // per_row)
    if tile < 1:
        raise ValueError(f"a net this wide needs {per_row} B of shared "
                         f"memory per row, above the {SMEM_LIMIT} B limit")
    return tile


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def require_cuda(*tensors: torch.Tensor) -> torch.device:
    """All tensors contiguous on one CUDA device, which is made current."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError("kernel operands must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    torch.cuda.set_device(dev)
    return dev
