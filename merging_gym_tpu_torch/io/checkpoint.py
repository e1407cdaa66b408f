"""Run directories, flat ``.npz`` param files and full-carry checkpoints,
without JAX.

``save_params_npz`` / ``load_params_npz`` and ``run_dir_name`` are the
counterparts of those in ``merging_gym_tpu/io/checkpoint.py`` (which
imports JAX and orbax, so they are copied, not imported).  Keys are the
JAX package's ``jax.tree_util.keystr`` names of a nested dict
(``"['fc0']['w']"``), so ``model_zoo/*/params.npz`` loads unchanged and
files written here load in the JAX package.

``CheckpointManager`` keeps the JAX class's API and retention (the last
``max_to_keep`` steps by step number; a step at or below the newest one
kept is not written, as orbax skips it), for one process: the
multi-process branch belongs with the parallel trainers.  A checkpoint is
the whole train carry, one ``<step>.pt`` file per step written by
``torch.save`` to a temporary file in the directory and then renamed, so
a killed save leaves no partial step.  The carry goes through
:func:`state_tree`, a plain tree of tensors, Python scalars, strings,
``None``, dicts, tuples and lists (dataclasses become their fields, a
``torch.Generator`` its ``get_state()`` and device type), so that
``torch.load(..., weights_only=True)`` reads it back without running
pickled code.  :func:`load_into` is led by a template, as orbax's
``StandardRestore`` is: the fresh carry that the same arguments build.
Every leaf must match the template's in type, shape and dtype, tensors
go to the template's device, and the fused carries' host counters come
back as the Python ints and floats that the chunks schedule on, so the
port needs no counterpart of the JAX package's ``coerce_carry``,
``coerce_hdqn_carry``, ``coerce_rainbow_carry`` or ``coerce_drqn_carry``.
A generator's state cannot cross device types (a CPU generator holds a
mt19937 state, a CUDA one a Philox seed and offset): a step-loop carry
restores on the device type it was written on.  The fused carries hold
no generator and restore on either.  The JAX package's orbax
directories cannot be read without JAX and are refused.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re

import numpy as np
import torch

_KEY = re.compile(r"\['([^']*)'\]")
_STEP_FILE = re.compile(r"^(\d+)\.pt$")
FORMAT = "merging_gym_tpu_torch.checkpoint/1"


def run_dir_name(label: str, strategy: str, reward_tuple,
                 root: str = ".") -> str:
    """Reference-style run directory name (main.py:239)."""
    stamp = datetime.datetime.now().strftime("%Y--%m--%d %H:%M:%S")
    return os.path.join(root,
                        f"{stamp}{label} with OP:{strategy}{tuple(reward_tuple)}")


def _flatten(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}['{k}']"
        if isinstance(v, dict):
            yield from _flatten(v, name)
        else:
            yield name, v


def save_params_npz(path: str, params: dict) -> None:
    """Write a nested param dict (numpy arrays or tensors) as flat npz."""
    arrays = {}
    for name, v in _flatten(params):
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        arrays[name] = np.asarray(v)
    np.savez(path, **arrays)


def load_params_npz(path: str) -> dict:
    """Read a flat npz back into a nested dict of numpy arrays."""
    out: dict = {}
    with np.load(path) as data:
        for name in data.files:
            keys = _KEY.findall(name)
            if not keys or "".join(f"['{k}']" for k in keys) != name:
                raise ValueError(f"{path}: unexpected key {name!r}")
            node = out
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = data[name]
    return out


# ---------------------------------------------------------------------------
# Full-carry checkpoints
# ---------------------------------------------------------------------------

def state_tree(obj, path: str = "state"):
    """``obj`` (a train carry) as a plain tree that ``torch.save`` writes
    and ``torch.load(..., weights_only=True)`` reads: tensors as compact
    CPU copies, a dataclass as ``{"__dataclass__": name, "fields": ...}``,
    a generator as ``{"__generator__": device type, "state": ...}``."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, torch.Generator):
        return {"__generator__": obj.device.type, "state": obj.get_state()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"__dataclass__": type(obj).__name__,
                "fields": {f.name: state_tree(getattr(obj, f.name),
                                              f"{path}.{f.name}")
                           for f in dataclasses.fields(obj)}}
    if isinstance(obj, dict):
        return {k: state_tree(v, f"{path}[{k!r}]") for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(state_tree(v, f"{path}[{i}]")
                         for i, v in enumerate(obj))
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"{path}: cannot checkpoint a {type(obj).__name__}")


def _mismatch(path, what):
    return ValueError(f"checkpoint does not match this run at {path}: {what}")


def load_into(state_like, tree, path: str = "state"):
    """A new carry shaped as ``state_like`` with the leaves of ``tree`` (a
    :func:`state_tree`): tensors on the template's devices, each leaf
    checked against the template's type, shape and dtype."""
    like = state_like
    if isinstance(like, torch.Tensor):
        if not isinstance(tree, torch.Tensor):
            raise _mismatch(path, f"a tensor, found {type(tree).__name__}")
        if tree.shape != like.shape or tree.dtype != like.dtype:
            raise _mismatch(path, f"{tree.dtype}{list(tree.shape)} saved, "
                                  f"{like.dtype}{list(like.shape)} expected")
        return tree.to(like.device)
    if isinstance(like, torch.Generator):
        if not (isinstance(tree, dict) and "__generator__" in tree):
            raise _mismatch(path, "a generator was expected")
        if tree["__generator__"] != like.device.type:
            raise ValueError(
                f"{path}: a {tree['__generator__']} generator's state cannot "
                f"be restored into a {like.device.type} generator; resume "
                f"this step-loop run on {tree['__generator__']}")
        gen = torch.Generator(device=like.device)
        gen.set_state(tree["state"])
        return gen
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        name = type(like).__name__
        if not (isinstance(tree, dict) and tree.get("__dataclass__") == name):
            found = (tree.get("__dataclass__") if isinstance(tree, dict)
                     else type(tree).__name__)
            raise _mismatch(path, f"a {name} expected, {found} saved")
        fields = [f.name for f in dataclasses.fields(like)]
        if set(tree["fields"]) != set(fields):
            raise _mismatch(path, f"{name} fields {sorted(tree['fields'])}")
        return dataclasses.replace(like, **{
            k: load_into(getattr(like, k), tree["fields"][k], f"{path}.{k}")
            for k in fields})
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            keys = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise _mismatch(path, f"keys {keys}, expected {sorted(like)}")
        return {k: load_into(v, tree[k], f"{path}[{k!r}]")
                for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        if type(tree) is not type(like) or len(tree) != len(like):
            raise _mismatch(path, f"a {type(like).__name__} of {len(like)} "
                                  "expected")
        return type(like)(load_into(a, b, f"{path}[{i}]")
                          for i, (a, b) in enumerate(zip(like, tree)))
    if type(tree) is not type(like):
        raise _mismatch(path, f"{type(tree).__name__} saved, "
                              f"{type(like).__name__} expected")
    return tree


class CheckpointManager:
    """Full-carry saves with retention, the JAX class's API for one
    process: ``save(step, state, wait=False)``, ``restore(state_like,
    step=None)``, ``latest_step()``, ``all_steps()``, ``close()``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def all_steps(self) -> list:
        """Steps held, oldest first (temporary files of a save that did
        not finish are not steps)."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(
            _STEP_FILE.match, os.listdir(self.directory)) if m)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, wait: bool = False) -> bool:
        """Write ``state`` as ``step`` and drop all but the newest
        ``max_to_keep`` steps; a step at or below the newest held is
        skipped (returns False), as orbax skips it.  Saves are synchronous,
        so ``wait`` changes nothing."""
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        os.makedirs(self.directory, exist_ok=True)
        tmp = os.path.join(self.directory, f".{step}.pt.{os.getpid()}.tmp")
        with open(tmp, "wb") as f:
            torch.save({"format": FORMAT, "step": int(step),
                        "state": state_tree(state)}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.step_path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self.step_path(old))
        return True

    def restore(self, state_like, step=None):
        """The carry saved as ``step`` (default: the newest), shaped and
        placed as the template ``state_like``."""
        step = self.latest_step() if step is None else step
        if step is None:
            if _is_orbax_dir(self.directory):
                raise ValueError(
                    f"{self.directory} holds orbax checkpoints of the JAX "
                    "package, which the PyTorch port cannot read without "
                    "JAX")
            raise ValueError(f"no checkpoints under {self.directory}")
        payload = torch.load(self.step_path(step), map_location="cpu",
                             weights_only=True)
        if not (isinstance(payload, dict) and payload.get("format") == FORMAT):
            raise ValueError(f"{self.step_path(step)} is not a checkpoint of "
                             "the PyTorch port")
        return load_into(state_like, payload["state"])

    def close(self) -> None:
        pass


def _is_orbax_dir(directory: str) -> bool:
    """Whether ``directory`` holds orbax step directories (``<step>/``)."""
    return os.path.isdir(directory) and any(
        name.isdigit() and os.path.isdir(os.path.join(directory, name))
        for name in os.listdir(directory))
