"""Flat ``.npz`` param files, numpy only.

Counterpart of ``save_params_npz`` / ``load_params_npz`` in
``merging_gym_tpu/io/checkpoint.py``.  Keys are the JAX package's
``jax.tree_util.keystr`` names of a nested dict (``"['fc0']['w']"``), so
``model_zoo/*/params.npz`` loads unchanged and files written here load in
the JAX package.
"""

from __future__ import annotations

import re

import numpy as np

_KEY = re.compile(r"\['([^']*)'\]")


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
