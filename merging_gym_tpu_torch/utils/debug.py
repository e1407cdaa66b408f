"""Runtime validation: NaNs and out-of-range actions as real errors.

Counterpart of ``merging_gym_tpu/utils/debug.py``, whose checks run under
``jax.experimental.checkify``.  Here the checks inside a :func:`checked`
function are recorded as device booleans and read back once, when the
caller asks for them with ``err.get()`` or ``err.throw()``: as checkify
defers its errors, a check does not synchronise with the card inside the
function.  Outside :func:`checked` a check reads its boolean back and
raises at once.  Only these explicit checks are collected (checkify's
``all_checks`` also adds automatic NaN, division and index checks to every
operation; PyTorch has no such transform).

* :func:`checked` -- wrap a function so ``wrapped(*args)`` returns
  ``(err, out)``; ``err.throw()`` raises the first failed check;
* :func:`assert_finite` -- every floating tensor of a tree is finite;
* :func:`validate_actions` -- range check for action tensors (the
  sentinel -1 is legal; anything below, or >= NUM_ACTIONS, is not).
"""

from __future__ import annotations

import dataclasses
import functools
import threading

import torch

from merging_gym_tpu_torch.core import constants as C


class CheckError(RuntimeError):
    """A failed check of :func:`assert_finite` or :func:`validate_actions`."""


class Error:
    """The checks of one call of a :func:`checked` function: (device
    boolean, message) pairs, read back together by :meth:`get`."""

    def __init__(self):
        self._checks = []

    def _add(self, ok: torch.Tensor, message: str) -> None:
        self._checks.append((ok, message))

    def get(self) -> str | None:
        """The message of the first failed check, or None (one read-back
        for all the checks)."""
        if not self._checks:
            return None
        dev = self._checks[0][0].device
        oks = torch.stack([ok.to(dev) for ok, _ in self._checks]).tolist()
        return next((m for ok, (_, m) in zip(oks, self._checks) if not ok),
                    None)

    def throw(self) -> None:
        message = self.get()
        if message is not None:
            raise CheckError(message)


_calls = threading.local()  # .active: the Error of each checked call in
                            # progress on this thread, innermost last


def _active() -> list:
    if not hasattr(_calls, "active"):
        _calls.active = []
    return _calls.active


def checked(fn):
    """Returns ``(err, out) = wrapped(*args)``; call ``err.throw()``."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        err = Error()
        _active().append(err)
        try:
            out = fn(*args, **kwargs)
        finally:
            _active().pop()
        return err, out
    return wrapped


def check(ok: torch.Tensor, message: str) -> None:
    """Record ``ok`` (a boolean tensor) in the innermost checked call, or,
    outside one, raise at once where it is false."""
    active = _active()
    if active:
        active[-1]._add(ok, message)
    elif not bool(ok):
        raise CheckError(message)


def _leaves(tree, path=""):
    """(path, leaf) of a tree of dicts, lists, tuples and dataclasses, the
    path in ``jax.tree_util.keystr``'s form (``['x'][0].field``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif hasattr(tree, "_fields") or dataclasses.is_dataclass(tree):
        names = (tree._fields if hasattr(tree, "_fields")
                 else [f.name for f in dataclasses.fields(tree)])
        for k in names:
            yield from _leaves(getattr(tree, k), f"{path}.{k}")
    elif tree is not None:
        yield path, tree


def assert_finite(tree, name: str = "tree") -> None:
    for path, leaf in _leaves(tree):
        leaf = torch.as_tensor(leaf)
        if leaf.is_floating_point():
            check(torch.isfinite(leaf).all(),
                  f"non-finite value in {name}{path}")


def validate_actions(actions: torch.Tensor) -> None:
    check(((actions >= C.ACTION_NONE) & (actions < C.NUM_ACTIONS)).all(),
          "action out of range [-1, NUM_ACTIONS)")
