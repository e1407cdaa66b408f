"""The port's runtime checks and profiling utilities.

``tests/test_utils.py``'s four tests on ``merging_gym_tpu_torch.utils``
(the checks of a ``checked`` function deferred to ``err.throw()``, with
the JAX package's messages; the throughput timer; ``time_fn``), and a
``torch.profiler`` trace written on the CPU.
"""

import dataclasses
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import pytest
import torch

from merging_gym_tpu.utils import debug as jdebug
from merging_gym_tpu_torch.utils.debug import (CheckError, assert_finite,
                                               checked, validate_actions)
from merging_gym_tpu_torch.utils.profiling import (ThroughputTimer, time_fn,
                                                   trace)
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_checked_catches_nan():
    def bad(x):
        assert_finite({"x": x}, "input")
        return x * 2

    fn = checked(bad)
    err, out = fn(torch.tensor([1.0, 2.0]))
    err.throw()  # no error
    assert err.get() is None
    assert torch.equal(out, torch.tensor([2.0, 4.0]))
    err, out = fn(torch.tensor([1.0, float("nan")]))
    with pytest.raises(CheckError, match="non-finite"):
        err.throw()


def test_validate_actions():
    def f(a):
        validate_actions(a)
        return a

    fn = checked(f)
    err, _ = fn(torch.tensor([-1, 0, 4], dtype=torch.int32))
    err.throw()
    err, _ = fn(torch.tensor([5], dtype=torch.int32))
    with pytest.raises(CheckError, match="out of range"):
        err.throw()
    err, _ = fn(torch.tensor([-2, 0], dtype=torch.int32))
    with pytest.raises(CheckError, match="out of range"):
        err.throw()


class _Pair(NamedTuple):
    a: object
    b: object


@dataclasses.dataclass
class _Holder:
    w: object
    steps: int


@pytest.mark.parametrize("bad", ["x", "y1", "pair_b", "action"])
def test_messages_equal_jax(bad):
    def tree(arr):
        vals = {k: arr([float("nan") if bad == k else 1.0, 2.0])
                for k in ("x", "y1", "pair_b")}
        return {"x": vals["x"], "y": (arr([0.5]), vals["y1"]),
                "pair": _Pair(arr([3.0]), vals["pair_b"]), "n": arr([3])}

    def body(assert_fn, validate_fn):
        def f(t, acts):
            assert_fn(t, "input")
            validate_fn(acts)
            return t["x"]
        return f

    acts = [7] if bad == "action" else [1]
    err, _ = checked(body(assert_finite, validate_actions))(
        tree(torch.tensor), torch.tensor(acts))
    jerr, _ = jax.jit(jdebug.checked(body(
        jdebug.assert_finite, jdebug.validate_actions)))(
        tree(jnp.asarray), jnp.asarray(acts))
    want = jerr.get()
    assert want.endswith(" (`check` failed)")
    assert err.get() == want.removesuffix(" (`check` failed)")


def test_first_failed_check_and_dataclass_paths():
    def f(h):
        assert_finite(h, "carry")
        validate_actions(torch.tensor([8]))
    err, _ = checked(f)(_Holder(torch.tensor([1.0, float("inf")]), 7))
    assert err.get() == "non-finite value in carry.w"
    err, _ = checked(f)(_Holder(torch.tensor([1.0]), 7))
    assert err.get() == "action out of range [-1, NUM_ACTIONS)"


def test_checks_outside_checked_raise_at_once():
    assert_finite({"w": torch.ones(3)}, "params")
    with pytest.raises(CheckError,
                       match=r"non-finite value in params\['w'\]"):
        assert_finite({"w": torch.tensor([float("inf")])}, "params")
    with pytest.raises(CheckError, match="out of range"):
        validate_actions(torch.tensor([9]))


def test_throughput_timer():
    t = ThroughputTimer()
    x = torch.ones((128, 128))
    t.start()
    y = x @ x
    t.stop(128, y)
    assert t.per_second > 0
    assert t.items == 128
    with pytest.raises(RuntimeError, match="without start"):
        t.stop(1)


def test_time_fn():
    mean_s, out = time_fn(lambda x: x * 2, torch.ones((64,)), iters=3)
    assert mean_s > 0
    assert out.shape == (64,)


def test_trace_writes_a_trace_file(tmp_path):
    with trace(str(tmp_path)) as prof:
        torch.ones(256, 256) @ torch.ones(256, 256)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / files[0]) as f:
        assert "aten::mm" in f.read()
    assert any(e.key == "aten::mm" for e in prof.key_averages())
