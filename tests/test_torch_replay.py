"""The port's replay ring against ``merging_gym_tpu/ops/replay.py``.

Writes are deterministic, so ``add_batch`` (with and without a mask,
across the wrap-around), the learn gates and ``gather`` on injected
indices are held exactly.  Draws come from a ``torch.Generator``, not
``jax.random``: ``sample``/``sample_valid`` are held to their range and
to a uniform spread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merging_gym_tpu.ops import replay as jrp
from merging_gym_tpu_torch.ops import replay as rp
from tests.torch_threads import one_torch_thread  # noqa: F401


def _example(lib):
    if lib == "jax":
        return {"x": jnp.zeros((3,), jnp.float32),
                "a": jnp.zeros((), jnp.int32), "d": jnp.zeros((), bool)}
    return {"x": torch.zeros(3), "a": torch.zeros((), dtype=torch.int32),
            "d": torch.zeros((), dtype=torch.bool)}


def _items(rng, n):
    return {"x": rng.standard_normal((n, 3)).astype(np.float32),
            "a": rng.integers(0, 100, n).astype(np.int32),
            "d": rng.random(n) < 0.5}


def _same(state, jstate):
    assert int(state.cursor) == int(jstate.cursor)
    for k in ("x", "a", "d"):
        np.testing.assert_array_equal(state.data[k].numpy(),
                                      np.asarray(jstate.data[k]), err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
def test_add_batch_matches_jax_across_wraparound(masked):
    rng = np.random.default_rng(1)
    st, jst = rp.replay_init(11, _example("torch")), jrp.replay_init(
        11, _example("jax"))
    for i in range(7):  # 7 batches of 5 into 11 slots: wraps twice
        items = _items(rng, 5)
        mask = rng.random(5) < 0.6 if masked else None
        st = rp.add_batch(st, {k: torch.as_tensor(v) for k, v in
                               items.items()},
                          None if mask is None else torch.as_tensor(mask))
        jst = jrp.add_batch(jst, {k: jnp.asarray(v) for k, v in
                                  items.items()},
                            None if mask is None else jnp.asarray(mask))
        _same(st, jst)
        assert bool(rp.can_learn(st)) == bool(jrp.can_learn(jst))
        for b in (4, 16):
            assert (bool(rp.can_learn_valid(st, b))
                    == bool(jrp.can_learn_valid(jst, b)))
    idx = np.asarray([0, 10, 3, 3, 7, 1])
    got = rp.gather(st, torch.as_tensor(idx))
    for k in ("x", "a", "d"):
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(jst.data[k])[idx])


def test_masked_store_skips_without_consuming_slots():
    st = rp.replay_init(8, _example("torch"))
    items = {"x": torch.arange(18, dtype=torch.float32).reshape(6, 3),
             "a": torch.arange(6, dtype=torch.int32),
             "d": torch.zeros(6, dtype=torch.bool)}
    st2 = rp.add_batch(st, items, torch.tensor([1, 0, 1, 1, 0, 1]).bool())
    assert int(st2.cursor) == 4 and int(st.cursor) == 0
    assert st2.data["a"][:4].tolist() == [0, 2, 3, 5]
    assert not bool(rp.can_learn(st2))


def test_sample_range_and_uniformity():
    st = rp.replay_init(8, _example("torch"))
    items = {"x": torch.ones(8, 3), "a": torch.arange(8, dtype=torch.int32),
             "d": torch.zeros(8, dtype=torch.bool)}
    st = rp.add_batch(st, items)
    g = torch.Generator().manual_seed(0)
    batch, idx = rp.sample(st, g, 40000)
    assert batch["a"].shape == (40000,) and torch.equal(batch["a"],
                                                        idx.int())
    counts = np.bincount(idx.numpy(), minlength=8) / 40000
    np.testing.assert_allclose(counts, 1 / 8, atol=0.01)

    part = rp.add_batch(rp.replay_init(8, _example("torch")),
                        {k: v[:3] for k, v in items.items()})
    _, idx = rp.sample_valid(part, g, 30000)
    assert int(idx.min()) == 0 and int(idx.max()) == 2
    np.testing.assert_allclose(np.bincount(idx.numpy()) / 30000, 1 / 3,
                               atol=0.01)
    _, idx = rp.sample(part, g, 1000)  # over the full capacity (main.py:130)
    assert int(idx.max()) > 2
