"""K4 of the PyTorch port (plain version, on the CPU) against the JAX
package.

The JAX kernel draws from the TPU PRNG, which has no CPU lowering
(``tests/test_fused_actor.py`` skips here), so K4 is held three ways:
rows whose mask word keeps the greedy arm equal JAX's
``argmax(qnet_apply)`` exactly on decisive nets; the greedy share is
Phi(0.7) plus the random arm's 1/A (the rule of
``tests/test_fused_actor.py:25-43``); the random arm is uniform.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merging_gym_tpu.nn.mlp import qnet_apply as jax_qnet_apply
from merging_gym_tpu.nn.mlp import qnet_init as jax_qnet_init
from merging_gym_tpu_torch.nn.mlp import qnet_params_from_numpy
from merging_gym_tpu_torch.ops import fused_actor as FA
from merging_gym_tpu_torch.ops import philox
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
PHI = 0.5 * (1 + math.erf(0.7 / math.sqrt(2)))


def _params(seed, flat_out=False):
    p = jax_qnet_init(jax.random.key(seed), 10, 5)
    p = jax.tree.map(lambda w: np.asarray((w - jnp.mean(w)) * 0.05), p)
    if flat_out:  # constant Q: the greedy action is always 0
        p["fc2"] = {"w": np.zeros_like(p["fc2"]["w"]),
                    "b": np.zeros_like(p["fc2"]["b"])}
    return p


def _obs(seed, n):
    return np.random.default_rng(seed).standard_normal((n, 10)).astype(
        np.float32) * 50.0


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_kept_greedy_rows_equal_jax_argmax(compute_dtype):
    p, obs = _params(0), _obs(1, 3001)  # ragged B
    q = np.asarray(jax_qnet_apply(p, jnp.asarray(obs)))
    top2 = np.sort(q, axis=1)[:, -2:]
    decisive = (top2[:, 1] - top2[:, 0]) > 1e-2 * np.abs(top2[:, 1]).max()
    want = q.argmax(axis=1)
    seed = 77
    acts = FA.fused_eps_greedy_actions(qnet_params_from_numpy(p, CPU),
                                       torch.as_tensor(obs), seed,
                                       compute_dtype=compute_dtype).numpy()
    assert acts.shape == (3001,) and acts.dtype == np.int32
    mask = philox.draw(0, 3001, philox.STREAM_ACTIONS, philox.seed_key(seed),
                       CPU)[0].numpy()
    kept = mask < FA.greedy_threshold(0.7)
    assert 0.7 < kept.mean() < 0.8
    rows = kept & decisive
    assert rows.sum() > 2000
    np.testing.assert_array_equal(acts[rows], want[rows])


def test_greedy_fraction_matches_phi():
    p, obs = _params(2), _obs(3, 2048)
    greedy = np.asarray(jnp.argmax(jax_qnet_apply(p, jnp.asarray(obs)),
                                   axis=-1))
    pt = qnet_params_from_numpy(p, CPU)
    match = [(FA.fused_eps_greedy_actions(pt, torch.as_tensor(obs),
                                          seed).numpy() == greedy).mean()
             for seed in range(4)]
    assert abs(np.mean(match) - (PHI + (1 - PHI) / 5)) < 0.02


def test_random_arm_uniform():
    pt = qnet_params_from_numpy(_params(4, flat_out=True), CPU)
    acts = FA.fused_eps_greedy_actions(pt, torch.as_tensor(_obs(5, 4096)),
                                       7).numpy()
    counts = np.bincount(acts, minlength=5) / acts.shape[0]
    assert abs(counts[0] - (PHI + (1 - PHI) / 5)) < 0.03
    for a in range(1, 5):
        assert abs(counts[a] - (1 - PHI) / 5) < 0.02


def test_seeds_give_distinct_draws():
    pt = qnet_params_from_numpy(_params(6), CPU)
    obs = torch.as_tensor(np.tile(_obs(7, 512), (2, 1)))
    a = FA.fused_eps_greedy_actions(pt, obs, 3)
    assert torch.equal(a, FA.fused_eps_greedy_actions(pt, obs, 3))
    assert not torch.equal(a, FA.fused_eps_greedy_actions(pt, obs, 4))
    assert not torch.equal(a[:512], a[512:])  # rows draw apart
