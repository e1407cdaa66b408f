"""The C51 projection at clipped targets, against eager JAX.

Where Tz is clipped to Vmax = 10 on the 51-atom f32 support, the port's
``ops.projection`` computes b = (Tz - Vmin) / delta_z = 50 exactly, so
floor(b) = ceil(b) = 50: the faithful mode drops that atom's mass, as the
reference (scripts/ranbowdqn.py:554-582) and eager JAX do, and the
textbook mode puts all of it on atom 50.  Under ``jax.jit`` b comes out a
few ulps above 50 and the mass is kept instead (ROADMAP Queue 3); these
tests keep the port on the eager semantics, at 1e-6 on every clipped row.
Rows whose targets do not clip differ from XLA:CPU in the last bit of b
(ROADMAP Queue 3, f32 ulps); they are held at one ulp of b near 50
(3.8e-6) times the largest |p z| (10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merging_gym_tpu.nn import rainbow_net as JRN
from merging_gym_tpu.ops.projection import categorical_projection as jproj
from merging_gym_tpu_torch.nn import rainbow_net as RN
from merging_gym_tpu_torch.ops.projection import categorical_projection
from tests.torch_threads import one_torch_thread  # noqa: F401

# (rewards, dones): every row's Tz reaches Vmax = 10 -- a terminal reward
# of exactly 10, and rewards whose discounted targets all clip.
CLIPPED = ([10.0, 50.0, 100.0, 300.0, 12.5], [1.0, 0.0, 0.0, 0.0, 1.0])
# The batch of ROADMAP Queue 3's scratch check (gamma 0.99**2, no dones).
MIXED = ([0.5, 1.0, 2.0, 50.0, 100.0, 300.0], [0.0] * 6)


def _both(rewards, dones, weight, gamma=0.99):
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(len(rewards), 51))
    probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(
        np.float32)
    r = np.asarray(rewards, np.float32)
    d = np.asarray(dones, np.float32)
    want = np.asarray(jproj(jnp.asarray(probs), jnp.asarray(r),
                            jnp.asarray(d), JRN.support(jnp.float32), gamma,
                            weight))
    got = categorical_projection(torch.as_tensor(probs), torch.as_tensor(r),
                                 torch.as_tensor(d),
                                 RN.support(torch.float32), gamma, weight)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    return probs, got.numpy(), want


@pytest.mark.parametrize("weight", [True, False], ids=["faithful",
                                                       "textbook"])
def test_clipped_targets_land_on_atom_50_as_in_eager_jax(weight):
    probs, got, want = _both(*CLIPPED, weight)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if weight:  # lo = hi = 50: both weights 0, the whole row's mass dropped
        assert not got.any()
    else:       # b = 50 exactly: every row's mass on atom 50, none beyond
        np.testing.assert_allclose(got[:, 50], probs.sum(-1), atol=1e-6)
        assert not got[:, :50].any()


@pytest.mark.parametrize("weight", [True, False], ids=["faithful",
                                                       "textbook"])
def test_large_rewards_match_eager_jax(weight):
    _, got, want = _both(*MIXED, weight, gamma=0.99 ** 2)
    np.testing.assert_allclose(got[3:], want[3:], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:3], want[:3], rtol=0, atol=3.9e-5)
    if weight:  # rewards >= 50 clip every atom: mass 0, as eagerly in JAX
        assert not got[3:].any()
