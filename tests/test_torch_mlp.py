"""K3 of the PyTorch port (plain version, on the CPU) against the JAX
Pallas kernel in interpret mode, the bf16 band, the carry-across of
weights and the model zoo's param files.

Tolerances are the JAX tests' own: rtol 1e-5 / atol 1e-3 for the f32
forward (tests/test_fused_mlp.py:34-35), 5e-2 for the bf16 Q band
(tests/test_fused_policy_rollout.py:174-175).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merging_gym_tpu.io.checkpoint import load_params_npz as jax_load_npz
from merging_gym_tpu.nn.mlp import qnet_apply as jax_qnet_apply
from merging_gym_tpu.nn.mlp import qnet_init as jax_qnet_init
from merging_gym_tpu.ops import fused_mlp as JFM
from merging_gym_tpu.ops import fused_policy_rollout as JFPR
from merging_gym_tpu_torch.io.checkpoint import load_params_npz, save_params_npz
from merging_gym_tpu_torch.nn import mlp as M
from merging_gym_tpu_torch.ops import fused_mlp as FM

CPU = torch.device("cpu")
ZOO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "model_zoo")


@pytest.fixture
def _interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(JFM.pl, "pallas_call", patched)
    yield


def _jax_params(seed, d_in=10, d_out=5):
    p = jax_qnet_init(jax.random.key(seed), d_in, d_out, dtype=jnp.float32)
    return jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("batch,d_in", [(8, 10), (512, 10), (700, 10),
                                        (64, 11)])
def test_k3_plain_matches_pallas_kernel(_interpret_mode, batch, d_in):
    params = _jax_params(0, d_in)
    x = (np.random.default_rng(1).standard_normal((batch, d_in)) * 100
         ).astype(np.float32)
    want = JFM.qnet_apply_fused(params, jnp.asarray(x),
                                block=512 if d_in == 10 else 64)
    got = FM.qnet_apply_fused(M.qnet_params_from_numpy(params, CPU),
                              torch.as_tensor(x))
    assert got.shape == (batch, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-3)


def test_qnet_apply_matches_jax_and_keeps_leading_dims():
    params = _jax_params(2)
    x = np.random.default_rng(3).standard_normal((3, 7, 10)).astype(np.float32)
    got = M.qnet_apply(M.qnet_params_from_numpy(params, CPU),
                       torch.as_tensor(x))
    want = jax_qnet_apply(params, jnp.asarray(x))
    assert got.shape == (3, 7, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-3)


def test_bf16_band_against_f32_and_jax():
    # The JAX policy kernel's bf16 _mlp_t (weights stored bf16, bf16
    # activations, f32 accumulation) on the same small-magnitude nets.
    p = jax.tree.map(lambda w: (w - jnp.mean(w)) * 0.05,
                     jax_qnet_init(jax.random.key(7), 10, 5))
    obs = (np.random.default_rng(3).standard_normal((256, 10)) * 50
           ).astype(np.float32)
    tp = M.qnet_params_from_numpy(jax.tree.map(np.asarray, p), CPU)
    q32 = M.qnet_apply(tp, torch.as_tensor(obs))
    q16 = M.qnet_apply(tp, torch.as_tensor(obs), compute_dtype="bfloat16")
    assert q16.dtype == torch.float32
    np.testing.assert_allclose(q16.numpy(), q32.numpy(), rtol=5e-2, atol=5e-2)
    assert not torch.equal(q16, q32)  # it really ran in bf16

    class _R:  # the JAX kernel reads w[:]
        def __init__(self, a): self.a = a
        def __getitem__(self, k): return self.a[k]
    w16 = [jnp.asarray(a) for a in JFPR._weight_args(p, jnp.bfloat16)]
    want = JFPR._mlp_t(jnp.asarray(obs.T), *[_R(a) for a in w16],
                       dtype=jnp.bfloat16)
    np.testing.assert_allclose(q16.numpy(), np.asarray(want).T, rtol=5e-2,
                               atol=5e-2)


def test_weights_carry_across_from_jax():
    params = _jax_params(4)
    tp = M.qnet_params_from_numpy(params, CPU)
    assert sorted(tp) == ["fc0", "fc1", "fc2"]
    for layer in tp:
        for k in ("w", "b"):
            assert tp[layer][k].dtype == torch.float32
            np.testing.assert_array_equal(tp[layer][k].numpy(),
                                          params[layer][k])
    assert tuple(tp["fc0"]["w"].shape) == (10, 200)


def test_model_zoo_params_load_unchanged(tmp_path):
    path = os.path.join(ZOO, "L1", "params.npz")
    raw = load_params_npz(path)
    like = jax_qnet_init(jax.random.key(0), 10, 5)
    jp = jax_load_npz(path, like)
    for layer in ("fc0", "fc1", "fc2"):
        for k in ("w", "b"):
            np.testing.assert_array_equal(raw[layer][k],
                                          np.asarray(jp[layer][k]))
    x = (np.random.default_rng(5).standard_normal((64, 10)) * 100
         ).astype(np.float32)
    got = M.qnet_apply(M.qnet_params_from_numpy(raw, CPU), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_qnet_apply(jp, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-3)
    # Round trip: a file written by the port loads in the JAX package.
    out = str(tmp_path / "p.npz")
    save_params_npz(out, M.qnet_params_from_numpy(raw, CPU))
    back = jax_load_npz(out, like)
    for layer in ("fc0", "fc1", "fc2"):
        np.testing.assert_array_equal(np.asarray(back[layer]["w"]),
                                      raw[layer]["w"])


def test_qnet_module_and_init():
    gen = torch.Generator().manual_seed(0)
    net = M.QNet(M.qnet_init(gen, 10, 5, device=CPU))
    p = net.params()
    w, b = p["fc1"]["w"], p["fc1"]["b"]
    assert w.shape == (200, 100) and 0 <= w.min() and w.max() < 1
    assert b.abs().max() <= 1 / np.sqrt(200)
    x = torch.randn(16, 10, generator=gen) * 10
    np.testing.assert_array_equal(net(x).detach().numpy(),
                                  M.qnet_apply(p, x).detach().numpy())
    again = M.qnet_init(torch.Generator().manual_seed(0), 10, 5, device=CPU)
    assert torch.equal(again["fc0"]["w"], p["fc0"]["w"].detach())


def test_unknown_compute_dtype_rejected():
    with pytest.raises(ValueError, match="compute_dtype"):
        M.qnet_apply(M.qnet_params_from_numpy(_jax_params(0), CPU),
                     torch.zeros(2, 10), compute_dtype="float16")
