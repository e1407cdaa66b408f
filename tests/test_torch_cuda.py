"""The port's CUDA kernels against their plain versions, on the card.

Skipped without a card.  On a machine with one (JAX need not be
installed there, so the JAX-importing conftest is left out):

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

chip_smoke.py makes the same comparisons at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from merging_gym_tpu_torch import kernels
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.io.checkpoint import load_params_npz
from merging_gym_tpu_torch.nn.mlp import qnet_init, qnet_params_from_numpy
from merging_gym_tpu_torch.ops import fused_mlp as FM
from merging_gym_tpu_torch.ops import fused_policy_rollout as FPR
from merging_gym_tpu_torch.ops import fused_rollout as FR

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("mode", ["actions", "seed"])
def test_k1_k2_equal_plain(cuda, mode):
    T, N = 128, 300  # N not a multiple of the 128-thread block
    rng = np.random.default_rng(0)
    kw = ({"actions": torch.as_tensor(rng.integers(-1, 5, (T, 2, N)),
                                      dtype=torch.int32, device=cuda)}
          if mode == "actions" else {"seed": 9, "device": cuda})
    before = dict(kernels.launch_counts)
    _equal(FR.fused_rollout(T, N, **kw), FR.fused_rollout_plain(T, N, **kw))
    _equal(FR.fused_rollout_counters(T, N, **kw),
           FR.fused_rollout_counters_plain(T, N, **kw))
    assert kernels.launch_counts["env_rollout"] == before["env_rollout"] + 1
    assert kernels.launch_counts["env_counters"] == before["env_counters"] + 1


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,d_in", [(1, 10), (33, 10), (4096, 10),
                                        (77, 11)])
def test_k3_equals_plain(cuda, compute_dtype, batch, d_in):
    p = qnet_init(torch.Generator(device=cuda).manual_seed(0), d_in, 5)
    x = torch.randn(batch, d_in, device=cuda) * 100
    assert torch.equal(FM.qnet_apply_fused(p, x, compute_dtype),
                       FM.qnet_apply_plain(p, x, compute_dtype))


def test_k3_wide_net_uses_a_smaller_tile(cuda):
    p = qnet_init(torch.Generator(device=cuda).manual_seed(1), 10, 5,
                  hidden=(2048, 1024))
    x = torch.randn(70, 10, device=cuda)
    assert torch.equal(FM.qnet_apply_fused(p, x), FM.qnet_apply_plain(p, x))


@pytest.mark.parametrize("case", ["greedy_l0", "greedy_selfplay", "phi",
                                  "random_start", "bf16"])
def test_k6_equals_plain(cuda, case):
    p1 = qnet_params_from_numpy(load_params_npz("model_zoo/L2/params.npz"),
                                cuda)
    p2 = qnet_params_from_numpy(load_params_npz("model_zoo/L1/params.npz"),
                                cuda)
    kw = {"greedy_l0": dict(greedy=True),
          "greedy_selfplay": dict(greedy=True,
                                  env_params=EnvParams(max_steps=50)),
          "phi": dict(greedy=False, seed=3),
          "random_start": dict(greedy=False, seed=4,
                               env_params=EnvParams(random_start=True)),
          "bf16": dict(greedy=False, seed=5, compute_dtype="bfloat16")}[case]
    other = None if case == "greedy_l0" else p2
    _equal(FPR.fused_policy_rollout(120, 200, p1, other, **kw),
           FPR.fused_policy_rollout_plain(120, 200, p1, other, **kw))


def test_kernels_refuse_mixed_devices(cuda):
    p = qnet_init(torch.Generator(device=cuda).manual_seed(0), 10, 5)
    with pytest.raises(ValueError, match="CUDA device"):
        FM.launch_mlp(FM.cast_weights(p, torch.float32, cuda),
                      torch.zeros(4, 10), torch.zeros(4, 5, device=cuda))
