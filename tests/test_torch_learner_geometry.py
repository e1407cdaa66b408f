"""The Double-DQN learner that K5 and K7 share, on the CPU: its launch
geometry on an H100's 132 SMs, its shared-memory layout and workspace, and
what the wrappers do with CPU tensors.

``ops.fused_trainer.learn_geometry`` must put a block on more than half of
the SMs at B 1,024 for K5's net and both of K7's, lay out each block's
shared memory within ``kernels.SMEM_LIMIT`` at every width the CLI takes,
and refuse a net that does not fit.  The layout is recounted here from
``dqn_trainer.cu:LearnSmem`` and ``qnet_tiled.cuh:QnetSmem``.  On CPU
tensors ``fused_dqn_chunk`` and ``fused_hdqn_chunk`` run their plain
versions, and ``Learner`` refuses them before it builds or runs anything.
"""

import pytest
import torch

from merging_gym_tpu_torch import kernels
from merging_gym_tpu_torch.agents import dqn as D
from merging_gym_tpu_torch.agents import hdqn as H
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.ops import fused_hdqn as FH
from merging_gym_tpu_torch.ops import fused_mlp as FM
from merging_gym_tpu_torch.ops import fused_trainer as FT
from tests.torch_threads import one_torch_thread  # noqa: F401

SMS = 132
CPU = torch.device("cpu")
K5_NET, K7_LOWER, K7_UPPER = (10, 200, 100, 5), (11, 200, 100, 5), \
    (10, 200, 100, 3)
ODD = (10, 150, 75, 5)      # --hidden 150 75
WIDE = (10, 1024, 512, 5)   # learn_tile 8 in f32
NETS = {"k5": K5_NET, "k7_lower": K7_LOWER, "k7_upper": K7_UPPER,
        "hidden_150_75": ODD, "wide": WIDE}
# B 1,024 with K 1; 512 lanes in 4 windows at 4,096 envs; the card tests'
# 256 and 128.
BATCHES = (1024, 512, 256, 128)
ELEMS = pytest.mark.parametrize("elem", [4, 2], ids=["f32", "bf16"])


def _a16(n):
    return (n + 15) // 16 * 16


def _stride(k):
    return (k + 3) // 4 * 4 + 4


def _layout(dims, lanes, chunk, elem):
    """Bytes of learn_fwd_kernel's shared memory, counted region by
    region."""
    d_in, h1, h2, a = dims
    rows = 2 * lanes  # x and x' of each lane
    forward = _a16(2 * chunk * elem) + sum(
        _a16(rows * _stride(k) * elem) for k in (d_in, h1, h2))
    q, qnt, lane = rows * a * 4, lanes * a * 4, lanes * 4 * 4
    dq = dqc = lanes * a * 4
    dz2c = lanes * _stride(h2) * elem
    return forward + _a16(q) + _a16(qnt) + _a16(lane) + _a16(dq) \
        + _a16(dqc) + dz2c


@ELEMS
@pytest.mark.parametrize("net", ["k5", "k7_lower", "k7_upper"])
def test_more_than_half_the_sms_hold_a_block_at_b1024(net, elem):
    g = FT.learn_geometry(1024, NETS[net], elem, SMS)
    blocks = -(-1024 // g.lanes)
    assert SMS // 2 < blocks <= SMS
    # The summation tile no longer sets the grid: the old learner ran
    # B / learn_tile = 64 blocks.
    assert blocks > 1024 // FT.learn_tile(NETS[net], elem)


@ELEMS
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("net", list(NETS))
def test_layout_fits_and_matches_the_kernel(net, batch, elem):
    dims = NETS[net]
    g = FT.learn_geometry(batch, dims, elem, SMS)
    assert g.lanes & (g.lanes - 1) == 0 and g.lanes <= FT.LEARN_LANES_MAX
    assert -(-batch // g.lanes) <= SMS or g.lanes == FT.LEARN_LANES_MAX
    assert (g.rm, g.rn) in FM.QNET_TILES
    # Both weight buffers start 16-byte aligned and hold a whole k-row of
    # every layer, the dz1 layer's (h2 -> h1) included.
    assert g.chunk * elem % 16 == 0 and g.chunk >= max(dims[1:])
    assert g.smem == _layout(dims, g.lanes, g.chunk, elem)
    assert g.smem <= kernels.SMEM_LIMIT


def test_a_net_that_does_not_fit_is_refused():
    dims = (10, 60000, 100, 5)  # 2 rows of h1 alone exceed a block
    assert FT.learn_tiling(dims, 1, 4) is None
    with pytest.raises(ValueError, match="does not fit"):
        FT.learn_geometry(128, dims, 4, SMS)


def _pad4(n):
    return (n + 3) // 4 * 4


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("net", list(NETS))
def test_workspace_is_sized_from_the_widths(net, bf16):
    d_in, h1, h2, a = dims = NETS[net]
    # x, h1, h2, dq with diff^2, dz2, dz1 (each group padded to 16 bytes);
    # bf16 adds dq, dz2, dz1 rounded.
    groups = [d_in, h1, h2, a + 1, h2, h1] + ([a, h2, h1] if bf16 else [])
    want = sum(_pad4(n) for n in groups)
    assert FT.workspace_width(dims, bf16) == want
    if dims == K5_NET and not bf16:
        # 1,024 rows of 620 floats: 2.5 MB, which stays in the L2 cache.
        assert want == 620 and 1024 * want * 4 == 2539520


@pytest.mark.parametrize("net", list(NETS))
def test_gradient_kernel_fits_shared_memory(net):
    for elem in (4, 2):
        tile = FT.learn_tile(NETS[net], elem)
        # Two buffers of 16 tiles of lanes x 16 columns of both factors,
        # and the 16 tiles' partial sums of 16 x 16 entries (dqn_trainer.cu:
        # grad_smem).
        want = (2 * 2 * 16 * tile * 16 + 16 * 16 * 16) * 4
        assert FT.grad_smem(tile) == want <= kernels.SMEM_LIMIT


def test_learn_tile_below_16_at_a_wide_net():
    assert FT.learn_tile(WIDE, 4) == 8
    assert FT.learn_tile(K5_NET, 4) == FT.learn_tile(K5_NET, 2) == 16


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        elif isinstance(a[k], tuple):
            for x, y in zip(a[k], b[k]):
                assert torch.equal(x, y), k
        else:
            assert a[k] == b[k], k


def test_dqn_chunk_on_cpu_is_the_plain_version():
    cfg = D.DQNConfig(lr=1e-3, target_sync=2, memory_capacity=256,
                      opponent="selfplay")
    ep = EnvParams(max_steps=40)
    carry = FT.fused_dqn_init(0, cfg, ep, 128, device=CPU)
    got = FT.fused_dqn_chunk(cfg, ep, carry, 4, 3, greedy=True)
    want = FT.fused_dqn_chunk_plain(cfg, ep, carry, 4, 3, greedy=True)
    assert got["learns"] == 3
    _same(got, want)


def test_hdqn_chunk_on_cpu_is_the_plain_version():
    cfg = H.HDQNConfig(lr=1e-3, target_sync=2, memory_capacity=256,
                       goal_memory_capacity=256)
    ep = EnvParams(max_steps=40)
    carry = FH.fused_hdqn_init(0, cfg, ep, 128, device=CPU)
    got = FH.fused_hdqn_chunk(cfg, ep, carry, 3, 5, greedy=True)
    want = FH.fused_hdqn_chunk_plain(cfg, ep, carry, 3, 5, greedy=True)
    assert got["lo_learns"] == 2
    _same(got, want)


def test_learner_refuses_cpu_tensors():
    cfg = D.DQNConfig(memory_capacity=256)
    carry = FT.fused_dqn_init(0, cfg, EnvParams(), 128, device=CPU)
    st = FT.working_state(carry, torch.float32)
    libs = dict(kernels._libs)
    with pytest.raises(ValueError, match="CUDA"):
        FT.Learner(st, "", K5_NET, 128, 1, cfg, CPU)
    assert kernels._libs == libs  # nothing was built or loaded
