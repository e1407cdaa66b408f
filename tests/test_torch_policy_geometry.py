"""K6's launch geometry (``ops.fused_policy_rollout.policy_geometry``) on
an H100's 132 SMs, without a card.

Every env lies in exactly one block and owns one of its threads, the
blocks fill the card at the CLI's 4,096 envs (32 envs a block, 128
blocks), the micro-tile is one the kernel instantiates, both nets stay
resident in shared memory where they fit and stream through two 16-byte
aligned buffers where they do not (``--hidden 1024 512``), and the Python
mirror of the kernel's layout (``policy_rollout.cu:PolicySmem``) fits the
232,448 B of a block.
"""

import os
import re

import pytest

from merging_gym_tpu_torch import kernels
from merging_gym_tpu_torch.ops import fused_mlp as FM
from merging_gym_tpu_torch.ops import fused_policy_rollout as FPR
from tests.torch_threads import one_torch_thread  # noqa: F401

SMS = 132
REF = (10, 200, 100, 5)    # model_zoo's nets, the CLI's default widths
ODD = (10, 150, 75, 5)     # no layer a multiple of 8 elements
WIDE = (10, 1024, 512, 5)  # --hidden 1024 512: too wide to stay resident
ENVS = (128, 200, 256, 4096, 4097)


def _align16(n):
    return (n + 15) // 16 * 16


def _layout(widths, rows, elem, nets, resident, chunk):
    """policy_rollout.cu:PolicySmem and qnet_tiled.cuh:NetSmem as written
    there, transcribed field by field: (byte offsets, total)."""
    d_in, h1, h2, a = widths
    stride = [(k + 3) // 4 * 4 + 4 for k in (d_in, h1, h2)]
    net = [0]
    for n in (d_in * h1, h1, h1 * h2, h2, h2 * a, a):
        net.append(net[-1] + _align16(n * elem))
    in_tile = _align16(rows * stride[0] * elem)
    in1 = nets * net[-1] if resident else _align16(2 * chunk * elem)
    in2 = in1 + in_tile
    h1_ = in2 + (in_tile if nets == 2 else 0)
    h2_ = h1_ + _align16(rows * stride[1] * elem)
    q1 = h2_ + _align16(rows * stride[2] * elem)
    q2 = q1 + _align16(rows * a * 4)
    total = q2 + (rows * a * 4 if nets == 2 else 0)
    offsets = [o + i * net[-1] for i in range(nets if resident else 0)
               for o in net[:-1]]
    return offsets + [in1, in2, h1_, h2_, q1], total


def _top(envs):
    rows = 1
    while rows < FPR.K6_ROWS_MAX and -(-envs // rows) > SMS:
        rows *= 2
    return rows


@pytest.mark.parametrize("two_nets", [True, False], ids=["two_nets", "L0"])
@pytest.mark.parametrize("elem", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("widths", [REF, ODD, WIDE],
                         ids=["ref", "odd", "wide"])
@pytest.mark.parametrize("envs", ENVS)
def test_geometry_covers_every_env_and_fits_a_block(envs, widths, elem,
                                                    two_nets):
    g = FPR.policy_geometry(envs, widths, elem, SMS, two_nets)
    nets = 2 if two_nets else 1
    # The smallest power of two of envs a block (at most 32) whose blocks
    # do not outnumber the SMs: every layout here fits at that size.
    assert g.rows == _top(envs)
    blocks = -(-envs // g.rows)  # the kernel's grid
    assert blocks <= SMS or g.rows == FPR.K6_ROWS_MAX
    assert (blocks - 1) * g.rows < envs <= blocks * g.rows
    assert (g.rm, g.rn) in FM.QNET_TILES and g.rm <= g.rows
    offsets, total = _layout(widths, g.rows, elem, nets, g.resident, g.chunk)
    assert g.smem == total == FPR.policy_smem(widths, g.rows, elem, nets,
                                              g.resident, g.chunk)
    assert g.smem <= kernels.SMEM_LIMIT == 232448
    assert all(o % 16 == 0 for o in offsets)  # cp.async destinations
    resident_bytes = FPR.policy_smem(widths, g.rows, elem, nets, True)
    assert g.resident == (resident_bytes <= kernels.SMEM_LIMIT)
    if g.resident:
        assert g.chunk == 0
    else:  # two buffers, each a k-row of the widest layer at least
        assert max(widths[1:]) <= g.chunk
        largest = max(k * j for k, j in zip(widths[:3], widths[1:]))
        assert g.chunk < largest + 8
        assert g.chunk * elem % 16 == 0  # the second buffer's start


@pytest.mark.parametrize("elem", [4, 2], ids=["f32", "bf16"])
def test_reference_nets_stay_resident_at_the_cli_envs(elem):
    """At the CLI's 4,096 envs: 32 envs a block in 128 blocks, both nets
    in shared memory; f32 takes 227,264 of the 232,448 B: 2 x 91,232 B of
    weights, 2 x 2,048 of input tiles, 26,112 of h1, 13,312 of h2 and
    2 x 640 of q."""
    g = FPR.policy_geometry(4096, REF, elem, SMS, True)
    assert (g.rows, g.resident, -(-4096 // g.rows)) == (32, True, 128)
    assert FPR.net_smem(REF, 4) == 91232
    if elem == 4:
        assert g.smem == 2 * 91232 + 2 * 2048 + 26112 + 13312 + 2 * 640
        assert g.smem == 227264
    one = FPR.policy_geometry(4096, REF, elem, SMS, False)
    assert one.resident and one.smem < g.smem


@pytest.mark.parametrize("envs,rows", [(128, 1), (200, 2), (256, 2),
                                       (4096, 32), (4097, 32), (264, 2),
                                       (265, 4), (16384, 32)])
def test_rows_per_block(envs, rows):
    g = FPR.policy_geometry(envs, REF, 4, SMS, True)
    assert g.rows == rows and g.resident


@pytest.mark.parametrize("elem", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("two_nets", [True, False], ids=["two_nets", "L0"])
def test_wide_nets_stream(elem, two_nets):
    g = FPR.policy_geometry(4096, WIDE, elem, SMS, two_nets)
    assert not g.resident and g.rows == 32
    assert FPR.net_smem(WIDE, elem) > kernels.SMEM_LIMIT
    assert g.smem <= kernels.SMEM_LIMIT and g.chunk >= WIDE[1]


def test_micro_tile_is_the_rule_of_the_sweep():
    """The micro-tile gives the largest layer (200 -> 100) at least
    ``K6_MIN_TILES`` tiles where one can (chip_smoke.py:k6_sweep times the
    others)."""
    for envs in (200, 4096):
        g = FPR.policy_geometry(envs, REF, 4, SMS, True)
        assert (g.rm, g.rn) == FM.micro_tile(REF, g.rows, FPR.K6_MIN_TILES)
        tiles = -(-g.rows // g.rm) * -(-REF[2] // g.rn)
        assert tiles >= FPR.K6_MIN_TILES


def test_a_net_too_wide_for_one_env_raises():
    assert FPR.policy_tiling((10, 40000, 30000, 5), 1, 4, 2) is None
    with pytest.raises(ValueError, match="does not fit"):
        FPR.policy_geometry(4, (10, 40000, 30000, 5), 4, SMS, True)


def test_kernel_constants_match():
    """The kernel instantiates every micro-tile of ``QNET_TILES`` and caps
    the envs a block at ``K6_ROWS_MAX``."""
    with open(os.path.join(kernels.CSRC, "policy_rollout.cu")) as f:
        text = f.read()
    assert "MGT_QNET_TILES(MGT_CASE)" in text
    cap = re.search(r"constexpr int kPolicyRowsMax = (\d+);", text)
    assert int(cap.group(1)) == FPR.K6_ROWS_MAX
