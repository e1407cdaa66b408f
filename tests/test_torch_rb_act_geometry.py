"""The launch geometry of K8's act kernel (``ops.fused_rainbow.
act_geometry``, ``rainbow_trainer.cu:rb_act_kernel``) on an H100's 132 SMs,
without a card.

Every env lies in exactly one block and owns one of its threads, the
blocks fill the card at the training CLI's 1,024 envs (8 envs a block, 128
blocks), the micro-tile is one the kernel instantiates, the online net is
held in shared memory where it fits beside the arrays (and read from
global memory otherwise), a frozen opponent's MLP streams through two
16-byte sized buffers, and the Python mirror of the kernel's layout
(``RbActSmem``) fits the 232,448 B of a block.
"""

import os
import re

import pytest

from merging_gym_tpu_torch import kernels
from merging_gym_tpu_torch.ops import fused_mlp as FM
from merging_gym_tpu_torch.ops import fused_rainbow as FRB
from merging_gym_tpu_torch.ops import fused_trainer as FT
from tests.torch_threads import one_torch_thread  # noqa: F401

SMS = 132
THREADS = 256  # qnet_tiled.cuh:kQnetThreads
ENVS = (1, 200, 1000, 1024, 1025, 4096)
# (seats, a frozen opponent's widths) of each opponent mode: the CLI's
# reference MLP, and one too wide for the ego's net to stay beside it.
OPPONENTS = {"L0": (1, None), "selfplay": (2, None),
             "frozen": (1, (10, 200, 100, 5)),
             "frozen_wide": (1, (10, 1024, 512, 5))}


def _align16(n):
    return (n + 15) // 16 * 16


def _stride(k):  # qnet_tiled.cuh:act_stride
    return (k + 3) // 4 * 4 + 4


def _source(name):
    with open(os.path.join(kernels.CSRC, name)) as f:
        return f.read()


def _mlp_layout(d, rows, chunk):
    """act_tiled.cuh:ActSmem of one streamed MLP, transcribed field by
    field: (buf, in, h1, h2, q), total."""
    in_ = _align16(2 * chunk * 4)
    h1 = in_ + _align16(rows * _stride(d[0]) * 4)
    h2 = h1 + _align16(rows * _stride(d[1]) * 4)
    q = h2 + _align16(rows * _stride(d[2]) * 4)
    return (0, in_, h1, h2, q), q + rows * d[3] * 4


def _layout(rows, seats, resident, od, chunk):
    """rainbow_trainer.cu:RbActSmem as written there: (byte offsets of the
    net, the arrays and the MLP's region, then the MLP's offsets), total."""
    tiles = _align16(FRB.NUM_G * 4) if resident else 0
    mlp = tiles + seats * rows * 836 * 4
    if od is None:
        return (0, tiles, mlp), mlp
    offsets, total = _mlp_layout(od, rows, chunk)
    return (0, tiles, mlp) + tuple(mlp + o for o in offsets), mlp + total


def _top(envs):
    rows = 1
    while rows < FT.ACT_ROWS_MAX and -(-envs // rows) > SMS:
        rows *= 2
    return rows


def _tiles():
    """The (RM, RN) that qnet_tiled.cuh's MGT_QNET_TILES instantiates."""
    macro = re.search(r"#define MGT_QNET_TILES\(X\) \\\n(.*)\n",
                      _source("qnet_tiled.cuh"))
    return {(int(a), int(b))
            for a, b in re.findall(r"X\((\d+), (\d+)\)", macro.group(1))}


@pytest.mark.parametrize("opponent", list(OPPONENTS))
@pytest.mark.parametrize("envs", ENVS)
def test_geometry_covers_every_env_and_fits_a_block(envs, opponent):
    seats, od = OPPONENTS[opponent]
    g = FRB.act_geometry(envs, SMS, seats, od)
    # The smallest power of two of envs a block (at most 32) whose blocks
    # do not outnumber the SMs, halved only while nothing fits.
    assert g.rows & (g.rows - 1) == 0 and g.rows <= _top(envs)
    if g.rows < _top(envs):
        assert FRB.act_tiling(2 * g.rows, seats, od) is None
    blocks = -(-envs // g.rows)  # the kernel's grid
    assert blocks <= SMS or g.rows < _top(envs) or g.rows == FT.ACT_ROWS_MAX
    # Env i is thread i % rows of block i // rows: each env in one block,
    # owned by one of the block's first rows <= 32 of its 256 threads.
    assert (blocks - 1) * g.rows < envs <= blocks * g.rows
    assert g.rows <= FT.ACT_ROWS_MAX < THREADS
    owners = {(i // g.rows, i % g.rows) for i in range(envs)}
    assert len(owners) == envs
    assert (g.rm, g.rn) in _tiles()
    assert (g.rm, g.rn) == FRB.act_micro_tile(seats * g.rows)
    # The net held where it fits; a frozen opponent's MLP always streams,
    # through buffers of whole 16-byte units that hold a k-row of every
    # layer and no more than its largest layer.
    assert g.resident in (0, 1)
    if g.resident == 0:
        assert FRB.act_tiling(g.rows, seats, od, resident=1) is None
    assert (g.chunk > 0) == (od is not None)
    if od is not None:
        assert g.chunk >= max(od[1:]) and g.chunk * 4 % 16 == 0
        assert g.chunk < max(k * j for k, j in zip(od[:3], od[1:])) + 8
    offsets, total = _layout(g.rows, seats, g.resident, od, g.chunk)
    assert g.smem == total == FRB.act_smem(g.rows, seats, g.resident, od,
                                           g.chunk)
    assert g.smem <= kernels.SMEM_LIMIT == 232448
    assert all(o % 16 == 0 for o in offsets)  # cp.async destinations


@pytest.mark.parametrize("opponent", ["L0", "selfplay", "frozen"])
def test_cli_envs_fill_the_card(opponent):
    """At the training CLI's 1,024 envs: 8 envs a block in 128 blocks, the
    online net held in shared memory."""
    g = FRB.act_geometry(1024, SMS, *OPPONENTS[opponent])
    assert (g.rows, -(-1024 // g.rows), g.resident) == (8, 128, 1)


def test_cli_layouts_in_bytes():
    """Against L0: the 122,704 B net (30,674 floats), then 8 rows of 836
    floats; self-play 16 rows; a frozen L1-sized MLP's two buffers of 9,056
    floats, its input (8 x 16), h1 (204) and h2 (104) tiles and q (5)."""
    assert FRB.act_geometry(1024, SMS).smem == 122704 + 26752 == 149456
    assert FRB.act_geometry(1024, SMS, 2).smem == 122704 + 53504
    g = FRB.act_geometry(1024, SMS, 1, (10, 200, 100, 5))
    assert g.chunk == 9056
    assert g.smem == 149456 + 72448 + 512 + 6528 + 3328 + 160 == 232432


@pytest.mark.parametrize("envs,rows", [(1, 1), (132, 1), (133, 2), (256, 2),
                                       (1000, 8), (1024, 8), (1025, 8),
                                       (1057, 16), (4096, 32)])
def test_rows_per_block(envs, rows):
    assert FRB.act_geometry(envs, SMS).rows == rows
    assert FRB.act_geometry(envs, SMS, 1, (10, 200, 100, 5)).rows == rows


def test_wide_layouts_read_the_net_from_global_memory():
    """Self-play at 32 envs a block (64 rows of arrays) and an L1-sized
    frozen MLP at 32 leave no room for the 122,704 B net; at 16 and 8 it
    stays."""
    assert FRB.act_geometry(4096, SMS, 2).resident == 0
    assert FRB.act_geometry(4096, SMS, 1, (10, 200, 100, 5)).resident == 0
    assert FRB.act_geometry(4096, SMS).resident == 1
    assert FRB.act_tiling(16, 2).resident == 1
    assert FRB.act_tiling(8, 1, (10, 1024, 512, 5)).resident == 1


def test_forced_resident():
    """``act_tiling(resident=0)`` gives the layout that chip_smoke.py's
    act sweep times beside the picked one: the arrays alone."""
    g = FRB.act_tiling(8, resident=0)
    assert (g.resident, g.chunk, g.smem) == (0, 0, 26752)
    assert FRB.act_tiling(8, resident=1).smem == 149456


def test_frozen_opponents_too_wide_raise():
    huge = (10, 40000, 30000, 5)
    assert FRB.act_tiling(1, 1, huge) is None
    with pytest.raises(ValueError, match="does not fit"):
        FRB.act_geometry(4, SMS, 1, huge)


def test_micro_tile_rule():
    """The first micro-tile that gives value2 and advantage2 (51 + 255
    columns) two tiles a thread: 2x1 at 4 rows, 4x1 at 8, 4x2 at 16, 8x2
    at 32 (the fastest of chip_smoke.py's sweep at 4, 8 and 32 envs a
    block, within 1% of it at 16); the most tiles where none gives that
    many."""
    assert [FRB.act_micro_tile(r) for r in (4, 8, 16, 32)] == [
        (2, 1), (4, 1), (4, 2), (8, 2)]
    assert FRB.act_micro_tile(1) == (1, 1)


def test_kernel_constants_match():
    """rb_act_kernel's layout constants equal the Python mirror, it runs on
    qnet_tiled.cuh's micro-tiles through act_tiled.cuh with every tile of
    QNET_TILES, and the scalar forward it replaced is gone."""
    text = _source("rainbow_trainer.cu")
    consts = dict(re.findall(r"\b(kA\w+|kActRowFloats|kSh3) = (\d+)",
                             text))
    assert int(consts["kActRowFloats"]) == FRB.ACT_ROW_FLOATS == 836
    strides = dict(re.findall(r"\b(kS\w+) = (\d+)", text))
    widths = [int(strides[k]) for k in ("kSx", "kSh1", "kSh", "kSh3", "kSv",
                                        "kSa")]
    assert widths == [_stride(10), _stride(32), _stride(64), _stride(128),
                      _stride(51), 5 * 52]
    assert int(strides["kS51"]) == 52
    offsets = [int(consts[k]) for k in ("kAx", "kAh1", "kAh2", "kAh3",
                                         "kAzv", "kAza", "kAdist", "kAq")]
    assert offsets == [0, 16, 52, 120, 252, 308, 568, 828]
    assert offsets[-1] + 8 == FRB.ACT_ROW_FLOATS
    assert re.search(r"kCopySplit = eoff\(3\);  // 11,635", text)
    assert FRB.E_OFF[3] == 11635
    assert FRB.ACT_NET_BYTES == _align16(FRB.NUM_G * 4) == 122704
    assert '#include "act_tiled.cuh"' in text
    assert "MGT_QNET_TILES(MGT_CASE)" in text
    assert _tiles() == set(FM.QNET_TILES)
    for gone in ("rb_forward", "dense_out", "RbFwd", "mlp_tile"):
        assert gone not in text, gone
    mlp = _source("mlp.cuh")
    assert "mlp_tile" not in mlp and "void dense(" not in mlp
    assert not hasattr(FRB, "ACT_TILE")
