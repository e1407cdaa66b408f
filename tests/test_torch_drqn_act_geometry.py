"""The launch geometry of K9's act kernel (``ops.fused_drqn.act_geometry``,
``drqn_trainer.cu:act_kernel``) on an H100's 132 SMs, without a card.

Every env lies in exactly one block and owns one of its threads, the
blocks fill the card at the training CLI's 1,024 envs (8 envs a block, 128
blocks), the micro-tile is one the kernel instantiates, every net of the
launch (the player's, and a frozen opponent's) is held in shared memory,
and the Python mirror of the kernel's layout (``act_total``) fits the
232,448 B of a block.
"""

import os
import re

import pytest

from merging_gym_tpu_torch import kernels
from merging_gym_tpu_torch.ops import fused_drqn as FD
from merging_gym_tpu_torch.ops import fused_mlp as FM
from merging_gym_tpu_torch.ops import fused_trainer as FT
from tests.torch_threads import one_torch_thread  # noqa: F401

SMS = 132
THREADS = 256  # qnet_tiled.cuh:kQnetThreads
ENVS = (1, 200, 1000, 1024, 1025, 4096)
OPPONENTS = (FT.OPP_L0, FT.OPP_SELFPLAY, FT.OPP_FROZEN)
# The kernel's arrays a row, in order (name, floats): the obs, h and c
# before the step, relu(z1), x2, h w_hh, the gates, h and c after it,
# relu(z3), q.
ROW = (("x", 16), ("h", 20), ("c", 16), ("z1", 204), ("x2", 20),
       ("gh", 64), ("g", 64), ("hn", 20), ("cn", 16), ("h3", 20), ("q", 8))


def _align16(n):
    return (n + 15) // 16 * 16


def _source(name):
    with open(os.path.join(kernels.CSRC, name)) as f:
        return f.read()


def _layout(rows, seats, resident):
    """drqn_trainer.cu's act layout as written there: (byte offsets of the
    held nets and of each array), total."""
    net = _align16(FD.P * 4)
    offsets = [i * net for i in range(resident)]
    at = resident * net
    prows = seats * rows
    for _, floats in ROW:
        offsets.append(at)
        at += prows * floats * 4
    return offsets, at


def _top(envs):
    rows = 1
    while rows < FT.ACT_ROWS_MAX and -(-envs // rows) > SMS:
        rows *= 2
    return rows


def _tiles():
    macro = re.search(r"#define MGT_QNET_TILES\(X\) \\\n(.*)\n",
                      _source("qnet_tiled.cuh"))
    return {(int(a), int(b))
            for a, b in re.findall(r"X\((\d+), (\d+)\)", macro.group(1))}


@pytest.mark.parametrize("opponent", OPPONENTS)
@pytest.mark.parametrize("envs", ENVS)
def test_geometry_covers_every_env_and_fits_a_block(envs, opponent):
    seats, nets = FD.act_seats(opponent)
    g = FD.act_geometry(envs, SMS, seats, nets)
    # The smallest power of two of envs a block (at most 32) whose blocks
    # do not outnumber the SMs: every layout fits, so it is never halved.
    assert g.rows == _top(envs)
    blocks = -(-envs // g.rows)  # the kernel's grid
    assert blocks <= SMS or g.rows == FT.ACT_ROWS_MAX
    # Env i is thread i % rows of block i // rows: each env in one block,
    # owned by one of the block's first rows <= 32 of its 256 threads.
    assert (blocks - 1) * g.rows < envs <= blocks * g.rows
    assert g.rows <= FT.ACT_ROWS_MAX < THREADS
    owners = {(i // g.rows, i % g.rows) for i in range(envs)}
    assert len(owners) == envs
    assert (g.rm, g.rn) in _tiles()
    assert (g.rm, g.rn) == FD.act_micro_tile(seats * g.rows)
    assert (g.resident, g.chunk) == (nets, 0)  # every net held, none streams
    offsets, total = _layout(g.rows, seats, g.resident)
    assert g.smem == total == FD.act_smem(g.rows, seats, g.resident)
    assert g.smem <= kernels.SMEM_LIMIT == 232448
    assert all(o % 16 == 0 for o in offsets)  # cp.async and load4 rows


@pytest.mark.parametrize("opponent", OPPONENTS)
def test_cli_envs_fill_the_card(opponent):
    """At the training CLI's 1,024 envs: 8 envs a block in 128 blocks."""
    seats, nets = FD.act_seats(opponent)
    g = FD.act_geometry(1024, SMS, seats, nets)
    assert (g.rows, -(-1024 // g.rows), g.resident) == (8, 128, nets)


def test_seats_and_nets():
    """L0 plays no net for seat 2; self-play's seat 2 plays the live net in
    the same pass; a frozen opponent is a second net."""
    assert [FD.act_seats(o) for o in OPPONENTS] == [(1, 1), (2, 1), (2, 2)]


def test_cli_layouts_in_bytes():
    """The 31,808 B net (7,949 floats) then 8 rows of 468 floats (L0), 16
    (self-play), or two nets and 16 rows (frozen); the largest layout, a
    frozen opponent at 32 envs a block, takes 183,424 B."""
    assert FD.act_geometry(1024, SMS).smem == 31808 + 14976 == 46784
    assert FD.act_geometry(1024, SMS, 2, 1).smem == 31808 + 29952
    assert FD.act_geometry(1024, SMS, 2, 2).smem == 2 * 31808 + 29952
    assert FD.act_geometry(4096, SMS, 2, 2).smem == 183424


@pytest.mark.parametrize("envs,rows", [(1, 1), (132, 1), (133, 2), (256, 2),
                                       (1000, 8), (1024, 8), (1025, 8),
                                       (1057, 16), (4096, 32), (16384, 32)])
def test_rows_per_block(envs, rows):
    for opponent in OPPONENTS:
        assert FD.act_geometry(envs, SMS, *FD.act_seats(opponent)).rows == rows


def test_forced_resident_counts():
    """``act_tiling(resident=...)`` gives the layouts with fewer nets held
    (read from global memory) that chip_smoke.py's act sweep times."""
    for held in (0, 1, 2):
        g = FD.act_tiling(8, 2, 2, held)
        assert g.resident == held and g.smem == _layout(8, 2, held)[1]


def test_micro_tile_rule():
    """The first micro-tile that gives the gates (64 columns) one tile a
    thread: 2x1 at 8 rows, 4x1 at 16, 4x2 at 32, 8x2 at 64."""
    assert [FD.act_micro_tile(r) for r in (8, 16, 32, 64)] == [
        (2, 1), (4, 1), (4, 2), (8, 2)]
    assert FD.act_micro_tile(1) == (1, 1)


def test_kernel_constants_match():
    """act_kernel's layout constants equal the Python mirror, it runs on
    qnet_tiled.cuh's micro-tiles through act_tiled.cuh with every tile of
    QNET_TILES and the opponent codes of ``FT.OPP_MODES``, and the scalar
    forward it replaced is gone."""
    text = _source("drqn_trainer.cu")
    consts = dict(re.findall(r"\b(kA\w+|kActRowFloats) = (\d+)", text))
    names = ("kAx", "kAh", "kAc", "kAz1", "kAx2", "kAgh", "kAg", "kAhn",
             "kAcn", "kAh3", "kAq")
    at = 0
    for name, (_, floats) in zip(names, ROW):
        assert int(consts[name]) == at, name
        at += floats
    assert int(consts["kActRowFloats"]) == at == FD.ACT_ROW_FLOATS == 468
    assert FD.ACT_NET_BYTES == _align16(FD.P * 4) == 31808
    assert re.search(r"kNetBytes = \(kP \* sizeof\(float\) \+ 15\) / 16 \* "
                     r"16;  // 31,808", text)
    assert '#include "act_tiled.cuh"' in text
    assert "MGT_QNET_TILES(MGT_CASE)" in text
    assert _tiles() == set(FM.QNET_TILES)
    header = _source("act_tiled.cuh")
    modes = re.search(r"constexpr int kOppL0 = (\d+), kOppSelf = (\d+), "
                      r"kOppFrozen = (\d+);", header)
    assert tuple(map(int, modes.groups())) == tuple(
        FT.OPP_MODES[o] for o in OPPONENTS)
    for gone in ("kActTile", "cell_tile", "gate_pre", "dense<"):
        assert gone not in text, gone
