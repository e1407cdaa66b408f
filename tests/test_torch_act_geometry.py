"""The act kernels' launch geometry (``ops.fused_trainer.act_geometry``) of
K5 (``dqn_trainer.cu``) and K7 (``hdqn_trainer.cu``) on an H100's 132 SMs,
without a card.

Every env lies in exactly one block and owns one of its threads, the
blocks fill the card at the training CLI's 1,024 envs (8 envs a block,
128 blocks), the micro-tile is one the kernels instantiate, the nets are
held in shared memory as far as they fit beside the tiles and stream
through two 16-byte aligned buffers otherwise (and always for a frozen
opponent), and the Python mirror of the kernels' layout
(``act_tiled.cuh:ActSmem``) fits the 232,448 B of a block.
"""

import os
import re

import pytest

from merging_gym_tpu_torch import kernels
from merging_gym_tpu_torch.ops import fused_hdqn as FH
from merging_gym_tpu_torch.ops import fused_mlp as FM
from merging_gym_tpu_torch.ops import fused_trainer as FT
from tests.torch_threads import one_torch_thread  # noqa: F401

SMS = 132
THREADS = 256  # qnet_tiled.cuh:kQnetThreads
ENVS = (1, 200, 256, 1000, 1024, 1025, 4096)
# The nets each kernel holds, in its order, at the CLI's widths and at
# --hidden 1024 512 (too wide to stay in shared memory).
NETS = {
    ("K5", "ref"): ((10, 200, 100, 5),),
    ("K5", "wide"): ((10, 1024, 512, 5),),
    ("K7", "ref"): ((10, 200, 100, 3), (11, 200, 100, 5)),
    ("K7", "wide"): ((10, 1024, 512, 3), (11, 1024, 512, 5)),
}
OPPONENTS = (FT.OPP_L0, FT.OPP_SELFPLAY, FT.OPP_FROZEN)


def _align16(n):
    return (n + 15) // 16 * 16


def _stride(k):  # qnet_tiled.cuh:act_stride
    return (k + 3) // 4 * 4 + 4


def _net_bytes(d, elem):
    """qnet_tiled.cuh:NetSmem as written there: w0, b0, w1, b1, w2, b2,
    each 16-byte aligned."""
    d_in, h1, h2, a = d
    n = 0
    for count in (d_in * h1, h1, h1 * h2, h2, h2 * a, a):
        n += _align16(count * elem)
    return n


def _layout(nets, rows, elem, resident, chunk, seats):
    """act_tiled.cuh:ActSmem as written there, transcribed field by field:
    (byte offsets of the held nets, buf, in, h1, h2, q), total."""
    prows = seats * rows
    held, buf = [], 0
    m = [0, 0, 0, 0]
    for i, d in enumerate(nets):
        if i < resident:
            held.append(buf)
            buf += _net_bytes(d, elem)
        m = [max(x, y) for x, y in zip(m, d)]
    in_ = buf + (_align16(2 * chunk * elem) if chunk > 0 else 0)
    h1 = in_ + _align16(prows * _stride(m[0]) * elem)
    h2 = h1 + _align16(prows * _stride(m[1]) * elem)
    q = h2 + _align16(prows * _stride(m[2]) * elem)
    total = q + prows * m[3] * 4
    return held + [buf, in_, h1, h2, q], total


def _top(envs):
    rows = 1
    while rows < FT.ACT_ROWS_MAX and -(-envs // rows) > SMS:
        rows *= 2
    return rows


def _tiles_of(source):
    """The (RM, RN) that qnet_tiled.cuh's MGT_QNET_TILES instantiates."""
    with open(os.path.join(kernels.CSRC, source)) as f:
        text = f.read()
    macro = re.search(r"#define MGT_QNET_TILES\(X\) \\\n(.*)\n", text)
    return {(int(a), int(b))
            for a, b in re.findall(r"X\((\d+), (\d+)\)", macro.group(1))}


def _fits(nets, rows, elem, held, seats, frozen):
    """Whether ``held`` nets fit the block beside the tiles, with buffers
    of at least one k-row of every layer where a net streams."""
    streams = frozen or held < len(nets)
    smem = FT.act_smem(nets, rows, elem, held, 0, seats)
    if not streams:
        return smem <= kernels.SMEM_LIMIT
    widest = max(max(d[1:]) for d in nets)
    room = kernels.SMEM_LIMIT - smem  # buffers of 8k elements: 16-byte sized
    return room // (2 * elem) // 8 * 8 >= widest


@pytest.mark.parametrize("opponent", OPPONENTS)
@pytest.mark.parametrize("elem", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("net", list(NETS), ids=lambda k: "_".join(k))
@pytest.mark.parametrize("envs", ENVS)
def test_geometry_covers_every_env_and_fits_a_block(envs, net, elem,
                                                    opponent):
    nets = NETS[net]
    seats, frozen = FT.act_seats(opponent)
    g = FT.act_geometry(envs, nets, elem, SMS, seats, frozen)
    # The smallest power of two of envs a block (at most 32) whose blocks
    # do not outnumber the SMs, halved only while nothing fits.
    assert g.rows & (g.rows - 1) == 0 and g.rows <= _top(envs)
    if g.rows < _top(envs):
        assert FT.act_tiling(nets, 2 * g.rows, elem, seats, frozen) is None
    blocks = -(-envs // g.rows)  # the kernels' grid
    assert blocks <= SMS or g.rows in (FT.ACT_ROWS_MAX, _top(envs) // 2)
    # Env i is thread i % rows of block i // rows: each env in one block,
    # owned by one of the block's first rows <= 32 of its 256 threads.
    assert (blocks - 1) * g.rows < envs <= blocks * g.rows
    assert g.rows <= FT.ACT_ROWS_MAX < THREADS
    owners = {(i // g.rows, i % g.rows) for i in range(envs)}
    assert len(owners) == envs
    assert (g.rm, g.rn) in _tiles_of("qnet_tiled.cuh")
    assert (g.rm, g.rn) == FM.micro_tile(
        tuple(max(d[i] for d in nets) for i in range(4)), seats * g.rows,
        FT.ACT_MIN_TILES)
    # Held as far as they fit, in the kernel's order; the rest stream.
    assert 0 <= g.resident <= len(nets)
    assert _fits(nets, g.rows, elem, g.resident, seats, frozen)
    if g.resident < len(nets):
        assert not _fits(nets, g.rows, elem, g.resident + 1, seats, frozen)
    streams = frozen or g.resident < len(nets)
    assert (g.chunk > 0) == streams
    if streams:  # two buffers, each a k-row of every layer at least
        assert g.chunk >= max(max(d[1:]) for d in nets)
        largest = max(k * j for d in nets for k, j in zip(d[:3], d[1:]))
        assert g.chunk < largest + 8
        assert g.chunk * elem % 16 == 0  # the second buffer's start
    offsets, total = _layout(nets, g.rows, elem, g.resident, g.chunk, seats)
    assert g.smem == total == FT.act_smem(nets, g.rows, elem, g.resident,
                                          g.chunk, seats)
    assert g.smem <= kernels.SMEM_LIMIT == 232448
    assert all(o % 16 == 0 for o in offsets)  # cp.async destinations


@pytest.mark.parametrize("trainer", ["K5", "K7"])
@pytest.mark.parametrize("elem", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("opponent", OPPONENTS)
def test_cli_envs_fill_the_card(trainer, elem, opponent):
    """At the training CLI's 1,024 envs: 8 envs a block in 128 blocks,
    the reference nets held in shared memory."""
    nets = NETS[(trainer, "ref")]
    g = FT.act_geometry(1024, nets, elem, SMS, *FT.act_seats(opponent))
    assert (g.rows, -(-1024 // g.rows)) == (8, 128)
    assert g.resident == len(nets)
    assert (g.chunk > 0) == (opponent == FT.OPP_FROZEN)


def test_cli_layouts_in_bytes():
    """K5 against L0 in f32: the 91,232 B net, then the input (8 rows of
    16 floats), h1 (204), h2 (104) and q (5) tiles; K7 holds its 90,416 B
    upper and 92,032 B lower net before the same tiles (the lower net's 5
    actions are the widest q)."""
    k5 = FT.act_geometry(1024, NETS[("K5", "ref")], 4, SMS)
    assert k5.smem == 91232 + 512 + 6528 + 3328 + 160 == 101760
    k7 = FT.act_geometry(1024, NETS[("K7", "ref")], 4, SMS)
    assert k7.smem == 90416 + 92032 + 512 + 6528 + 3328 + 160 == 192976
    # Self-play: one pass of 16 rows through the same nets.
    k7s = FT.act_geometry(1024, NETS[("K7", "ref")], 4, SMS, 2)
    assert k7s.smem == 90416 + 92032 + 1024 + 13056 + 6656 + 320


@pytest.mark.parametrize("envs,rows", [(1, 1), (132, 1), (133, 2), (256, 2),
                                       (1000, 8), (1024, 8), (1025, 8),
                                       (1057, 16), (4096, 32), (16384, 32)])
def test_rows_per_block(envs, rows):
    assert FT.act_geometry(envs, NETS[("K5", "ref")], 4, SMS).rows == rows
    assert FT.act_geometry(envs, NETS[("K7", "ref")], 4, SMS).rows == rows


def test_wide_nets_stream():
    for trainer in ("K5", "K7"):
        nets = NETS[(trainer, "wide")]
        g = FT.act_geometry(1024, nets, 4, SMS)
        assert g.resident == 0 and g.chunk >= 1024 and g.rows == 8
        assert all(FT.net_smem(d, 4) > kernels.SMEM_LIMIT for d in nets)


def test_forced_resident_count():
    """``act_tiling(resident=...)`` gives the streamed layouts that
    chip_smoke.py's act_geometry_sweep times beside the picked one."""
    nets = NETS[("K7", "ref")]
    for held in (0, 1, 2):
        g = FT.act_tiling(nets, 8, 4, resident=held)
        assert g.resident == held and (g.chunk > 0) == (held < 2)
        assert g.smem == _layout(nets, 8, 4, held, g.chunk, 1)[1]


def test_nets_too_wide_for_one_env_raise():
    huge = ((10, 40000, 30000, 5),)
    assert FT.act_tiling(huge, 1, 4) is None
    with pytest.raises(ValueError, match="do not fit"):
        FT.act_geometry(4, huge, 4, SMS)


def test_kernel_constants_match():
    """Both act kernels instantiate every micro-tile of ``QNET_TILES``,
    run their forwards on act_tiled.cuh (none calls mlp.cuh's mlp_tile),
    cap the envs a block at ``ACT_ROWS_MAX`` and number the opponents as
    ``OPP_MODES``; K7's fixed tile is gone."""
    assert _tiles_of("qnet_tiled.cuh") == set(FM.QNET_TILES)
    with open(os.path.join(kernels.CSRC, "act_tiled.cuh")) as f:
        header = f.read()
    cap = re.search(r"constexpr int kActRowsMax = (\d+);", header)
    assert int(cap.group(1)) == FT.ACT_ROWS_MAX
    modes = re.search(r"constexpr int kOppL0 = (\d+), kOppSelf = (\d+), "
                      r"kOppFrozen = (\d+);", header)
    assert tuple(map(int, modes.groups())) == tuple(FT.OPP_MODES[o] for o in (
        FT.OPP_L0, FT.OPP_SELFPLAY, FT.OPP_FROZEN))
    for source in ("dqn_trainer.cu", "hdqn_trainer.cu"):
        with open(os.path.join(kernels.CSRC, source)) as f:
            text = f.read()
        assert '#include "act_tiled.cuh"' in text
        assert "MGT_QNET_TILES(MGT_CASE)" in text
        assert "mlp_tile" not in text
    assert not hasattr(FH, "K7_TILE")
