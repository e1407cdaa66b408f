"""K3's and K4's launch geometry (``ops.fused_mlp.qnet_geometry``) on an
H100's 132 SMs, without a card.

At the main paths' batches about one block runs on each SM (more than
half of them get one, none gets two unless the rows per block are at
their cap or twice the rows would not fit), every row lies in exactly one
block, the micro-tile is one the kernels instantiate, both weight buffers
start 16-byte aligned, and the block's shared memory stays within
``kernels.SMEM_LIMIT``, at the reference widths and at odd ones.
"""

import os
import re

import pytest

from merging_gym_tpu_torch import kernels
from merging_gym_tpu_torch.ops import fused_mlp as FM

SMS = 132
ZOO, META, LOW = (10, 200, 100, 5), (10, 200, 100, 3), (11, 200, 100, 5)
WIDE = (10, 2048, 1024, 5)  # tests/test_torch_cuda.py's wide net
ODD = (10, 150, 75, 5)  # no layer a multiple of 8 elements
MAIN = (256, 1024, 4096)
CASES = ([(b, w) for w in (ZOO, META, LOW, WIDE, ODD) for b in MAIN]
         + [(b, ZOO) for b in (1, 33, 77, 1001, 1025)] + [(70, WIDE)])


@pytest.mark.parametrize("elem", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["k3", "k4"])
@pytest.mark.parametrize("batch,widths", CASES)
def test_geometry_fills_the_card_and_covers_every_row(batch, widths, elem,
                                                      kernel):
    q = widths[3] if kernel == "k4" else 0
    g = FM.qnet_geometry(batch, widths, elem, SMS, q_per_row=q)
    blocks = -(-batch // g.rows)  # the kernels' grid
    if batch <= SMS:
        assert g.rows == 1 and blocks == batch
    elif blocks > SMS:  # rows at their cap, or twice as many do not fit
        assert (g.rows == FM.QNET_ROWS_MAX
                or FM.qnet_tiling(widths, 2 * g.rows, elem, q) is None)
    else:
        assert SMS // 2 < blocks
    # Block i owns rows [i * rows, min(B, (i + 1) * rows)): a partition.
    assert (blocks - 1) * g.rows < batch <= blocks * g.rows
    assert g.rows & (g.rows - 1) == 0 and g.rows <= FM.QNET_ROWS_MAX
    assert (g.rm, g.rn) in FM.QNET_TILES and g.rm <= g.rows
    layers = tuple(zip(widths[:3], widths[1:]))
    largest = max(k * j for k, j in layers)
    assert max(j for _, j in layers) <= g.chunk < largest + 8
    # The second buffer starts at chunk * elem bytes: cp.async.cg needs 16.
    assert g.chunk * elem % 16 == 0
    assert g.smem == FM.qnet_smem(widths, g.rows, g.chunk, elem, q)
    assert g.smem <= kernels.SMEM_LIMIT


@pytest.mark.parametrize("widths", [ZOO, META, LOW])
def test_main_path_batches_get_wider_tiles_as_the_batch_grows(widths):
    gs = [FM.qnet_geometry(b, widths, 4, SMS) for b in MAIN]
    assert [g.rows for g in gs] == sorted(g.rows for g in gs)
    assert gs[-1].rm * gs[-1].rn > gs[0].rm * gs[0].rn
    # The largest layer (h1 -> h2) keeps at least 3 warps of tiles busy.
    for g in gs:
        assert -(-g.rows // g.rm) * -(-widths[2] // g.rn) >= FM.QNET_MIN_TILES


def test_wide_layers_stream_in_chunks():
    g = FM.qnet_geometry(70, WIDE, 4, SMS)
    assert g.rows == 1
    assert g.chunk < WIDE[1] * WIDE[2]  # w1 (8 MB) does not fit: chunked


def test_a_net_too_wide_for_one_row_raises():
    with pytest.raises(ValueError, match="does not fit"):
        FM.qnet_geometry(4, (10, 40000, 30000, 5), 4, SMS)


def test_tiles_are_the_ones_the_kernels_instantiate():
    src = os.path.join(kernels.CSRC, "qnet_tiled.cuh")
    with open(src) as f:
        text = f.read()
    body = re.search(r"#define MGT_QNET_TILES\(X\)(.*?)\n\n", text, re.S)
    tiles = {(int(m), int(n)) for m, n in
             re.findall(r"X\((\d+), (\d+)\)", body.group(1))}
    assert tiles == set(FM.QNET_TILES)
