"""K9's DRQN learner on the CPU: its launch geometry on an H100's 132 SMs,
its shared-memory layouts and workspace, the order its kernels sum in, and
what the wrappers do with CPU tensors.

``ops.fused_drqn.learn_geometry`` must give the input side and the
recurrence at least one block per SM at B 1,024, fit every block's shared
memory, and refuse an L or a batch that does not fit.  The layouts are
recounted here from ``drqn_trainer.cu`` (``RecLayout``, ``grad_smem``,
``qnet_tiled.cuh:QnetSmem``) and its workspace columns read from the
source.  Two order checks run in plain torch: the gradient re-assembled in
the gradient kernel's grouping (rectangles of entries, a bias as the row
of ones beside its weight's first factor, 128 summation tiles in flight,
their partials added in tile order) equals ``_grads_plain`` bit for bit;
and the gates' input term taken ahead of the recurrence, then completed,
equals ``_gates``.
"""

import os
import re

import numpy as np
import pytest
import torch

from merging_gym_tpu_torch import kernels
from merging_gym_tpu_torch.agents import drqn as DR
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.ops import fused_drqn as FD
from tests.torch_threads import one_torch_thread  # noqa: F401

SMS = 132
CPU = torch.device("cpu")
HID, H1, A, G = FD.HID, FD.H1, FD.A, 4 * FD.HID
BATCHES = (1024, 4096, 4)
SOURCE = os.path.join(os.path.dirname(kernels.__file__), "csrc",
                      "drqn_trainer.cu")


def _a16(n):
    return (n + 15) // 16 * 16


def _stride(k):
    return (k + 3) // 4 * 4 + 4


def _in_smem(rows, chunk):
    """in_kernel: two weight buffers, then x, relu(z1) and x2 of the
    block's rows, each row padded to act_stride, then two ints a row (its
    workspace row and gx row)."""
    return _a16(2 * chunk * 4) + sum(_a16(rows * _stride(k) * 4)
                                     for k in (10, H1, HID)) + rows * 2 * 4


def _rec_smem(windows, L):
    """rec_kernel, region by region (RecLayout); the windows start on 16
    bytes."""
    T1 = L + 1
    shared = (2 * HID * HID + 2 * HID + 2 * HID * A + 2 * A + 2 * G
              + H1 * (HID + 1) + windows * L * HID)
    per = (G + L * G + L * HID + L * HID + 2 * T1 * HID + 2 * T1 * HID
           + 2 * T1 * A + 3 * L + L * A + L * HID + L * HID)
    return 4 * (-(-shared // 4) * 4 + windows * -(-per // 4) * 4)


@pytest.mark.parametrize("batch", BATCHES)
def test_geometry_fits_the_shared_memory_it_is_given(batch):
    L = 16
    g = FD.learn_geometry(batch, L, SMS)
    assert g.in_rows & (g.in_rows - 1) == 0 and g.in_rows <= FD.IN_ROWS_MAX
    assert g.in_chunk * 4 % 16 == 0 and g.in_chunk >= H1
    assert g.in_smem == _in_smem(g.in_rows, g.in_chunk) <= kernels.SMEM_LIMIT
    assert g.rec_windows in (1, 2, 4) and batch % g.rec_windows == 0
    assert g.rec_smem == _rec_smem(g.rec_windows, L) <= kernels.SMEM_LIMIT
    # One float a thread for each of its 16 entries' partial sums.
    assert g.grad_threads == 1024 and g.grad_smem == 16 * 4 * 1024


def test_input_side_and_recurrence_fill_a_wave_at_b1024():
    B, L = 1024, 16
    g = FD.learn_geometry(B, L, SMS)
    in_blocks = 2 * -(-B * (L + 1) // g.in_rows)      # both nets
    rec_blocks = B // g.rec_windows
    assert in_blocks >= SMS and rec_blocks >= SMS
    # One warp per window and net: 2,048 warps, 8 a block; two blocks fit
    # an SM (shared memory, and 128 registers a thread from
    # __launch_bounds__(256, 2)), so every block is resident at once.
    assert 2 * g.rec_windows == 8
    assert 2 * g.rec_smem <= 228 * 1024 and rec_blocks <= 2 * SMS


@pytest.mark.parametrize("rows", [16, 32, 64, 128])
@pytest.mark.parametrize("windows", [1, 2, 4])
def test_every_swept_geometry_fits(rows, windows):
    g = FD.learn_tiling(1024, 16, rows, windows)
    assert g is not None and g.in_rows == rows and g.rec_windows == windows
    assert max(g.in_smem, g.rec_smem, g.grad_smem) <= kernels.SMEM_LIMIT


@pytest.mark.parametrize("threads", FD.GRAD_THREADS)
def test_every_gradient_block_size_fits(threads):
    g = FD.learn_tiling(1024, 16, 64, 4, threads)
    assert g.grad_threads == threads and g.grad_smem == 64 * threads
    assert g.grad_smem <= kernels.SMEM_LIMIT


def test_an_l_or_batch_that_does_not_fit_is_refused():
    assert FD.learn_tiling(1024, 256, 128, 1) is None  # 251 KB a window
    with pytest.raises(ValueError, match="does not fit"):
        FD.learn_geometry(1024, 256, SMS)
    with pytest.raises(ValueError, match="multiple"):
        FD.learn_geometry(1026, 16, SMS)
    assert FD.learn_tiling(6, 4, 16, 4) is None  # 4 windows do not divide 6


@pytest.mark.parametrize("B,L", [(1024, 16), (4096, 16), (4, 1), (128, 8)])
def test_workspace_is_sized_from_b_and_l(B, L):
    ws = FD.new_workspace(B, L, CPU)
    assert ws.shape == (B * L, FD.WS_WIDTH) and FD.WS_WIDTH == 596
    ones = torch.zeros(FD.WS_WIDTH)
    ones[list(FD.WS_ONES)] = 1.0
    assert torch.equal(ws, ones.expand(B * L, -1))
    if (B, L) == (1024, 16):  # 39 MB, most of the 50 MB L2 cache
        assert ws.numel() * 4 == 39059456


def test_layout_matches_the_c_side():
    src = open(SOURCE).read()
    cols = {m[0]: int(m[1]) for m in re.findall(
        r"constexpr int kWs(\w+) = (\d+);", src)}
    names = {"X": "x", "Z1r": "z1r", "Dz1": "dz1", "Dx2": "dx2",
             "X2h": "x2h", "Da": "da", "H": "h", "Dz3": "dz3",
             "Z3r": "z3r", "Dq": "dq"}
    assert cols.pop("Width") == FD.WS_WIDTH
    assert {names[k]: v for k, v in cols.items()} == FD.WS_COLS
    assert all(v % 4 == 0 for v in FD.WS_COLS.values())
    grad = {m[0]: int(m[1]) for m in re.findall(r"kGrad(\w+) = (\d+)",
                                                src)}
    assert (grad["K"], grad["J"]) == (RECT_K, RECT_J)
    cases = re.findall(r"MGT_CASE\((\d+)\)", src)
    assert tuple(int(c) for c in cases) == FD.GRAD_THREADS
    # 16 entries a thread: threads / 8 summation tiles in flight, each
    # parking 16 x 8 partial sums.
    for threads in FD.GRAD_THREADS:
        groups = threads // (RECT_K * RECT_J // 16)
        assert 64 * threads == groups * RECT_K * RECT_J * 4
    assert re.search(r"constexpr int kInRowInts = (\d+);", src)[1] == str(
        FD.IN_ROW_INTS)
    assert re.search(r"constexpr int kWindows = (\d+);", src)[1] == str(
        FD.LEARN_WINDOWS)
    assert FD.IN_WIDTHS == (10, H1, HID, G)


def _factors(p, tp, batch, gamma, burn_in):
    """The rows the learner kernels write to the workspace, in plain torch
    (the arithmetic of _grads_plain), with the ones of the bias rows."""
    f32 = torch.float32
    X = batch["obs"].to(f32)
    act = batch["action"].to(torch.int64)
    rew, done = batch["reward"].to(f32), batch["done"].to(f32)
    B, L = act.shape
    v = FD._views(p)
    fe, ft = FD._unroll(v, X), FD._unroll(FD._views(tp), X)
    mask = FD._masks(done, burn_in)
    msum = torch.clamp_min(mask.sum().to(torch.int64), 1).to(f32)
    two = torch.full_like(msum, 2.0) / msum
    q, qt = fe["q"], ft["q"]
    boot = qt[:, 1:].gather(-1, torch.argmax(q[:, 1:], -1, keepdim=True))
    target = rew + (gamma * boot[..., 0]) * (1.0 - done)
    diff = q[:, :L].gather(-1, act[..., None])[..., 0] - target
    onehot = (act[..., None] == torch.arange(A)).to(f32)
    dq = onehot * ((two * mask) * diff)[..., None]
    lterm = (mask * diff) * diff
    gi, gf, gg, go, cprev, tc, h = (x[:, :L] for x in fe["cells"])
    z3 = fe["z3"][:, :L]
    dz3 = FD._back(dq, v[10]) * (z3 > 0.0).to(f32)
    dh_head = FD._back(dz3, v[8])
    dh_next, dc_next = torch.zeros(B, HID), torch.zeros(B, HID)
    das = [None] * L
    for t in reversed(range(L)):
        dh = dh_head[:, t] + dh_next
        do = dh * tc[:, t]
        dc = ((dh * go[:, t]) * (1.0 - tc[:, t] * tc[:, t])) + dc_next
        das[t] = torch.cat([
            ((dc * gg[:, t]) * gi[:, t]) * (1.0 - gi[:, t]),
            ((dc * cprev[:, t]) * gf[:, t]) * (1.0 - gf[:, t]),
            (dc * gi[:, t]) * (1.0 - gg[:, t] * gg[:, t]),
            (do * go[:, t]) * (1.0 - go[:, t])], dim=-1)
        dh_next = FD._back(das[t], v[6])
        dc_next = dc * gf[:, t]
    da = torch.stack(das, dim=1)
    dx2 = FD._back(da, v[4])
    z1 = fe["z1"][:, :L]
    dz1 = FD._back(dx2, v[2]) * (z1 > 0.0).to(f32)
    hprev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :L - 1]], dim=1)
    ws = FD.new_workspace(B, L, CPU).view(B, L, FD.WS_WIDTH)
    c = FD.WS_COLS
    for col, x in ((c["x"], X[:, :L]), (c["z1r"], FD._relu(z1)),
                   (c["dz1"], dz1), (c["dx2"], dx2),
                   (c["x2h"], fe["x2"][:, :L]),
                   (c["x2h"] + HID, hprev), (c["da"], da), (c["h"], h),
                   (c["dz3"], dz3), (c["z3r"], FD._relu(z3)), (c["dq"], dq),
                   (c["dq"] + A, lterm[..., None])):
        ws[:, :, col:col + x.shape[-1]] = x
    return ws.view(B * L, FD.WS_WIDTH), msum


# (first factor, K, second factor, J) of grad_kernel's jobs: each weight
# with its bias as row K - 1; the loss is column 5 of the last job's row 16.
JOBS = (("x", 11, "dz1", H1), ("z1r", H1 + 1, "dx2", HID),
        ("x2h", 2 * HID + 1, "da", G), ("h", HID + 1, "dz3", HID),
        ("z3r", HID + 1, "dq", A + 1))
RECT_K, RECT_J, GROUPS = 16, 8, 128


def _regrouped(ws, B, L):
    """Every job's sums rectangle by rectangle: per round of 128 tiles, each
    tile's sum over its 4 L rows in order from 0, then the round's partials
    added into the total in tile order."""
    TR, ntiles = FD.LEARN_WINDOWS * L, B // FD.LEARN_WINDOWS
    out = []
    for h, K, d, J in JOBS:
        hc, dc = FD.WS_COLS[h], FD.WS_COLS[d]
        total = torch.zeros(K, J)
        for k0 in range(0, K, RECT_K):
            for j0 in range(0, J, RECT_J):
                k1, j1 = min(K, k0 + RECT_K), min(J, j0 + RECT_J)
                rect = torch.zeros(k1 - k0, j1 - j0)
                for q0 in range(0, ntiles, GROUPS):
                    tiles = range(q0, min(ntiles, q0 + GROUPS))
                    part = torch.zeros(len(tiles), k1 - k0, j1 - j0)
                    for r in range(TR):
                        rows = ws[[t * TR + r for t in tiles]]
                        part = part + (rows[:, hc + k0:hc + k1, None]
                                       * rows[:, None, dc + j0:dc + j1])
                    for g in range(len(tiles)):
                        rect = rect + part[g]
                total[k0:k1, j0:j1] = rect
        out.append(total)
    w1b1, w2b2, gates, w3b3, w4b4 = out
    grad = torch.cat([w1b1.reshape(-1), w2b2.reshape(-1),
                      gates[:HID].reshape(-1), gates[2 * HID],
                      gates[HID:2 * HID].reshape(-1), gates[2 * HID],
                      w3b3.reshape(-1), w4b4[:, :A].reshape(-1)])
    return grad, w4b4[HID, A]


def _batch(B, L, burn_in, seed):
    """A sampled batch from a warm plain chunk: windows whose episodes end
    inside them, so masks vary."""
    n = 128 * -(-max(B, 256) // 128)
    cfg = DR.DRQNConfig(lr=1e-3, seq_len=L, burn_in=burn_in,
                        memory_capacity=2 * n, opponent="selfplay")
    ep = EnvParams(max_steps=9)
    c = FD.fused_drqn_init(seed, cfg, ep, n, device=CPU)
    c = FD.fused_drqn_chunk_plain(cfg, ep, c, 2 * L, 1, greedy=True)
    WF = (L + 1) * FD.SLOT
    return c, FD._rows_batch(c["ring"][0:WF, :B], L)


@pytest.mark.parametrize("B,L,burn_in", [(520, 3, 1), (8, 1, 0), (4, 3, 3)])
def test_gradient_regrouped_as_the_kernel_equals_grads_plain(B, L, burn_in):
    c, batch = _batch(B, L, burn_in, seed=B)
    grad, loss, msum = FD._grads_plain(c["p"], c["tp"], batch, gamma=0.9,
                                       burn_in=burn_in,
                                       windows=FD.LEARN_WINDOWS)
    ws, msum2 = _factors(c["p"], c["tp"], batch, 0.9, burn_in)
    got, loss_sum = _regrouped(ws, B, L)
    assert torch.equal(msum, msum2)
    assert got.shape == grad.shape == (FD.P,)
    assert torch.equal(got, grad)
    assert torch.equal(loss_sum / msum, loss)
    if B == 520:  # two rounds of tiles and a real loss
        assert B // FD.LEARN_WINDOWS > GROUPS
        assert float(loss) > 0.0 and bool((grad != 0).any())


def test_gates_input_term_ahead_of_the_recurrence_equals_gates():
    rng = np.random.default_rng(3)
    c, batch = _batch(8, 4, 1, seed=3)
    v = FD._views(c["p"])
    x2 = FD._unroll(v, batch["obs"])["x2"]                  # [B, T1, 16]
    gx = FD._acc(x2, v[4]) + v[5]                            # every row
    for t in range(x2.shape[1]):
        h = torch.tensor(rng.standard_normal((8, HID)), dtype=torch.float32)
        ahead = (gx[:, t] + FD._acc(h, v[6])) + v[7]
        assert torch.equal(ahead, FD._gates(v, x2[:, t], h))


def test_drqn_chunk_on_cpu_is_the_plain_version():
    cfg = DR.DRQNConfig(lr=1e-3, seq_len=2, burn_in=0, memory_capacity=256,
                        opponent="selfplay")
    ep = EnvParams(max_steps=20)
    carry = FD.fused_drqn_init(0, cfg, ep, 128, device=CPU)
    got = FD.fused_drqn_chunk(cfg, ep, carry, 5, 3, greedy=True)
    want = FD.fused_drqn_chunk_plain(cfg, ep, carry, 5, 3, greedy=True)
    assert got["learns"] == 2  # from step R * L - 1 = 3
    for k in want:
        if isinstance(want[k], torch.Tensor):
            assert torch.equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k


def test_learner_refuses_cpu_tensors():
    cfg = DR.DRQNConfig(seq_len=4, memory_capacity=256)
    carry = FD.fused_drqn_init(0, cfg, EnvParams(), 128, device=CPU)
    st = FD.working_state(carry)
    libs = dict(kernels._libs)
    with pytest.raises(ValueError, match="CUDA"):
        FD.Learner(st, 128, 4)
    with pytest.raises(ValueError, match="CUDA"):
        FD.launch_drqn(st, carry, cfg, EnvParams(), 1, 0, True, [0], [0])
    assert kernels._libs == libs  # nothing was built or loaded
