"""K8's ``rb_post`` and ``rb_per_pick`` (``rainbow_trainer.cu``) as the
kernels now compute them, transcribed in PyTorch without a card and held
bit for bit against the unchanged plain versions of
``ops/fused_rainbow.py``.

``rb_post``: a block owns a tile of one ``[in][out]`` matrix
(``post_geometry``), draws each of the tile's in-factors, out-factors and
(in a tile of in-row 0) bias entries once, forms ``f_out * f_in`` and
``mu + sigma * eps``, and stores the online net's weights transposed
through a staged tile.  Over the blocks this must give ``fresh_noise``,
``effective_weights`` and the ``wpt`` layout the learner reads.

``rb_per_pick``: the masked grid staged at a padded chunk stride, each
chunk's running sum in place, the chunk sums' prefix in order, then one
binary search over ``excl[i // 128] + local[i]`` per target.  That must
give ``per_pick``'s ``searchsorted(side='right')`` index, clipped, on every
grid: zero, tied and dominant priorities, empty chunks, targets at exact
cdf values and at or past the total.

The geometry functions and the C constants are parsed and held against
each other.
"""

import os
import re

import numpy as np
import pytest
import torch

from merging_gym_tpu_torch import kernels
from merging_gym_tpu_torch.nn.noisy import scale_noise
from merging_gym_tpu_torch.ops import fused_rainbow as FRB
from merging_gym_tpu_torch.ops import philox
from tests.torch_threads import one_torch_thread  # noqa: F401

H0, H1 = FRB.H0, FRB.H1
SMS = 132


def _source():
    with open(os.path.join(kernels.CSRC, "rainbow_trainer.cu")) as f:
        return f.read()


def _body(src, start):
    """The text of the C function or kernel that begins at ``start``."""
    i = src.index(start)
    return src[i:src.index("\n}\n", i)]


# ---------------------------------------------------------------------------
# rb_post
# ---------------------------------------------------------------------------

def _scaled_normals(gstep, idx, stream, key):
    """rainbow_trainer.cu:scaled_normal at counters (gstep, idx, stream, 0)
    for the indices ``idx`` only: one draw per index."""
    idx = torch.as_tensor(idx, dtype=torch.int64)
    w = philox.philox4x32_10(torch.full_like(idx, gstep & philox.MASK32),
                             idx, torch.full_like(idx, stream),
                             torch.zeros_like(idx), key)
    u0 = (w[0] >> 8).to(torch.float32) * (1.0 / 16777216.0)
    u1 = (w[1] >> 8).to(torch.float32) * (1.0 / 16777216.0)
    r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u0, 1e-7)))
    return scale_noise(r * torch.cos((2.0 * 3.14159265358979) * u1))


def _blocks(g):
    """(net, layer, rows, cols, i0, j0) of each tile block in launch order
    (rb_post_kernel's walk over post_tiles), then None for the lanes'
    block."""
    out = []
    for m, (rows, cols) in enumerate(FRB.POST_MATRICES):
        tcols = -(-cols // g.to)
        for b in range((rows // g.ti) * tcols):
            out.append((0 if m < 5 else 1, m % 5, rows, cols,
                        (b // tcols) * g.ti, (b % tcols) * g.to))
    return out + [None]


def _post_tiles(g, p, tp, eps, teps, *, regen, sync, gstep=0, key=(0, 0)):
    """rb_post_kernel's tile blocks on the CPU: returns (eps, teps, wp, wt,
    wpt, draws), ``draws`` the normals drawn per net, layer and stream."""
    out = {"eps": eps.clone(), "teps": teps.clone(),
           "wp": torch.full_like(eps, float("nan")),
           "wt": torch.full_like(teps, float("nan")),
           "wpt": torch.full((FRB.NUM_T,), float("nan"))}
    draws = {}
    blocks = _blocks(g)
    assert len(blocks) == g.blocks
    for blk in blocks[:-1]:
        net, l, rows, cols, i0, j0 = blk
        i = torch.arange(i0, i0 + g.ti)
        j = torch.arange(j0, min(j0 + g.to, cols))
        at = (i[:, None] * cols + j[None, :]).reshape(-1)
        if l == 4:  # w1, transposed only
            w = p[FRB.IN_DIM * H0 + H0 + at]
        else:
            ep = out["teps" if net else "eps"]
            src = tp if net == 1 and not sync else p
            s = FRB.STREAM_NOISE + 12 * net + 3 * l
            mu0, e0, w_sz = FRB.P_OFF[l], FRB.E_OFF[l], rows * cols
            if regen:
                fin = _scaled_normals(gstep, i, s, key)
                fout = _scaled_normals(gstep, j, s + 1, key)
                for k, n in ((s, len(i)), (s + 1, len(j))):
                    draws[(net, l, k)] = draws.get((net, l, k), 0) + n
                ep[e0 + at] = (fout[None, :] * fin[:, None]).reshape(-1)
            w = src[mu0 + at] + src[mu0 + w_sz + at] * ep[e0 + at]
            (out["wt"] if net else out["wp"])[e0 + at] = w
            if i0 == 0:  # the bias threads
                if regen:
                    ep[e0 + w_sz + j] = _scaled_normals(gstep, j, s + 2, key)
                    draws[(net, l, s + 2)] = draws.get((net, l, s + 2),
                                                       0) + len(j)
                bm = mu0 + 2 * w_sz + j
                (out["wt"] if net else out["wp"])[e0 + w_sz + j] = (
                    src[bm] + src[bm + cols] * ep[e0 + w_sz + j])
        if net == 0:  # staged [to][ti + 1], stored row by row of W^T
            tile = torch.full((g.to, g.ti + 1), float("nan"))
            tile[:len(j), :g.ti] = w.view(g.ti, len(j)).t()
            for jj in range(len(j)):
                out["wpt"][FRB.T_OFF[l] + (j0 + jj) * rows + i0
                           + torch.arange(g.ti)] = tile[jj, :g.ti]
    return out, draws


def _state(seed):
    rng = np.random.default_rng(seed)

    def t(n, s=1.0):
        return torch.as_tensor(rng.standard_normal(n) * s,
                               dtype=torch.float32)
    return (t(FRB.NUM_P, 0.1), t(FRB.NUM_P, 0.1), t(FRB.NUM_E), t(FRB.NUM_E))


def _wpt_layout(p, wp):
    """The transposed layout element by element, as the learner reads it
    (tests/test_torch_rainbow_learner_geometry.py:_transposed)."""
    wpt = torch.full((FRB.NUM_T,), float("nan"))
    for l, (eo, o) in enumerate(zip(FRB.E_OFF, FRB.NOISY_OUT)):
        j = torch.arange(H1 * o)
        wpt[FRB.T_OFF[l] + (j % o) * H1 + j // o] = wp[eo + j]
    k = torch.arange(H0 * H1)
    wpt[FRB.T_OFF[4] + (k % H1) * H0 + k // H1] = p[FRB.IN_DIM * H0 + H0 + k]
    return wpt


def test_post_blocks_cover_every_entry_once():
    """Every noisy element of both nets, every bias and every transposed
    entry belongs to exactly one block's tile, and every thread of a block
    holds POST_EPT entries and draws at most one."""
    g = FRB.post_geometry()
    elem = np.zeros((2, FRB.NUM_E), np.int64)
    wpt = np.zeros(FRB.NUM_T, np.int64)
    for blk in _blocks(g)[:-1]:
        net, l, rows, cols, i0, j0 = blk
        jn = min(j0 + g.to, cols) - j0
        assert jn >= 1 and i0 + g.ti <= rows
        for i in range(i0, i0 + g.ti):
            for j in range(j0, j0 + jn):
                if l < 4:
                    elem[net, FRB.E_OFF[l] + i * cols + j] += 1
                wpt_at = FRB.T_OFF[l] + j * rows + i
                if net == 0:
                    wpt[wpt_at] += 1
        if l < 4 and i0 == 0:
            elem[net, FRB.E_OFF[l] + rows * cols + np.arange(j0, j0 + jn)] += 1
    assert (elem == 1).all() and (wpt == 1).all()
    assert g.ti * g.to == FRB.POST_EPT * g.threads
    assert g.ti + 2 * g.to <= g.threads <= 1024 and g.threads % 32 == 0


# Steps and seeds, the last step the counter takes among them.
DRAW_CASES = [(0, 0), (7, 123), (2**32 - 1, 99), (1000, 0), (1001, 1),
              (1002, 2)]


@pytest.mark.parametrize("gstep,seed", DRAW_CASES)
def test_tile_draws_equal_fresh_noise(gstep, seed):
    """Factors drawn once per tile and formed as f_out * f_in: both nets'
    noise equals ``fresh_noise`` bit for bit, with at most one draw per
    distinct factor or bias entry per tile (here counted over the
    blocks)."""
    g = FRB.post_geometry()
    key = philox.seed_key(seed)
    p, tp, eps, teps = _state(1)
    out, draws = _post_tiles(g, p, tp, eps, teps, regen=True, sync=False,
                             gstep=gstep, key=key)
    for net, name in ((0, "eps"), (1, "teps")):
        want = FRB.fresh_noise(gstep, net, key, "cpu")
        assert torch.equal(out[name], want), name
    for l, o in enumerate(FRB.NOISY_OUT):
        s = FRB.STREAM_NOISE + 3 * l
        tcols = -(-o // g.to)
        assert draws[(0, l, s)] == H1 * tcols          # in-factors
        assert draws[(0, l, s + 1)] == o * (H1 // g.ti)  # out-factors
        assert draws[(0, l, s + 2)] == o                 # biases, once
    # the parent drew two normals for each of the 2 x 28,210 elements
    assert sum(draws.values()) < 2 * FRB.NUM_E // 4


# Every mode on one state, the learning step's mode on three more.
WEIGHT_CASES = [(regen, sync, 2) for regen in (False, True)
                for sync in (False, True)] + [(True, False, s)
                                              for s in (3, 4, 5)]


@pytest.mark.parametrize("regen,sync,seed", WEIGHT_CASES)
def test_tile_weights_and_transposes_equal_plain(regen, sync, seed):
    """Each mode: ``effective_weights`` of (p, eps) and of (tp, teps), or of
    p for the target net on a sync; the noise kept without a redraw; the
    staged tiles' stores give the ``wpt`` layout the learner reads."""
    g = FRB.post_geometry()
    p, tp, eps, teps = _state(seed)
    key = philox.seed_key(5)
    out, _ = _post_tiles(g, p, tp, eps, teps, regen=regen, sync=sync,
                         gstep=3, key=key)
    if regen:
        eps, teps = (FRB.fresh_noise(3, 0, key, "cpu"),
                     FRB.fresh_noise(3, 1, key, "cpu"))
    assert torch.equal(out["eps"], eps) and torch.equal(out["teps"], teps)
    wp = FRB.effective_weights(p, eps)
    assert torch.equal(out["wp"], wp)
    assert torch.equal(out["wt"], FRB.effective_weights(p if sync else tp,
                                                        teps))
    assert torch.equal(out["wpt"], _wpt_layout(p, wp))
    assert torch.equal(out["wpt"], FRB.transposes_plain(p, wp))


def _post_state(seed, n=256, R=4, B=16):
    p, tp, eps, teps = _state(seed)
    rng = np.random.default_rng(seed)
    env = torch.as_tensor(rng.random((FRB.ENV_ROWS, n)), dtype=torch.float32)
    ring = torch.as_tensor(rng.random((R * FRB.NUM_F, n)),
                           dtype=torch.float32)
    st = {"p": p, "tp": tp, "eps": eps, "teps": teps, "env": env,
          "ring": ring}
    sel = torch.stack([torch.as_tensor(rng.integers(0, R, B)),
                       torch.as_tensor(rng.integers(0, n, B))]).to(
                           torch.int32)
    ce = torch.as_tensor(rng.random(B) * 3, dtype=torch.float32)
    sel[:, 1], ce[1] = sel[:, 0], ce[0]  # a duplicate pick: the same CE
    return st, sel, ce


@pytest.mark.parametrize("regen", [0, 1])
@pytest.mark.parametrize("per_wb", [0, 1])
@pytest.mark.parametrize("ep_step", [0, 30])
def test_post_plain_modes(regen, per_wb, ep_step):
    """``post_plain`` (the card's isolated reference): the target copied
    exactly when the f32 rule passes the synced count, the noise redrawn
    only with ``regen``, the priorities written back (duplicate picks the
    same bits) and the running max raised only with ``per_wb``."""
    st, sel, ce = _post_state(3)
    before = {k: v.clone() for k, v in st.items()}
    tot = torch.tensor([37, 0], dtype=torch.int32)
    eps_ = torch.tensor([ep_step], dtype=torch.int32)
    key = philox.seed_key(11)
    FRB.post_plain(st, tot, eps_, ce, sel, i=0, regen=regen, per_wb=per_wb,
                   check_sync=1, gstep=9, key=key, alpha=0.6,
                   inv_sync=float(np.float32(1 / 20)), synced0=1.0)
    sync = ep_step == 30  # floor(67 / 20) = 3 > 1; floor(37 / 20) = 1
    assert int(tot[1]) == 37 + ep_step
    assert torch.equal(st["tp"], before["p"] if sync else before["tp"])
    assert (st["env"][11] == (3.0 if sync else 1.0)).all()
    assert torch.equal(st["eps"], FRB.fresh_noise(9, 0, key, "cpu")
                       if regen else before["eps"])
    pre = torch.clamp_min(ce + 1e-5, 1e-8)
    n = st["env"].shape[1]
    got = st["ring"].view(-1, FRB.NUM_F, n)[sel[0].long(), FRB.NUM_F - 1,
                                             sel[1].long()]
    if per_wb:
        assert torch.equal(got, FRB._pow(pre, 0.6))
        assert torch.equal(st["env"][13], torch.maximum(
            before["env"][13], pre.max()))
    else:
        assert torch.equal(st["ring"], before["ring"])
        assert torch.equal(st["env"][13], before["env"][13])
    assert torch.equal(st["wt"], FRB.effective_weights(st["tp"],
                                                       st["teps"]))
    assert torch.equal(st["wpt"], _wpt_layout(st["p"], st["wp"]))


def test_post_plain_opening_and_later_step_rule():
    """The chunk-opening post (no sync check) forms the weights alone; at
    step i > 0 the synced count is first raised to floor(tot[i] / 20)."""
    st, sel, ce = _post_state(4)
    tp0 = st["tp"].clone()
    tot = torch.tensor([41, 41, 0], dtype=torch.int32)
    FRB.post_plain(st, tot, torch.zeros(2, dtype=torch.int32), ce, sel, i=0,
                   regen=0, per_wb=0, check_sync=0, gstep=0, key=(0, 0),
                   alpha=0.6, inv_sync=0.05, synced0=0.0)
    assert torch.equal(st["tp"], tp0) and int(tot[1]) == 41
    assert torch.equal(st["wt"], FRB.effective_weights(tp0, st["teps"]))
    # step 1: floor(41 * 0.05) = 2 synced already, 41 + 0 does not pass it
    FRB.post_plain(st, tot, torch.zeros(2, dtype=torch.int32), ce, sel, i=1,
                   regen=0, per_wb=0, check_sync=1, gstep=0, key=(0, 0),
                   alpha=0.6, inv_sync=float(np.float32(0.05)), synced0=0.0)
    assert torch.equal(st["tp"], tp0) and (st["env"][11] == 2.0).all()


# ---------------------------------------------------------------------------
# rb_per_pick
# ---------------------------------------------------------------------------

def _staged(P):
    """Phases 1-3 of rb_per_pick_kernel: the grid at chunk stride
    PICK_STRIDE, each chunk's running sum in place, the chunk sums' prefix
    in chunk order (one chain), the total."""
    R, n = P.shape
    C = R * n // 128
    g = torch.zeros(C * FRB.PICK_STRIDE)
    chunks = P.reshape(C, 128)
    at = (torch.arange(C)[:, None] * FRB.PICK_STRIDE
          + torch.arange(128)[None, :])
    g[at.reshape(-1)] = chunks.reshape(-1)
    acc = torch.zeros(C)
    for j in range(128):       # each thread's 128-add chain, in place
        acc = acc + g[at[:, j]]
        g[at[:, j]] = acc
    excl = torch.zeros(C)
    run = torch.zeros(())
    for c in range(C):         # thread 0's C-add chain
        excl[c] = run
        run = run + acc[c]
    return g, excl, run


def _search(g, excl, u, N):
    """Phase 4: per target the first index whose excl[i >> 7] + g[...]
    exceeds u, clipped to N - 1."""
    lo = torch.zeros(u.shape, dtype=torch.int64)
    hi = torch.full(u.shape, N, dtype=torch.int64)
    probes = 0
    while (lo < hi).any():
        active = lo < hi
        mid = (lo + hi) >> 1
        ch = mid >> 7
        cdf = excl[ch.clamp(max=excl.numel() - 1)] + g[
            (ch * FRB.PICK_STRIDE + (mid & 127)).clamp(max=g.numel() - 1)]
        le = cdf <= u
        lo = torch.where(active & le, mid + 1, lo)
        hi = torch.where(active & ~le, mid, hi)
        probes += 1
    assert probes <= int(np.ceil(np.log2(N + 1)))
    return torch.clamp(lo, max=N - 1)


def _grid(kind, R, n, seed):
    rng = np.random.default_rng(seed)
    P = rng.random((R, n)).astype(np.float32) * 2
    if kind == "zeros":        # zero slots, an empty chunk, an empty round
        P[rng.random((R, n)) < 0.3] = 0.0
        P[0, :128] = 0.0
        P[R - 1] = 0.0
    elif kind == "tied":
        P[:] = 0.25
    elif kind == "dominant":
        P *= 1e-6
        P[R // 2, n - 1] = 1e3
    elif kind == "powers":     # the sums the write-back makes: x ** 0.6
        P = np.exp(0.6 * np.log(np.maximum(P, 1e-30))).astype(np.float32)
    return torch.as_tensor(P)


PICK_SHAPES = ((4, 128), (8, 1024), (2, 256), (3, 384))
GRIDS = ("random", "zeros", "tied", "dominant", "powers")


@pytest.mark.parametrize("kind", GRIDS)
@pytest.mark.parametrize("R,n", PICK_SHAPES)
def test_staged_search_equals_per_pick(kind, R, n):
    """The staged cdf equals ``per_cdf`` at every index and is
    non-decreasing; the whole-grid binary search equals ``per_pick`` on
    targets at exact cdf values, between them, at 0, at and past the total,
    and at the stratified targets."""
    P = _grid(kind, R, n, R * n)
    g, excl, total = _staged(P)
    cdf, want_total = FRB.per_cdf(P)
    N = R * n
    i = torch.arange(N)
    staged = excl[i >> 7] + g[(i >> 7) * FRB.PICK_STRIDE + (i & 127)]
    assert torch.equal(staged, cdf) and torch.equal(total, want_total)
    assert (staged[1:] >= staged[:-1]).all()
    rng = np.random.default_rng(N)
    exact = cdf[torch.as_tensor(rng.integers(0, N, 64))]
    u = torch.cat([exact, torch.nextafter(exact, torch.tensor(-1.0)),
                   torch.tensor([0.0, float(total), float(total) * 2]),
                   torch.as_tensor(rng.random(64), dtype=torch.float32)
                   * total,
                   (torch.arange(32, dtype=torch.float32) + 0.37)
                   * (total * float(np.float32(1 / 32)))])
    r, lane, p_sel = FRB.per_pick(P, u, cdf)
    idx = _search(g, excl, u, N)
    assert torch.equal(idx // n, r) and torch.equal(idx % n, lane)
    assert torch.equal(P.reshape(-1)[idx], p_sel)


@pytest.mark.parametrize("kind", GRIDS)
@pytest.mark.parametrize("R,n,B,stored,n_step", [(4, 128, 8, 4, 1),
                                                 (8, 1024, 32, 8, 3),
                                                 (8, 1024, 1024, 5, 3),
                                                 (3, 256, 24, 3, 2)])
def test_staged_pick_equals_pick_plain(kind, R, n, B, stored, n_step):
    """The whole kernel on a ring: masked rounds (age outside [n_step - 1,
    stored - 1]) staged as zeros, pmin folded by fminf, the picks and the
    importance weights (the priority read from the ring by index) equal
    ``pick_plain``."""
    rng = np.random.default_rng(B)
    ring = torch.as_tensor(rng.random((R * FRB.NUM_F, n)),
                           dtype=torch.float32)
    ring[FRB.NUM_F - 1::FRB.NUM_F] = _grid(kind, R, n, B)
    r_cur = int(rng.integers(0, R))
    us = torch.tensor([0.61], dtype=torch.float32)
    beta = 0.4
    age = (r_cur - torch.arange(R) + R) % R
    valid = (age >= n_step - 1) & (age <= stored - 1)
    P = torch.where(valid[:, None], ring[FRB.NUM_F - 1::FRB.NUM_F], 0.0)
    g, excl, total = _staged(P)
    pmin = torch.min(torch.where(P > 0.0, P, torch.inf))  # fminf, any order
    u = ((torch.arange(B, dtype=torch.float32) + us[0])
         * (total * float(np.float32(1.0 / B))))
    idx = _search(g, excl, u, R * n)
    r, lane = idx // n, idx % n
    p = torch.where(valid[r], ring[r * FRB.NUM_F + FRB.NUM_F - 1, lane], 0.0)
    w = FRB.per_weights(p, pmin, total, stored, n_step, n, beta)
    sel, wts = FRB.pick_plain(ring, us, R, n, B, r_cur, stored, n_step, beta)
    assert torch.equal(sel, torch.stack([r, lane]).to(torch.int32))
    assert torch.equal(wts, w)
    assert torch.isfinite(wts).all()


# ---------------------------------------------------------------------------
# Geometry and the C constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R,n,layout", [(8, 1024, 0), (4, 128, 0),
                                        (2, 256, 0), (16, 4096, 1),
                                        (32, 1024, 0), (64, 1024, 1),
                                        (13, 4096, 0), (14, 4096, 1)])
def test_pick_geometry_layouts(R, n, layout):
    """The grid in shared memory where its floats fit a block's 232,448 B,
    in a global workspace otherwise; the CLI's R 8, n 1,024 in 34,304 B."""
    g = FRB.pick_geometry(R, n)
    floats = FRB.pick_floats(R, n)
    assert g.layout == layout
    if layout == FRB.PICK_SHARED:
        assert g.smem == 4 * floats <= kernels.SMEM_LIMIT and not g.ws_floats
    else:
        assert 4 * floats > kernels.SMEM_LIMIT
        assert (g.smem, g.ws_floats) == (0, floats)
        assert FRB.pick_tiling(R, n, FRB.PICK_SHARED) is None
    assert FRB.pick_geometry(8, 1024).smem == 34304


def test_pick_geometry_refuses_lanes_off_the_chunks():
    for R, n in ((8, 100), (0, 128), (4, 0)):
        with pytest.raises(ValueError, match="multiple of 128"):
            FRB.pick_geometry(R, n)


def test_post_geometry_fills_one_wave():
    """16 x 32 tiles at 256 threads: 116 tile blocks and the lanes' block,
    one wave on 132 SMs, two entries and at most one draw a thread."""
    g = FRB.post_geometry()
    assert g == (16, 32, 256, 117)
    assert g.blocks <= SMS
    assert FRB.post_blocks() == 1 + 2 * (8 + 8 + 8 + 32) + 4


def test_kernel_constants_match():
    """rb_post's and rb_per_pick's layouts in C equal the Python mirror: the
    chunk stride, the pick's threads and floats, the post's tile, threads,
    matrices in block order, entries a thread and blocks; the kernels read
    their geometry and check it."""
    src = _source()
    c = {k: int(v) for k, v in re.findall(
        r"constexpr int (kPick\w+|kPost\w+) = (\d+);", src)}
    assert c["kPickThreads"] == FRB.PICK_THREADS == 512
    assert c["kPickStride"] == FRB.PICK_STRIDE == 132
    layouts = re.search(r"kPickShared = (\d+), kPickGlobal = (\d+);", src)
    assert (int(layouts[1]), int(layouts[2])) == (FRB.PICK_SHARED,
                                                  FRB.PICK_GLOBAL)
    assert c["kPostEpt"] == FRB.POST_EPT
    assert (c["kPostTi"], c["kPostTo"]) == FRB.POST_TILE
    assert c["kPostThreads"] == FRB.POST_THREADS
    ti, to = FRB.POST_TILE  # the tile divides the rows it cuts
    assert H0 % ti == 0 and H1 % ti == 0 and 1 <= to <= H1
    assert c["kPostMatrices"] == len(FRB.POST_MATRICES) == 9
    assert "return C * kPickStride + 2 * C;" in src
    assert "return m == 4 ? kH0 : kH1;" in src
    assert "return m == 4 ? kH1 : out_of(m % 5);" in src
    assert "__shared__ float fin[TI], fout[TO], tile[TO * (TI + 1)];" in src
    assert [r for r, _ in FRB.POST_MATRICES] == [H1] * 4 + [H0] + [H1] * 4
    assert [o for _, o in FRB.POST_MATRICES] == [*FRB.NOISY_OUT, H1,
                                                 *FRB.NOISY_OUT]
    post = _body(src, 'extern "C" int mgt_rb_post')
    assert ("post_geom_ok(PostGeom{ti, to, threads, blocks})" in post
            and "cudaErrorInvalidValue" in post)
    pick = _body(src, 'extern "C" int mgt_rb_per_pick')
    assert "need * sizeof(float) > static_cast<size_t>(smem)" in pick
    assert "static_cast<size_t>(ws_floats) < need" in pick
    # C arguments: pointers, ints, then the workspace's long long
    assert len(FRB._PICK_ARGS) == 17 and len(FRB._POST_ARGS) == 31


def test_the_per_element_draws_and_the_walk_are_gone():
    """rb_post draws per tile, not two normals per element (the old
    fresh_eps), and finds its tile once per block; rb_per_pick's binary
    search probes shared memory with no 128-step walk over global loads."""
    src = _source()
    post = _body(src, "__global__ void __launch_bounds__(kPostThreads)\n"
                      "    rb_post_kernel")
    assert "float fresh_eps(" not in src and "mu_sigma(e" not in post
    assert post.count("scaled_normal(") == 3
    assert "while (e < eoff(l))" not in post and "g.ti" not in post
    pick = _body(src, "template <int kLayout>")
    assert "++idx" not in pick and "per_prio" not in src
    assert pick.count("while (lo < hi)") == 1
    search = pick[pick.index("while (lo < hi)"):]
    search = search[:search.index("sel[b] = r;")]
    assert "ring[" not in search  # the probes read the staged cdf only
