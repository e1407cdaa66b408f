"""K8's Rainbow learner on the CPU: its launch geometry on an H100's 132
SMs, its shared-memory layout and workspace, the order its kernels sum in,
and what the wrappers do with CPU tensors.

``ops.fused_rainbow.learn_geometry`` must give the forward/backward kernel
at least 128 blocks at B 1,024, fit every block's shared memory, and
refuse a batch that its summation tile does not divide.  The layout is
recounted here from ``rainbow_trainer.cu`` (``kY*``/``kS*``, ``grad_smem``)
and its workspace columns read from the source.  The order checks run in
plain torch, bit for bit against ``_grads_plain``: the online forward that
keeps only the sampled action's softmax; the backward through the
transposed weights that ``rb_post`` forms; and the gradient re-assembled
in the gradient kernel's grouping (rectangles of 16 x 8 entries, a bias as
the row of ones beside its weight's first factor, the summation tiles in
flight a round, their partials added in tile order), with the loss from
the CE column beside value2's bias row and the fused Adam's mu and sigma
indices.
"""

import os
import re

import numpy as np
import pytest
import torch

from merging_gym_tpu_torch import kernels
from merging_gym_tpu_torch.agents import rainbow as RB
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.ops import fused_rainbow as FRB
from merging_gym_tpu_torch.ops import fused_trainer as FT
from tests.torch_threads import one_torch_thread  # noqa: F401

SMS = 132
CPU = torch.device("cpu")
A, ATOMS, H0, H1 = FRB.A, FRB.ATOMS, FRB.H0, FRB.H1
SOURCE = os.path.join(os.path.dirname(kernels.__file__), "csrc",
                      "rainbow_trainer.cu")


def _lane_floats(src):
    """The per-lane arrays of learn_fwd_kernel from the source: each
    array's offset (kY*), its row stride (kS*, by the array it serves)."""
    offs = {m[0]: int(m[1]) for m in re.findall(r"kY(\w+) = (\d+)", src)}
    strides = {m[0]: int(m[1]) for m in re.findall(r"kS(\w+) = (\d+)", src)}
    return offs, strides


@pytest.mark.parametrize("B", [1024, 512, 32, 24])
def test_geometry_fits_the_shared_memory_it_is_given(B):
    g = FRB.learn_geometry(B, SMS)
    assert g.lanes in FRB.LEARN_LANES
    assert g.smem == 4 * (2 * FRB.CHUNK + g.lanes * FRB.LANE_FLOATS)
    assert g.smem <= kernels.SMEM_LIMIT
    # 256 threads, 32 summation tiles in flight, 64 bytes a thread.
    assert g.grad_threads == 256
    assert g.grad_smem == 64 * g.grad_threads <= kernels.SMEM_LIMIT
    assert B % FRB.learn_tile(B) == 0


def test_forward_runs_at_least_128_blocks_at_b1024():
    g = FRB.learn_geometry(1024, SMS)
    blocks = -(-1024 // g.lanes)
    assert blocks >= 128 and blocks <= SMS  # one wave, one block an SM
    assert (g.lanes, g.grad_threads) == (8, 256)
    # The batches of the main paths: learn_batch 512, the PER batch 32.
    assert FRB.learn_geometry(512, SMS).lanes == 4
    assert FRB.learn_geometry(32, SMS).lanes == 1


@pytest.mark.parametrize("lanes", FRB.LEARN_LANES)
@pytest.mark.parametrize("threads", FRB.GRAD_THREADS)
def test_every_swept_geometry_fits(lanes, threads):
    g = FRB.learn_tiling(1024, lanes, threads)
    assert g is not None and (g.lanes, g.grad_threads) == (lanes, threads)
    assert max(g.smem, g.grad_smem) <= kernels.SMEM_LIMIT


def test_a_batch_or_geometry_that_does_not_fit_is_refused():
    with pytest.raises(ValueError, match="multiple"):
        FRB.learn_geometry(20, SMS)          # the tile of 8 does not divide
    assert FRB.learn_tiling(20, 1, 256) is None
    assert FRB.learn_tiling(1024, 16, 512) is None  # 243 KB a block
    assert FRB.learn_smem(16) > kernels.SMEM_LIMIT
    assert FRB.learn_tiling(1024, 3, 512) is None
    assert FRB.learn_tiling(1024, 8, 128) is None


@pytest.mark.parametrize("B", [1024, 512, 32, 24])
def test_workspace_is_sized_from_b(B):
    ws = FRB.new_workspace(B, CPU)
    assert ws.shape == (B, FRB.WS_WIDTH) and FRB.WS_WIDTH == 784
    ones = torch.zeros(FRB.WS_WIDTH)
    ones[list(FRB.WS_ONES)] = 1.0
    assert torch.equal(ws, ones.expand(B, -1))
    if B == 1024:  # 3.2 MB, against the old 7.85 MB of partial sums
        assert ws.numel() * 4 == 3211264


def test_layout_matches_the_c_side():
    src = open(SOURCE).read()
    cols = {m[0]: int(m[1]) for m in re.findall(
        r"constexpr int kWs(\w+) = (\d+);", src)}
    names = {"X": "x", "H1": "h1", "H2": "h2", "Hv1": "hv1", "Ha1": "ha1",
             "Dz1": "dz1", "Dz2": "dz2", "Dzv1": "dzv1", "Dl": "dl",
             "Dza1": "dza1", "Dza2": "dza2"}
    assert cols.pop("Width") == FRB.WS_WIDTH
    assert {names[k]: v for k, v in cols.items()} == FRB.WS_COLS
    assert all(v % 4 == 0 for v in FRB.WS_COLS.values())
    lane = int(re.search(r"constexpr int kLaneFloats = (\d+);", src)[1])
    assert lane == FRB.LANE_FLOATS
    offs, strides = _lane_floats(src)
    stride_of = {"x": "x", "xn": "x", "h1": "h1", "h2": "h", "hv1": "h",
                 "ha1": "h", "zv2": "v", "za2": "a", "dist": "a",
                 "mass": "51", "bb": "51", "proj": "51", "dsel": "51",
                 "pce": "51", "g": "51", "dl": "v", "dza2": "a",
                 "dzv1": "h", "dza1": "h", "dz2": "h", "av": "h",
                 "sc": "sc"}
    assert set(offs) == set(stride_of)
    order = sorted(offs, key=offs.get)
    for a, b in zip(order, order[1:]):  # packed, each row 16 bytes
        assert offs[a] + strides[stride_of[a]] == offs[b], a
    assert offs[order[-1]] + strides[stride_of[order[-1]]] == lane
    assert all(v % 4 == 0 for v in list(offs.values())
               + list(strides.values()))
    # The widest layer whole; a multiple of 4 floats, so the second
    # buffer starts 16-byte aligned.
    assert re.search(r"constexpr int kChunk = kH1 \* kA \* kAtoms;", src)
    assert FRB.CHUNK == H1 * A * ATOMS == 16320 and FRB.CHUNK % 4 == 0
    assert re.search(r"kNumT == (\d+)", src)[1] == str(FRB.NUM_T)
    grad = {m[0]: int(m[1]) for m in re.findall(r"kGrad(\w+) = (\d+)",
                                                src)}
    assert (grad["K"], grad["J"]) == (RECT_K, RECT_J)
    body = src[src.index('extern "C" int mgt_rb_learn_grad'):]
    cases = re.findall(r"MGT_CASE\((\d+)\)", body)
    assert tuple(int(c) for c in cases) == FRB.GRAD_THREADS
    body = src[src.index('extern "C" int mgt_rb_learn_fwd'):]
    lanes = re.findall(r"MGT_CASE\((\d+)\)", body[:body.index("#undef")])
    assert tuple(int(c) for c in lanes) == FRB.LEARN_LANES


# (first factor, K, second factor, J, width) of the gradient kernel's
# jobs: each weight with its bias as row K - 1; value2's column 51 is the
# weighted CE, whose bias-row entry is the loss's sum.
JOBS = (("x", 11, "dz1", H0, H0), ("h1", H0 + 1, "dz2", H1, H1),
        ("h2", H1 + 1, "dzv1", H1, H1), ("hv1", H1 + 1, "dl", ATOMS + 1,
                                         ATOMS),
        ("h2", H1 + 1, "dza1", H1, H1), ("ha1", H1 + 1, "dza2", A * ATOMS,
                                         A * ATOMS))
RECT_K, RECT_J = 16, 8


def _transposed(p, wp):
    """The buffer rb_post forms: element e = (in, out) of a noisy layer's
    W goes to T_OFF[l] + out * 64 + in, w1 [32][64] to w1^T [64][32]."""
    wpt = torch.full((FRB.NUM_T,), float("nan"))
    for l, (eo, o) in enumerate(zip(FRB.E_OFF, FRB.NOISY_OUT)):
        j = torch.arange(H1 * o)
        wpt[FRB.T_OFF[l] + (j % o) * H1 + j // o] = wp[eo + j]
    k = torch.arange(H0 * H1)
    w1_at = FRB.IN_DIM * H0 + H0
    wpt[FRB.T_OFF[4] + (k % H1) * H0 + k // H1] = p[w1_at + k]
    assert not torch.isnan(wpt).any()
    return wpt


def _acc(x, w):
    """sum_k x[:, k] * w[k] in k order from 0, a layer of staged_sums."""
    acc = torch.zeros(x.shape[0], w.shape[1])
    for k in range(w.shape[0]):
        acc = acc + x[:, k:k + 1] * w[k]
    return acc


def _mask(h):
    return (h > 0.0).to(torch.float32)


def _kernel_rows(p, tp, wp, wt, rows, weights, gamma, scale, faithful):
    """The rows learn_fwd_kernel writes to the workspace, in plain torch
    in its formulation: the online net's combine and softmax for the
    sampled action only, the backward through the transposed weights.
    Returns the workspace, each lane's CE and the sampled distribution."""
    f32 = torch.float32
    x, xn = rows["obs"] * scale, rows["next_obs"] * scale
    act = rows["action"].to(torch.int64)
    B = x.shape[0]
    w = torch.ones(B) if weights is None else weights
    ft = FRB.rb_forward(tp, wt, xn)
    star = torch.argmax(FRB.rb_q(ft["dist"]), dim=-1)
    proj = FRB._projection(ft["dist"][torch.arange(B), star],
                           rows["reward"], rows["done"], gamma, faithful)

    (w0, b0, w1, b1), noisy = FRB._net(p, wp)
    h1 = FRB._dense(x, w0, b0, True)
    h2 = FRB._dense(h1, w1, b1, True)
    hv1 = FRB._dense(h2, *noisy[0], True)
    zv2 = FRB._dense(hv1, *noisy[1], False)
    ha1 = FRB._dense(h2, *noisy[2], True)
    adv = FRB._dense(ha1, *noisy[3], False).view(B, A, ATOMS)
    mean = FRB._seq_sum([adv[:, a] for a in range(A)]) * 0.2
    logit = (zv2 + adv[torch.arange(B), act]) - mean
    e = torch.exp(logit - torch.amax(logit, dim=-1, keepdim=True))
    d = e / FRB._seq_sum([e[:, j:j + 1] for j in range(ATOMS)])
    c = torch.clamp(d, 0.01, 0.99)
    inr = ((d > 0.01) & (d < 0.99)).to(f32)
    g = (-(proj / c) * inr) * (w * float(np.float32(1.0 / B)))[:, None]
    ce = -FRB._seq_sum([(proj * torch.log(c))[:, j] for j in range(ATOMS)])
    sv = FRB._seq_sum([(g * d)[:, j] for j in range(ATOMS)])
    dl = d * g - d * sv[:, None]
    onehot = (act[:, None] == torch.arange(A)).to(f32)
    dza2 = ((onehot - 0.2)[:, :, None] * dl[:, None, :]).reshape(B, -1)

    wpt = _transposed(p, wp)

    def wT(l, k):
        return wpt[FRB.T_OFF[l]:FRB.T_OFF[l] + k * H1].view(k, H1)
    dzv1 = _acc(dl, wT(1, ATOMS)) * _mask(hv1)
    dza1 = _acc(dza2, wT(3, A * ATOMS)) * _mask(ha1)
    dz2 = (_acc(dzv1, wT(0, H1)) + _acc(dza1, wT(2, H1))) * _mask(h2)
    w1t = wpt[FRB.T_OFF[4]:].view(H1, H0)
    dz1 = _acc(dz2, w1t) * _mask(h1)

    ws = FRB.new_workspace(B, CPU)
    cols = FRB.WS_COLS
    for name, v in (("x", x), ("h1", h1), ("h2", h2), ("hv1", hv1),
                    ("ha1", ha1), ("dz1", dz1), ("dz2", dz2),
                    ("dzv1", dzv1), ("dl", dl), ("dza1", dza1),
                    ("dza2", dza2)):
        ws[:, cols[name]:cols[name] + v.shape[1]] = v
    ws[:, cols["dl"] + ATOMS] = ce * w
    return ws, ce, d


def _regrouped(ws, B, threads):
    """Every job's sums rectangle by rectangle: per round of threads / 8
    summation tiles, each tile's sum over its learn_tile(B) lanes in order
    from 0, then the round's partials added into the total in tile
    order.  Returns the gradient in the NUM_G layout and the loss's sum."""
    tile = FRB.learn_tile(B)
    ntiles, groups = B // tile, threads // 8
    out = []
    for h, K, d, J, _ in JOBS:
        hc, dc = FRB.WS_COLS[h], FRB.WS_COLS[d]
        total = torch.zeros(K, J)
        for k0 in range(0, K, RECT_K):
            for j0 in range(0, J, RECT_J):
                k1, j1 = min(K, k0 + RECT_K), min(J, j0 + RECT_J)
                rect = torch.zeros(k1 - k0, j1 - j0)
                for q0 in range(0, ntiles, groups):
                    tiles = range(q0, min(ntiles, q0 + groups))
                    part = torch.zeros(len(tiles), k1 - k0, j1 - j0)
                    for r in range(tile):
                        lanes = ws[[t * tile + r for t in tiles]]
                        part = part + (lanes[:, hc + k0:hc + k1, None]
                                       * lanes[:, None, dc + j0:dc + j1])
                    for g in range(len(tiles)):
                        rect = rect + part[g]
                total[k0:k1, j0:j1] = rect
        out.append(total)
    grad = torch.cat([torch.cat([t[:K - 1, :width].reshape(-1),
                                 t[K - 1, :width]])
                      for t, (_, K, _, _, width) in zip(out, JOBS)])
    return grad, out[3][H1, ATOMS]


def _batch(B, seed):
    rng = np.random.default_rng(seed)
    cfg = RB.RainbowConfig(obs_scale=0.01, memory_capacity=8 * 128)
    c = FRB.fused_rainbow_init(seed, cfg, EnvParams(), 128, device=CPU)
    rows = {"obs": torch.tensor(rng.normal(0, 100, (B, 10)),
                                dtype=torch.float32),
            "next_obs": torch.tensor(rng.normal(0, 100, (B, 10)),
                                     dtype=torch.float32),
            "action": torch.tensor(rng.integers(0, A, B), dtype=torch.int32),
            "reward": torch.tensor(rng.uniform(-2, 2, B),
                                   dtype=torch.float32),
            "done": torch.tensor(rng.random(B) < 0.25)}
    p, tp = c["p"], c["p"] + torch.tensor(rng.normal(0, 0.01, FRB.NUM_P),
                                          dtype=torch.float32)
    wp = FRB.effective_weights(p, c["eps"])
    wt = FRB.effective_weights(tp, c["teps"])
    w = torch.tensor(rng.uniform(0.1, 1.0, B), dtype=torch.float32)
    return p, tp, wp, wt, rows, w


ORDER_CASES = [(B, faithful, per) for B in (32, 24)
               for faithful in (True, False) for per in (True, False)]


@pytest.mark.parametrize("B,faithful,per", ORDER_CASES + [(528, True, True)])
def test_kernel_grouping_equals_grads_plain(B, faithful, per):
    p, tp, wp, wt, rows, w = _batch(B, seed=B + 2 * faithful + per)
    weights = w if per else None
    grad, loss, ce = FRB._grads_plain(p, tp, wp, wt, rows, weights,
                                      gamma=0.9, obs_scale=0.01,
                                      faithful=faithful)
    ws, ce2, dsel = _kernel_rows(p, tp, wp, wt, rows, weights, 0.9, 0.01,
                                 faithful)
    # The online forward keeping only the sampled action's softmax.
    f = FRB.rb_forward(p, wp, rows["obs"] * 0.01)
    assert torch.equal(dsel, f["dist"][torch.arange(B),
                                       rows["action"].long()])
    assert torch.equal(ce2, ce)
    threads = FRB.learn_geometry(B, SMS).grad_threads
    got, loss_sum = _regrouped(ws, B, threads)
    assert got.shape == grad.shape == (FRB.NUM_G,)
    assert torch.equal(got, grad)
    assert torch.equal(FT.true_div(loss_sum, float(B)), loss)
    assert float(loss) > 0.0 and bool((grad != 0).any())
    if B == 528:  # 33 summation tiles: two rounds at 256 threads, one at 512
        assert threads == 256
        got2, _ = _regrouped(ws, B, 512)
        assert torch.equal(got2, grad)


def test_fused_adam_indices_match_the_plain_maps():
    """The gradient kernel updates, for a noisy element e, the mu and
    sigma that mu_sigma(e) names, and a trunk entry its own parameter:
    the maps _adam_full takes its gradients through."""
    mp = FRB._maps(CPU)
    mu, sg = torch.empty(FRB.NUM_E, dtype=torch.int64), torch.empty(
        FRB.NUM_E, dtype=torch.int64)
    for l, (eo, po, o) in enumerate(zip(FRB.E_OFF, FRB.P_OFF,
                                        FRB.NOISY_OUT)):
        w = H1 * o
        j = torch.arange(w + o)
        mu[eo + j] = torch.where(j < w, po + j, po + 2 * w + (j - w))
        sg[eo + j] = torch.where(j < w, po + w + j, po + 2 * w + o + (j - w))
    assert torch.equal(mu, mp["mu"]) and torch.equal(sg, mp["sig"])
    # Every parameter takes its gradient from exactly one entry.
    g_of = torch.cat([torch.arange(FRB.TRUNK_P), FRB.TRUNK_P + mu.argsort()])
    assert torch.equal(mp["g"][:FRB.TRUNK_P], torch.arange(FRB.TRUNK_P))
    assert g_of.shape[0] == FRB.NUM_G
    assert torch.equal(mp["g"][mu], FRB.TRUNK_P + torch.arange(FRB.NUM_E))
    assert torch.equal(mp["g"][sg], FRB.TRUNK_P + torch.arange(FRB.NUM_E))
    assert torch.equal(mp["e"][sg], torch.arange(FRB.NUM_E))


def test_rainbow_chunk_on_cpu_is_the_plain_version():
    cfg = RB.RainbowConfig(lr=1e-3, memory_capacity=4 * 128, obs_scale=0.01,
                           opponent="L0")
    ep = EnvParams(max_steps=20)
    carry = FRB.fused_rainbow_init(0, cfg, ep, 128, device=CPU)
    got = FRB.fused_rainbow_chunk(cfg, ep, carry, 3, 1, greedy=True)
    want = FRB.fused_rainbow_chunk_plain(cfg, ep, carry, 3, 1, greedy=True)
    assert got["learns"] == 2
    for k in want:
        if isinstance(want[k], torch.Tensor):
            assert torch.equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k


def test_learner_refuses_cpu_tensors():
    cfg = RB.RainbowConfig(memory_capacity=4 * 128)
    carry = FRB.fused_rainbow_init(0, cfg, EnvParams(), 128, device=CPU)
    st = FRB.working_state(carry)
    libs = dict(kernels._libs)
    with pytest.raises(ValueError, match="CUDA"):
        FRB.launch_rainbow(st, carry, cfg, EnvParams(), 1, 0, True, [0],
                           [0], [0.0])
    st["wpt"] = torch.zeros(FRB.NUM_T)
    with pytest.raises(ValueError, match="CUDA"):
        FRB.Learner(st, 128)
    assert kernels._libs == libs  # nothing was built or loaded
