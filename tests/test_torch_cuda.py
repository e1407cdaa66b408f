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
from merging_gym_tpu_torch.agents import dqn as D
from merging_gym_tpu_torch.agents import drqn as DR
from merging_gym_tpu_torch.agents import hdqn as H
from merging_gym_tpu_torch.agents import policies as P
from merging_gym_tpu_torch.agents import rainbow as RB
from merging_gym_tpu_torch.agents.evaluate import evaluate, evaluate_fused
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.core.geometry import lon2coord
from merging_gym_tpu_torch.io.checkpoint import load_params_npz
from merging_gym_tpu_torch.nn.lstm import drqn_init
from merging_gym_tpu_torch.nn.mlp import (qnet_apply, qnet_init,
                                          qnet_params_from_numpy)
from merging_gym_tpu_torch.ops import fused_actor as FA
from merging_gym_tpu_torch.ops import fused_drqn as FD
from merging_gym_tpu_torch.ops import fused_hdqn as FH
from merging_gym_tpu_torch.ops import fused_mlp as FM
from merging_gym_tpu_torch.ops import fused_policy_rollout as FPR
from merging_gym_tpu_torch.ops import fused_rainbow as FRB
from merging_gym_tpu_torch.ops import fused_rollout as FR
from merging_gym_tpu_torch.ops import fused_trainer as FT

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


# K1/K2 at the edges of their geometry (32 envs a block: 1, 31, 33, 300,
# 4,095, 4,096, 4,097 envs), T of 1, not a multiple of the 8-step fetch
# (37) and 512, with the default timeout and with 3-step episodes.
K1_K2_CASES = [(1, 1, None), (37, 31, 3), (37, 33, None), (512, 300, 3),
               (37, 4095, 3), (512, 4096, None), (1, 4097, 3),
               (37, 4097, None)]


@pytest.mark.parametrize("T,N,max_steps", K1_K2_CASES)
@pytest.mark.parametrize("mode", ["actions", "seed"])
def test_k1_k2_equal_plain(cuda, mode, T, N, max_steps):
    rng = np.random.default_rng(T + N)
    kw = ({"actions": torch.as_tensor(rng.integers(-1, 5, (T, 2, N)),
                                      dtype=torch.int32, device=cuda)}
          if mode == "actions" else {"seed": 9, "device": cuda})
    if max_steps is not None:
        kw["env_params"] = EnvParams(max_steps=max_steps)
    before = dict(kernels.launch_counts)
    k1 = FR.fused_rollout(T, N, **kw)
    _equal(k1, FR.fused_rollout_plain(T, N, **kw))
    k2 = FR.fused_rollout_counters(T, N, **kw)
    _equal(k2, FR.fused_rollout_counters_plain(T, N, **kw))
    assert kernels.launch_counts["env_rollout"] == before["env_rollout"] + 1
    assert kernels.launch_counts["env_counters"] == before["env_counters"] + 1
    d, w, c = k1["done"], k1["winner"], k1["collision"]
    assert torch.equal(k2["episodes"], d.sum(0).int())
    assert torch.equal(k2["wins1"], (d & (w == 1) & ~c).sum(0).int())
    if max_steps == 3:
        assert int(k2["episodes"].sum()) >= N * (T // 3)


def test_k1_k2_refuse_a_geometry_they_are_not_built_for(cuda):
    """Only 4 lanes x 128 threads and its block count: any other geometry
    is refused before the launch."""
    T, N = 8, 300
    g = FR.rollout_geometry(N)
    ep = EnvParams()
    out = FR.empty_rollout(T, N, cuda)
    rs = torch.empty(2, N, device=cuda)
    cs = torch.empty(4, N, dtype=torch.int32, device=cuda)
    FR.launch_rollout(out, None, 1, ep, g)
    FR.launch_counters(rs, cs, T, None, 1, ep, g)
    for bad in (g._replace(lanes=2), g._replace(threads=64),
                g._replace(threads=256), g._replace(blocks=g.blocks + 1),
                g._replace(blocks=g.blocks - 1)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            FR.launch_rollout(out, None, 1, ep, bad)
        with pytest.raises(RuntimeError, match="invalid argument"):
            FR.launch_counters(rs, cs, T, None, 1, ep, bad)


# Batches of K3 and K4: tails below one block and across a block boundary
# (1, 33, 77, 1,025), and the main paths' 256, 1,024 and 4,096, at the
# reference widths; and hidden widths 150 x 75, whose layers are no
# multiple of 8 elements (the weight buffers' alignment).
REF, ODD = (200, 100), (150, 75)
QNET_BATCHES = [(1, 10, REF), (33, 10, REF), (77, 11, REF), (256, 10, REF),
                (1024, 10, REF), (1025, 10, REF), (4096, 10, REF),
                (77, 11, ODD), (1025, 10, ODD)]


def _qnet_id(v):
    return "x".join(map(str, v)) if isinstance(v, tuple) else str(v)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,d_in,hidden", QNET_BATCHES, ids=_qnet_id)
def test_k3_equals_plain(cuda, compute_dtype, batch, d_in, hidden):
    p = qnet_init(torch.Generator(device=cuda).manual_seed(0), d_in, 5,
                  hidden=hidden)
    x = torch.randn(batch, d_in, device=cuda) * 100
    assert torch.equal(FM.qnet_apply_fused(p, x, compute_dtype),
                       FM.qnet_apply_plain(p, x, compute_dtype))


def test_k3_greedy_evaluate_equals_k6(cuda):
    """Greedy ``evaluate`` through K3 (qnet_tiled.cuh) picks the actions of
    greedy ``evaluate_fused`` through K6 (mlp.cuh): the two forwards give
    the same q bit for bit.  chip_smoke.py's check 4, on a shorter run."""
    p1 = qnet_params_from_numpy(load_params_npz("model_zoo/L2/params.npz"),
                                cuda)
    p2 = qnet_params_from_numpy(load_params_npz("model_zoo/L1/params.npz"),
                                cuda)
    short = EnvParams(max_steps=60)
    before = kernels.launch_counts["qnet_mlp"]
    loop = evaluate(P.q_policy(qnet_apply, p1, greedy=True),
                    P.q_policy(qnet_apply, p2, greedy=True), short,
                    torch.Generator(device=cuda).manual_seed(0),
                    num_envs=256, min_episodes=1, chunk_steps=64,
                    max_chunks=1)
    assert kernels.launch_counts["qnet_mlp"] - before >= 64
    fused = evaluate_fused(p1, p2, short, num_envs=256, num_steps=64,
                           greedy=True, device=cuda)
    assert loop["episodes"] > 0
    for k, v in loop.items():
        assert abs(v - fused[k]) <= 1e-5, (k, v, fused[k])


def test_k3_wide_net_uses_a_smaller_tile(cuda):
    p = qnet_init(torch.Generator(device=cuda).manual_seed(1), 10, 5,
                  hidden=(2048, 1024))
    x = torch.randn(70, 10, device=cuda)
    assert torch.equal(FM.qnet_apply_fused(p, x), FM.qnet_apply_plain(p, x))


# K6's cases: (steps, envs, player 2, kwargs, nets' hidden widths or None
# for model_zoo's L2 vs L1).  Every mode at 200 envs (2 a block); both
# nets resident in f32 and bf16 at 4,096 envs (32 a block) and at ragged
# 4,097 (a block of one env past 128 full ones); one net (L0); self-play;
# and nets too wide to stay resident (--hidden 1024 512), streamed every
# step, at a few steps.
K6_CASES = {
    "greedy_l0": (120, 200, "l0", dict(greedy=True), None),
    "greedy_selfplay": (120, 200, "self", dict(
        greedy=True, env_params=EnvParams(max_steps=50)), None),
    "phi": (120, 200, "l1", dict(greedy=False, seed=3), None),
    "random_start": (120, 200, "l1", dict(
        greedy=False, seed=4, env_params=EnvParams(random_start=True)), None),
    "bf16": (120, 200, "l1", dict(greedy=False, seed=5,
                                  compute_dtype="bfloat16"), None),
    "resident_4096": (120, 4096, "l1", dict(greedy=False, seed=6), None),
    "resident_4096_bf16": (120, 4096, "l1", dict(
        greedy=False, seed=7, compute_dtype="bfloat16"), None),
    "resident_4097": (120, 4097, "l1", dict(greedy=False, seed=8), None),
    "resident_4097_bf16": (120, 4097, "l1", dict(
        greedy=False, seed=9, compute_dtype="bfloat16"), None),
    "l0_4097": (120, 4097, "l0", dict(greedy=False, seed=10), None),
    "selfplay_4096": (120, 4096, "self", dict(greedy=False, seed=11), None),
    "streamed": (6, 4096, "other", dict(greedy=False, seed=12),
                 (1024, 512)),
    "streamed_bf16": (6, 4097, "other", dict(
        greedy=False, seed=13, compute_dtype="bfloat16"), (1024, 512)),
    "streamed_l0": (6, 200, "l0", dict(greedy=True), (1024, 512)),
}


def _k6_nets(cuda, hidden):
    if hidden is None:
        return [qnet_params_from_numpy(load_params_npz(
            f"model_zoo/L{i}/params.npz"), cuda) for i in (2, 1)]
    g = torch.Generator(device=cuda).manual_seed(6)
    return [qnet_init(g, 10, 5, hidden=hidden) for _ in range(2)]


@pytest.mark.parametrize("case", list(K6_CASES))
def test_k6_equals_plain(cuda, case):
    steps, envs, who, kw, hidden = K6_CASES[case]
    p1, p2 = _k6_nets(cuda, hidden)
    other = {"l0": None, "self": p1, "l1": p2, "other": p2}[who]
    elem = 2 if kw.get("compute_dtype") == "bfloat16" else 4
    g = FPR.policy_geometry(envs, (10, *(hidden or (200, 100)), 5), elem,
                            FM.sm_count(cuda), other is not None)
    assert g.resident == (hidden is None)
    before = kernels.launch_counts["policy_rollout"]
    got = FPR.fused_policy_rollout(steps, envs, p1, other, **kw)
    assert kernels.launch_counts["policy_rollout"] == before + 1
    _equal(got, FPR.fused_policy_rollout_plain(steps, envs, p1, other, **kw))


def test_k6_refuses_a_geometry_its_layout_does_not_fit(cuda):
    """The C side checks the host's geometry: shared memory short of its
    layout, more envs a block than it has owner threads for, or streamed
    buffers not 16-byte aligned or short of one k-row of the widest layer,
    are refused before the launch."""
    p1, p2 = _k6_nets(cuda, None)
    w1, w2 = (FM.cast_weights(p, torch.float32, cuda) for p in (p1, p2))
    out = FPR.empty_events(4, 256, cuda)
    kw = dict(greedy=True, epsilon=0.7, seed=0, env_params=EnvParams())
    g = FPR.policy_geometry(256, (10, 200, 100, 5), 4, FM.sm_count(cuda),
                            True)
    streamed = FPR.policy_tiling((10, 200, 100, 5), 32, 4, 2)._replace(
        resident=False, chunk=2048, smem=FPR.policy_smem(
            (10, 200, 100, 5), 32, 4, 2, False, 2048))
    for ok in (g, streamed):
        FPR.launch_policy_rollout(out, w1, w2, geometry=ok, **kw)
        _equal(FPR.as_events(out), FPR.fused_policy_rollout_plain(
            4, 256, p1, p2, greedy=True))
    for bad in (g._replace(smem=g.smem - 4), g._replace(rows=64),
                streamed._replace(chunk=2046), streamed._replace(chunk=192),
                streamed._replace(smem=streamed.smem - 16)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            FPR.launch_policy_rollout(out, w1, w2, geometry=bad, **kw)


def test_evaluate_fused_on_the_card_equals_the_numpy_reduction(cuda):
    """``evaluate_fused`` reduces the events on the card and reads back
    seven numbers; the JAX package's numpy reduction of the same events
    (the same launch, copied to the host) gives the same counts and mean
    returns to rtol 1e-6, at 4,096 envs x 768 steps (numpy's f32 sum runs
    in order over the steps, so its own error grows with their number:
    ~1e-6 relative at 2,600, which chip_smoke.py's eval_fused_split
    prints), and the card's return sums are within rtol 1e-6 of their f64
    sum."""
    p1, p2 = _k6_nets(cuda, None)
    kw = dict(greedy=False, seed=3)
    got = evaluate_fused(p1, p2, EnvParams(), num_envs=4096, num_steps=768,
                         device=cuda, **kw)
    ev = FPR.fused_policy_rollout(768, 4096, p1, p2, **kw)
    d, w, c, r = (ev[k].cpu().numpy() for k in ("done", "winner",
                                                "collision", "rewards"))
    assert got["episodes"] == int(d.sum()) >= 4096
    assert got["p1_first"] == int((d & (w == 1)).sum())
    assert got["p2_first"] == int((d & (w == 2)).sum())
    assert got["collisions"] == int((d & c).sum())
    assert got["timeouts"] == int((d & (w == 0) & ~c).sum())
    T = d.shape[0]
    last_done = np.where(d.any(axis=0), T - 1 - d[::-1].argmax(axis=0), -1)
    in_finished = np.arange(T)[:, None] <= last_done[None, :]
    mine = np.array([got["mean_return_p1"], got["mean_return_p2"]])
    for dtype in (np.float32, np.float64):
        ret = (r.astype(dtype) * in_finished[:, None, :]).sum(axis=(0, 2))
        np.testing.assert_allclose(mine, ret / got["episodes"], rtol=1e-6,
                                   atol=0.0, err_msg=str(dtype))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,d_in,hidden", QNET_BATCHES, ids=_qnet_id)
def test_k4_equals_plain(cuda, compute_dtype, batch, d_in, hidden):
    p = qnet_init(torch.Generator(device=cuda).manual_seed(2), d_in, 5,
                  hidden=hidden)
    x = torch.randn(batch, d_in, device=cuda) * 100
    before = kernels.launch_counts["fused_actor"]
    got = FA.fused_eps_greedy_actions(p, x, 11, 0.7, compute_dtype)
    assert kernels.launch_counts["fused_actor"] == before + 1
    assert torch.equal(got, FA.fused_eps_greedy_actions_plain(
        p, x, 11, 0.7, compute_dtype))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d_in,a", [(10, 3), (11, 5)])
def test_k3_k4_hdqn_nets_equal_plain(cuda, compute_dtype, d_in, a):
    """The h-DQN meta (10 -> 3) and low (11 -> 5) nets at the batches of
    the h-DQN main paths: 256 envs evaluated (K3), 1,024 trained (K4)."""
    p = qnet_init(torch.Generator(device=cuda).manual_seed(3), d_in, a)
    x = torch.randn(256, d_in, device=cuda) * 100
    assert torch.equal(FM.qnet_apply_fused(p, x, compute_dtype),
                       FM.qnet_apply_plain(p, x, compute_dtype))
    x = torch.randn(1024, d_in, device=cuda) * 100
    assert torch.equal(
        FA.fused_eps_greedy_actions(p, x, 11, 0.7, compute_dtype),
        FA.fused_eps_greedy_actions_plain(p, x, 11, 0.7, compute_dtype))


def _race_rows(rows, n, cuda, seed):
    """Env rows with mid-race starts: a short run crosses wins,
    collisions and resets."""
    rng = np.random.default_rng(seed)
    pos = torch.tensor(rng.uniform(870, 948, (2, n)), dtype=torch.float32,
                       device=cuda)
    vel = torch.tensor(rng.uniform(5, 40, (2, n)), dtype=torch.float32,
                       device=cuda)
    rows = rows.clone()
    rows[0:2], rows[2:4] = pos, vel
    rows[4:6] = torch.stack(lon2coord(pos[0], 1.0))
    rows[6:8] = torch.stack(lon2coord(pos[1], -1.0))
    return rows


def _race_carry(cfg, ep, n, cuda, **kw):
    carry = FT.fused_dqn_init(0, cfg, ep, n, device=cuda, **kw)
    for k in ("p", "tp"):  # small centred weights: decisive argmax
        carry[k] = tuple((a - a.mean()) * 0.05 for a in carry[k])
    if cfg.opponent != "frozen":
        carry["opp"] = carry["p"]
    carry["env"] = _race_rows(carry["env"], n, cuda, 1)
    return carry


@pytest.mark.parametrize("case", ["selfplay_greedy", "l0_windows", "bf16",
                                  "phi_random_start", "frozen_opponent"])
def test_k5_equals_plain_and_repeats(cuda, case):
    n = 256
    cfg = D.DQNConfig(lr=1e-3, target_sync=3, memory_capacity=3 * n,
                      opponent="selfplay")
    ep, kw, greedy = EnvParams(max_steps=40), {}, True
    if case == "l0_windows":
        cfg = cfg.replace(opponent="L0")
        kw = dict(learn_batch=256, learn_rounds=2)
    elif case == "bf16":
        cfg = cfg.replace(compute_dtype="bfloat16")
    elif case == "phi_random_start":
        ep, greedy = EnvParams(max_steps=20, random_start=True), False
    elif case == "frozen_opponent":
        cfg = cfg.replace(opponent="frozen")
        kw = dict(opp_params=qnet_init(
            torch.Generator(device=cuda).manual_seed(5), 10, 5))
    carry = _race_carry(cfg, ep, n, cuda, **kw)
    got = want = again = carry
    before = kernels.launch_counts["dqn_learn_grad"]
    for seed, T in enumerate((1, 15)):  # the first chunk is below warm-up
        got = FT.fused_dqn_chunk(cfg, ep, got, T, seed, greedy=greedy)
        want = FT.fused_dqn_chunk_plain(cfg, ep, want, T, seed,
                                        greedy=greedy)
        again = FT.fused_dqn_chunk(cfg, ep, again, T, seed, greedy=greedy)
    learns = kernels.launch_counts["dqn_learn_grad"] - before
    assert learns == 2 * got["learns"]
    assert got["learns"] == 14 and got["episodes"] > 0
    for k in ("env", "ring"):
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], again[k]), k
    for k in ("p", "tp", "m", "v"):
        for a, b, c in zip(got[k], want[k], again[k]):
            assert torch.equal(a, b) and torch.equal(a, c), k
    for k in ("episodes", "collisions", "wins", "sum_ep_reward", "last_loss"):
        assert got[k] == want[k] == again[k], k


def _hdqn_race_carry(cfg, ep, n, cuda, **kw):
    carry = FH.fused_hdqn_init(0, cfg, ep, n, device=cuda, **kw)
    for k in ("u_p", "u_tp", "l_p", "l_tp"):  # decisive argmax
        carry[k] = tuple((a - a.mean()) * 0.05 for a in carry[k])
    if cfg.opponent != "frozen":
        carry["opp_u"], carry["opp_l"] = carry["u_p"], carry["l_p"]
    carry["state"] = _race_rows(carry["state"], n, cuda, 2)
    return carry


@pytest.mark.parametrize("case", ["l0_greedy", "selfplay_greedy", "frozen",
                                  "lane_window", "bf16", "phi_random_start"])
def test_k7_equals_plain_and_repeats(cuda, case):
    n = 256
    cfg = H.HDQNConfig(lr=1e-3, target_sync=3, memory_capacity=3 * n,
                       goal_memory_capacity=2 * n, opponent="selfplay")
    ep, kw, greedy = EnvParams(max_steps=40), {}, True
    if case == "l0_greedy":
        cfg = cfg.replace(opponent="L0")
    elif case == "frozen":
        cfg = cfg.replace(opponent="frozen")
        g = torch.Generator(device=cuda).manual_seed(5)
        kw = dict(opp_upper=qnet_init(g, 10, 3), opp_lower=qnet_init(g, 11, 5))
    elif case == "lane_window":
        kw = dict(learn_batch=128)
    elif case == "bf16":
        cfg = cfg.replace(compute_dtype="bfloat16")
    elif case == "phi_random_start":
        ep, greedy = EnvParams(max_steps=20, random_start=True), False
    carry = _hdqn_race_carry(cfg, ep, n, cuda, **kw)
    got = want = again = carry
    before = dict(kernels.launch_counts)
    for seed, T in enumerate((1, 15)):  # the first chunk is below warm-up
        got = FH.fused_hdqn_chunk(cfg, ep, got, T, seed, greedy=greedy)
        want = FH.fused_hdqn_chunk_plain(cfg, ep, want, T, seed,
                                         greedy=greedy)
        again = FH.fused_hdqn_chunk(cfg, ep, again, T, seed, greedy=greedy)
    counts = {k: kernels.launch_counts[k] - before[k]
              for k in kernels.launch_counts}
    assert counts["hdqn_act_env_store"] == 2 * 16
    assert counts["hdqn_learn_grad_lower"] == 2 * got["lo_learns"] == 2 * 14
    assert counts["hdqn_learn_grad_upper"] == 2 * 15  # issued from step R_up-1
    assert FH.upper_learns(got["state"]) > 0 and got["episodes"] > 0
    for k in ("state", "lo_ring", "up_ring"):
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], again[k]), k
    for k in FH.SETS[:8]:
        for a, b, c in zip(got[k], want[k], again[k]):
            assert torch.equal(a, b) and torch.equal(a, c), k
    for k in ("lo_learns", "episodes", "collisions", "wins", "sum_ep_reward",
              "last_loss"):
        assert got[k] == want[k] == again[k], k


def _chunks_equal_and_repeat(chunk, plain, carry, keys, sets, scalars):
    """Two chunks (1 step, below warm-up, then 15) of the kernels, of the
    plain version and of the kernels again: every tensor and scalar
    equal bit for bit."""
    got = want = again = carry
    for seed, T in enumerate((1, 15)):
        got = chunk(got, T, seed)
        want = plain(want, T, seed)
        again = chunk(again, T, seed)
    for k in keys:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], again[k]), k
    for k in sets:
        for a, b, c in zip(got[k], want[k], again[k]):
            assert torch.equal(a, b) and torch.equal(a, c), k
    for k in scalars:
        assert got[k] == want[k] == again[k], k
    return got


# The learner at the training CLI's shape (1,024 envs, B 1,024), at odd
# widths (--hidden 150 75), and at a width whose summation tile is below
# 16 lanes (1024 x 512: learn_tile 8 in f32).
@pytest.mark.parametrize("case", ["cli_1024", "hidden_150_75_f32",
                                  "hidden_150_75_bf16", "wide_tile_8"])
def test_k5_learner_shapes_equal_plain_and_repeat(cuda, case):
    n = 1024 if case == "cli_1024" else 256
    cfg = D.DQNConfig(lr=1e-3, target_sync=3, memory_capacity=3 * n,
                      opponent="L0")
    if case.startswith("hidden"):
        dtype = "bfloat16" if case.endswith("bf16") else "float32"
        cfg = cfg.replace(hidden=(150, 75), compute_dtype=dtype)
    elif case == "wide_tile_8":
        cfg = cfg.replace(hidden=(1024, 512))
        assert FT.learn_tile((10, 1024, 512, 5), 4) == 8
    ep = EnvParams(max_steps=40)
    before = dict(kernels.launch_counts)
    got = _chunks_equal_and_repeat(
        lambda c, T, s: FT.fused_dqn_chunk(cfg, ep, c, T, s, greedy=True),
        lambda c, T, s: FT.fused_dqn_chunk_plain(cfg, ep, c, T, s,
                                                 greedy=True),
        _race_carry(cfg, ep, n, cuda), ("env", "ring"), ("p", "tp", "m", "v"),
        ("episodes", "collisions", "wins", "sum_ep_reward", "last_loss"))
    assert got["learns"] == 14 and got["episodes"] > 0
    for k in ("dqn_learn_fwd", "dqn_learn_grad"):
        assert kernels.launch_counts[k] - before[k] == 2 * 14


def test_k7_cli_shape_equals_plain_and_repeats(cuda):
    n = 1024
    cfg = H.HDQNConfig(lr=1e-3, target_sync=3, memory_capacity=3 * n,
                       goal_memory_capacity=2 * n, opponent="L0")
    ep = EnvParams(max_steps=40)
    got = _chunks_equal_and_repeat(
        lambda c, T, s: FH.fused_hdqn_chunk(cfg, ep, c, T, s, greedy=True),
        lambda c, T, s: FH.fused_hdqn_chunk_plain(cfg, ep, c, T, s,
                                                  greedy=True),
        _hdqn_race_carry(cfg, ep, n, cuda), ("state", "lo_ring", "up_ring"),
        FH.SETS[:8], ("lo_learns", "episodes", "collisions", "wins",
                      "sum_ep_reward", "last_loss"))
    assert FH.upper_learns(got["state"]) > 0 and got["episodes"] > 0


def _snapshot(carry):
    return {k: [t.clone() for t in carry[k]] if isinstance(carry[k], tuple)
            else carry[k].clone() for k in ("p", "tp", "m", "v", "env", "ring")}


def _unchanged(carry, snap):
    for k, want in snap.items():
        got = carry[k]
        if isinstance(got, tuple):
            assert all(torch.equal(a, b) for a, b in zip(got, want)), k
        else:
            assert torch.equal(got, want), k


def _carries_equal(got, want):
    for k in ("env", "ring"):
        assert torch.equal(got[k], want[k]), k
    for k in ("p", "tp", "m", "v"):
        for a, b in zip(got[k], want[k]):
            assert torch.equal(a, b), k
    for k in ("steps", "learns", "episodes", "collisions", "wins",
              "sum_ep_reward", "last_loss"):
        assert got[k] == want[k], k


# K5's fully warm chunks as replays of one CUDA graph (ChunkGraph): after
# the warm-up chunk (issued launch by launch), five 200-step chunks -- the
# first issued launch by launch, the second captured, four replays -- cross
# target syncs (every 150 learns) and episode ends, bit for bit with the
# plain version; no chunk's carry changes when the next one runs.
@pytest.mark.parametrize("case", ["l0_f32", "l0_bf16", "selfplay_phi",
                                  "frozen_bf16"])
def test_k5_chunk_graph_equals_plain(cuda, case):
    n, T = 256, 200
    opponent = {"l0": "L0", "selfplay": "selfplay",
                "frozen": "frozen"}[case.split("_")[0]]
    cfg = D.DQNConfig(lr=1e-3, target_sync=150, memory_capacity=3 * n,
                      opponent=opponent,
                      compute_dtype="bfloat16" if "bf16" in case
                      else "float32")
    kw = {}
    if opponent == "frozen":
        kw = dict(opp_params=qnet_init(
            torch.Generator(device=cuda).manual_seed(5), 10, 5))
    ep, greedy = EnvParams(max_steps=40), case != "selfplay_phi"
    FT._GRAPH.update(graph=None, seen=None)
    carry = _race_carry(cfg, ep, n, cuda, **kw)
    got = FT.fused_dqn_chunk(cfg, ep, carry, 2, 0, greedy=greedy)
    want = FT.fused_dqn_chunk_plain(cfg, ep, carry, 2, 0, greedy=greedy)
    assert got["warm"] and FT.fully_warm(got, T)
    graphs, launches = dict(kernels.graph_counts), dict(kernels.launch_counts)
    returned = [(carry, _snapshot(carry))]
    for seed in range(1, 6):
        returned.append((got, _snapshot(got)))
        got = FT.fused_dqn_chunk(cfg, ep, got, T, seed, greedy=greedy)
        want = FT.fused_dqn_chunk_plain(cfg, ep, want, T, seed,
                                        greedy=greedy)
        _carries_equal(got, want)
        for c, snap in returned:
            _unchanged(c, snap)
    assert got["learns"] == 5 * T and got["episodes"] > 0
    assert {k: kernels.graph_counts[k] - graphs[k] for k in graphs} == {
        "dqn_chunk_capture": 1, "dqn_chunk_replay": 4}
    for k in FT.K5_KERNELS:
        assert kernels.launch_counts[k] - launches[k] == 5 * T, k


def test_k5_chunk_graph_reruns_an_older_carry(cuda):
    """After a run of graph chunks (the next chunk of a run leaves its env
    and ring uncopied), a chunk from an older carry, which the graph's
    state no longer holds, gives what it gave the first time, bit for
    bit, and so does the chunk after it."""
    n, T = 256, 20
    cfg = D.DQNConfig(lr=1e-3, target_sync=7, memory_capacity=2 * n,
                      opponent="L0")
    ep = EnvParams(max_steps=40)
    FT._GRAPH.update(graph=None, seen=None)
    carries = [FT.fused_dqn_chunk_plain(cfg, ep, _race_carry(cfg, ep, n, cuda),
                                        1, 0, greedy=True)]
    graphs = dict(kernels.graph_counts)
    for seed in range(1, 5):
        carries.append(FT.fused_dqn_chunk(cfg, ep, carries[-1], T, seed,
                                          greedy=True))
    again = FT.fused_dqn_chunk(cfg, ep, carries[2], T, 3, greedy=True)
    _carries_equal(again, carries[3])
    _carries_equal(FT.fused_dqn_chunk(cfg, ep, again, T, 4, greedy=True),
                   carries[4])
    assert {k: kernels.graph_counts[k] - graphs[k] for k in graphs} == {
        "dqn_chunk_capture": 1, "dqn_chunk_replay": 5}


def test_k5_chunk_graph_per_shape(cuda):
    """A 4,096-env carry gets a graph of its own after a 256-env one: two
    chunks of each, the second of each shape captured and replayed, bit
    for bit with the plain version; the graph kept is the last shape's;
    and the vectorised bias table is the scalar one on this host."""
    cfg = D.DQNConfig(lr=1e-3, target_sync=3, opponent="L0")
    ep = EnvParams(max_steps=40)
    FT._GRAPH.update(graph=None, seen=None)
    graphs = dict(kernels.graph_counts)
    for n in (256, 4096):
        ncfg = cfg.replace(memory_capacity=2 * n)
        got = want = FT.fused_dqn_chunk_plain(
            ncfg, ep, _race_carry(ncfg, ep, n, cuda), 1, 0, greedy=True)
        for seed in (1, 2):
            got = FT.fused_dqn_chunk(ncfg, ep, got, 20, seed, greedy=True)
            want = FT.fused_dqn_chunk_plain(ncfg, ep, want, 20, seed,
                                            greedy=True)
            _carries_equal(got, want)
        assert FT._GRAPH["graph"].key[2] == n
    assert {k: kernels.graph_counts[k] - graphs[k] for k in graphs} == {
        "dqn_chunk_capture": 2, "dqn_chunk_replay": 2}
    t = torch.arange(1, 5001)
    want = torch.tensor([FT.adam_bias_corrections(int(x)) for x in t],
                        dtype=torch.float32)
    assert torch.equal(FT.bias_table(0, 5000).view(torch.int32),
                       want.view(torch.int32))


# The act kernels of K5 and K7 (act_tiled.cuh) at the training CLI's 1,024
# envs, 8 a block in 128 blocks, against each opponent (self-play: both
# seats in one pass of 16 rows; frozen: the opponent's nets streamed); with
# a partial last block (an explicit 24 envs a block: 43 blocks, the last
# with 16 envs, since the rule's power-of-two rows divide every env count
# the trainers take, a multiple of 128); and with nets too wide to stay in
# shared memory (--hidden 1024 512), streamed: (envs, opponent, rows or
# None for the rule's, hidden widths).
ACT_CASES = {"cli_l0": (1024, "L0", None, (200, 100)),
             "cli_selfplay": (1024, "selfplay", None, (200, 100)),
             "cli_frozen": (1024, "frozen", None, (200, 100)),
             "last_block_16_of_24": (1024, "selfplay", 24, (200, 100)),
             "streamed_1024x512": (256, "selfplay", None, (1024, 512))}


def _act_geometry(cuda, monkeypatch, case, nets):
    """The act geometry of ``case`` for ``nets``, installed in place of the
    rule's where the case names its rows; checked against the case."""
    n, opponent, rows, hidden = ACT_CASES[case]
    seats, frozen = FT.act_seats(opponent)
    g = FT.act_geometry(n, nets, 4, FM.sm_count(cuda), seats, frozen)
    if rows is not None:
        g = FT.act_tiling(nets, rows, 4, seats, frozen)
        monkeypatch.setattr(FT, "act_geometry", lambda *args: g)
        assert (-(-n // g.rows), n % g.rows) == (43, 16)
    elif n == 1024:
        assert (g.rows, g.resident) == (8, len(nets))
    else:
        assert g.resident == 0 and g.chunk > 0
    return g


@pytest.mark.parametrize("case", list(ACT_CASES))
def test_k5_act_geometries_equal_plain_and_repeat(cuda, monkeypatch, case):
    n, opponent, _, hidden = ACT_CASES[case]
    cfg = D.DQNConfig(lr=1e-3, target_sync=3, memory_capacity=3 * n,
                      opponent=opponent, hidden=hidden)
    kw = {}
    if opponent == "frozen":
        kw = dict(opp_params=qnet_init(
            torch.Generator(device=cuda).manual_seed(5), 10, 5))
    _act_geometry(cuda, monkeypatch, case, ((10, *hidden, 5),))
    ep = EnvParams(max_steps=40)
    before = kernels.launch_counts["dqn_act_env_store"]
    got = _chunks_equal_and_repeat(
        lambda c, T, s: FT.fused_dqn_chunk(cfg, ep, c, T, s, greedy=True),
        lambda c, T, s: FT.fused_dqn_chunk_plain(cfg, ep, c, T, s,
                                                 greedy=True),
        _race_carry(cfg, ep, n, cuda, **kw), ("env", "ring"),
        ("p", "tp", "m", "v"),
        ("episodes", "collisions", "wins", "sum_ep_reward", "last_loss"))
    assert got["learns"] == 14 and got["episodes"] > 0
    assert kernels.launch_counts["dqn_act_env_store"] - before == 2 * 16


@pytest.mark.parametrize("case", list(ACT_CASES))
def test_k7_act_geometries_equal_plain_and_repeat(cuda, monkeypatch, case):
    n, opponent, _, hidden = ACT_CASES[case]
    cfg = H.HDQNConfig(lr=1e-3, target_sync=3, memory_capacity=3 * n,
                       goal_memory_capacity=2 * n, opponent=opponent,
                       hidden=hidden)
    kw = {}
    if opponent == "frozen":
        g = torch.Generator(device=cuda).manual_seed(5)
        kw = dict(opp_upper=qnet_init(g, 10, 3), opp_lower=qnet_init(g, 11, 5))
    _act_geometry(cuda, monkeypatch, case,
                  ((10, *hidden, 3), (11, *hidden, 5)))
    ep = EnvParams(max_steps=40)
    before = kernels.launch_counts["hdqn_act_env_store"]
    got = _chunks_equal_and_repeat(
        lambda c, T, s: FH.fused_hdqn_chunk(cfg, ep, c, T, s, greedy=True),
        lambda c, T, s: FH.fused_hdqn_chunk_plain(cfg, ep, c, T, s,
                                                  greedy=True),
        _hdqn_race_carry(cfg, ep, n, cuda, **kw),
        ("state", "lo_ring", "up_ring"), FH.SETS[:8],
        ("lo_learns", "episodes", "collisions", "wins", "sum_ep_reward",
         "last_loss"))
    assert FH.upper_learns(got["state"]) > 0 and got["episodes"] > 0
    assert kernels.launch_counts["hdqn_act_env_store"] - before == 2 * 16


def _act_refusals(g, streamed, nets):
    """Geometries the act kernels' layout cannot hold: shared memory short
    of it, more envs a block than owner threads, more nets held than the
    kernel has, a micro-tile it does not instantiate, streamed buffers not
    16-byte aligned or short of one k-row of the widest layer."""
    return (g._replace(smem=g.smem - 4), g._replace(rows=64),
            g._replace(resident=nets + 1), g._replace(rm=3),
            streamed._replace(chunk=2046), streamed._replace(chunk=192),
            streamed._replace(smem=streamed.smem - 16))


def test_k5_act_refuses_a_geometry_its_layout_does_not_fit(cuda):
    """The C side checks the host's geometry before the launch; the
    geometries it takes give the plain version's step."""
    n = 256
    cfg = D.DQNConfig(lr=1e-3, target_sync=3, memory_capacity=3 * n,
                      opponent="selfplay")
    ep = EnvParams(max_steps=40)
    carry = _race_carry(cfg, ep, n, cuda)
    want = FT.fused_dqn_chunk_plain(cfg, ep, carry, 1, 0, greedy=True)
    nets = ((10, 200, 100, 5),)
    g = FT.act_geometry(n, nets, 4, FM.sm_count(cuda), 2)
    streamed = FT.act_tiling(nets, 8, 4, 2, resident=0)
    z = np.zeros(1, np.int32)

    def step(geom):  # step 0 of a cold carry: the act kernel alone
        st = FT.working_state(carry, torch.float32)
        FT.launch_trainer(st, carry, cfg, ep, 1, 0, True, z, z,
                          act_geom=geom)
        return st
    for ok in (g, streamed):
        st = step(ok)
        assert torch.equal(st["env"], want["env"])
        assert torch.equal(st["ring"], want["ring"])
    for bad in _act_refusals(g, streamed, 1):
        with pytest.raises(RuntimeError, match="invalid argument"):
            step(bad)


def test_k7_act_refuses_a_geometry_its_layout_does_not_fit(cuda):
    """As for K5, with K7's two nets (held, one held, both streamed)."""
    n = 256
    cfg = H.HDQNConfig(lr=1e-3, target_sync=3, memory_capacity=3 * n,
                       goal_memory_capacity=2 * n, opponent="selfplay")
    ep = EnvParams(max_steps=40)
    carry = _hdqn_race_carry(cfg, ep, n, cuda)
    want = FH.fused_hdqn_chunk_plain(cfg, ep, carry, 1, 0, greedy=True)
    nets = ((10, 200, 100, 3), (11, 200, 100, 5))
    g = FT.act_geometry(n, nets, 4, FM.sm_count(cuda), 2)
    streamed = FT.act_tiling(nets, 8, 4, 2, resident=0)
    z = np.zeros(1, np.int64)

    def step(geom):  # step 0 of a cold carry: the act kernel alone
        st = FH.working_state(carry, torch.float32)
        FH.launch_hdqn(st, carry, cfg, ep, 1, 0, True, z, z,
                       np.zeros(2, np.int64), act_geom=geom)
        return st
    for ok in (g, FT.act_tiling(nets, 8, 4, 2, resident=1), streamed):
        st = step(ok)
        for k in ("state", "lo_ring", "up_ring"):
            assert torch.equal(st[k], want[k]), k
    for bad in _act_refusals(g, streamed, 2):
        with pytest.raises(RuntimeError, match="invalid argument"):
            step(bad)


# K7's upper learner under its device gate (dqn_trainer.cu:DevGate) at
# step 2 of a chunk, with target_sync 3: shut (any_end[2] == 0, nothing
# moves), open after one earlier learn (count prior + 1 = 1: no sync,
# Adam's step 2), and open at count 3 (the target syncs first).
@pytest.mark.parametrize("case", ["shut", "open", "open_sync"])
def test_k7_upper_learner_gate(cuda, case):
    dims, n, num_f = (10, 200, 100, 3), 256, FH.UP_F
    cfg = H.HDQNConfig(lr=1e-3, target_sync=3)
    rng = np.random.default_rng(7)
    P = sum(a * b + b for a, b in zip(dims[:3], dims[1:]))

    def flat(scale):
        return torch.as_tensor(rng.standard_normal(P) * scale,
                               dtype=torch.float32, device=cuda)
    st = {"p": flat(0.1), "tp": flat(0.1), "m": flat(1e-3),
          "v": flat(1e-3).abs()}
    st["pc"], st["tpc"] = st["p"], st["tp"]
    ring = rng.standard_normal((2 * num_f, n)) * 50
    for r in range(2):
        ring[r * num_f + 20] = rng.integers(0, 3, n)      # action (goal)
        ring[r * num_f + 22] = rng.integers(0, 2, n)      # done
    ring = torch.as_tensor(ring, dtype=torch.float32, device=cuda)
    any_end = torch.tensor([1, 0, 0 if case == "shut" else 1, 0],
                           dtype=torch.int32, device=cuda)
    prior = 2 if case == "open_sync" else 0
    bias = torch.tensor([FT.adam_bias_corrections(prior + 1 + k)
                         for k in range(4)], dtype=torch.float32,
                        device=cuda)
    want = {k: v.clone() for k, v in st.items()}
    want["pc"], want["tpc"] = want["p"], want["tp"]
    loss = torch.zeros((), device=cuda)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    zero = torch.zeros(1, dtype=torch.int32, device=cuda)
    before = dict(kernels.launch_counts)
    FT.Learner(st, "", dims, n, 1, cfg, cuda).launch(
        ring, num_f, one, zero, loss,
        ("hdqn_learn_fwd_upper", "hdqn_learn_grad_upper"),
        gate=(any_end, bias, 2, 0, prior))
    torch.cuda.synchronize()
    assert kernels.launch_counts["hdqn_learn_grad_upper"] == \
        before["hdqn_learn_grad_upper"] + 1
    if case == "shut":
        for k in ("p", "tp", "m", "v"):
            assert torch.equal(st[k], want[k]), k
        assert float(loss) == 0.0
        return
    batch = FT.ring_batch(ring, [1], [0], n, num_f, dims[0])
    # One learn before this one in the chunk (step 0): count prior + 1.
    want_loss = FT.learn_plain(want, "", batch, (prior + 1) % 3 == 0,
                               prior + 2, cfg, dims)
    for k in ("p", "tp", "m", "v"):
        assert torch.equal(st[k], want[k]), k
    assert torch.equal(loss, want_loss)


@pytest.mark.parametrize("case", ["selfplay_greedy", "l0_textbook_window",
                                  "per_3step", "frozen_phi_random_start"])
def test_k8_equals_plain_and_repeats(cuda, case):
    n = 256
    cfg = RB.RainbowConfig(lr=1e-3, gamma=0.9, target_sync_episodes=3,
                           memory_capacity=4 * n, obs_scale=0.01)
    ep, kw, greedy = EnvParams(max_steps=40), {}, True
    if case == "l0_textbook_window":
        cfg = cfg.replace(opponent="L0", faithful_c51=False, obs_scale=None)
        kw = dict(learn_batch=128)
    elif case == "per_3step":
        cfg = cfg.replace(per=True, n_step=3, batch_size=40)
    elif case == "frozen_phi_random_start":
        cfg = cfg.replace(opponent="frozen", epsilon=0.5)
        kw = dict(opp_params=qnet_init(
            torch.Generator(device=cuda).manual_seed(5), 10, 5))
        ep, greedy = EnvParams(max_steps=12, random_start=True), False
    carry = FRB.fused_rainbow_init(0, cfg, ep, n, device=cuda, **kw)
    if greedy:
        carry["env"] = _race_rows(carry["env"], n, cuda, 3)
    got = want = again = carry
    before = dict(kernels.launch_counts)
    for seed, T in enumerate((1, 15)):  # the first chunk is below warm-up
        got = FRB.fused_rainbow_chunk(cfg, ep, got, T, seed, greedy=greedy)
        want = FRB.fused_rainbow_chunk_plain(cfg, ep, want, T, seed,
                                             greedy=greedy)
        again = FRB.fused_rainbow_chunk(cfg, ep, again, T, seed,
                                        greedy=greedy)
    counts = {k: kernels.launch_counts[k] - before[k]
              for k in kernels.launch_counts}
    assert got["learns"] == 16 - cfg.n_step and got["episodes"] > 0
    assert counts["rainbow_act"] == 2 * 16
    assert counts["rainbow_learn_fwd"] == 2 * got["learns"]
    assert counts["rainbow_learn_grad"] == 2 * got["learns"]
    assert counts["rainbow_per_pick"] == (2 * got["learns"] if cfg.per else 0)
    assert "rainbow_adam" not in counts and "rainbow_learn" not in counts
    for k in ("p", "tp", "m", "v", "eps", "teps", "env", "ring"):
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], again[k]), k
    for k in ("episodes", "collisions", "wins", "sum_ep_reward", "last_loss"):
        assert got[k] == want[k] == again[k], k


# K8's learner at the batches its kernels must take: the training CLI's (B
# 1,024 at 1,024 envs), learn_batch 512, the PER batch 32 and a PER batch of
# 24, whose summation tile is 8.  Each runs warm-up and ten learning steps.
K8_SHAPES = {"cli_1024": dict(n=1024),
             "learn_batch_512": dict(n=1024, learn_batch=512),
             "per_32": dict(n=256, per=True, batch_size=32),
             "per_24_tile_8": dict(n=256, per=True, batch_size=24)}
K8_KEYS = ("p", "tp", "m", "v", "eps", "teps", "env", "ring")


def _k8_case(cuda, n, per=False, batch_size=32, learn_batch=None, n_step=1):
    cfg = RB.RainbowConfig(lr=1e-3, gamma=0.9, target_sync_episodes=3,
                           memory_capacity=4 * n, obs_scale=0.01, per=per,
                           batch_size=batch_size, n_step=n_step)
    ep = EnvParams(max_steps=40)
    kw = {} if learn_batch is None else dict(learn_batch=learn_batch)
    carry = FRB.fused_rainbow_init(0, cfg, ep, n, device=cuda, **kw)
    carry["env"] = _race_rows(carry["env"], n, cuda, 6)
    return cfg, ep, carry


@pytest.mark.parametrize("case", list(K8_SHAPES))
def test_k8_learner_batches_equal_plain_and_repeat(cuda, case):
    cfg, ep, carry = _k8_case(cuda, **K8_SHAPES[case])
    B = carry["B"]
    assert B == {"cli_1024": 1024, "learn_batch_512": 512, "per_32": 32,
                 "per_24_tile_8": 24}[case]
    assert FRB.learn_tile(B) == (8 if case == "per_24_tile_8" else 16)
    warm = FRB.fused_rainbow_chunk(cfg, ep, carry, cfg.n_step, 0,
                                   greedy=True)
    before = dict(kernels.launch_counts)
    got = FRB.fused_rainbow_chunk(cfg, ep, warm, 10, 1, greedy=True)
    counts = {k: kernels.launch_counts[k] - before[k]
              for k in kernels.launch_counts}
    want = FRB.fused_rainbow_chunk_plain(cfg, ep, warm, 10, 1, greedy=True)
    again = FRB.fused_rainbow_chunk(cfg, ep, warm, 10, 1, greedy=True)
    assert got["learns"] - warm["learns"] == 10
    # One post before the first step forms the effective weights; then 4
    # launches a learning step, 5 with PER.
    per_step = (sum(v for k, v in counts.items() if k.startswith("rainbow_"))
                - 1) / 10
    assert per_step == (5 if cfg.per else 4)
    for k in K8_KEYS:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], again[k]), k
    for k in ("episodes", "collisions", "wins", "sum_ep_reward", "last_loss"):
        assert got[k] == want[k] == again[k], k
    assert got["last_loss"] > 0.0


@pytest.mark.parametrize("lanes", FRB.LEARN_LANES)
@pytest.mark.parametrize("threads", FRB.GRAD_THREADS)
def test_k8_every_learner_geometry_equals_plain(cuda, lanes, threads):
    """Each geometry of chip_smoke.py's rb_learn_sweep, at B 1,024: a
    warm carry's four learning steps equal the plain version's, twice."""
    cfg, ep, carry = _k8_case(cuda, 1024)
    warm = FRB.fused_rainbow_chunk(cfg, ep, carry, 2, 0, greedy=True)
    g = FRB.learn_tiling(1024, lanes, threads)
    rounds, cols, us = FRB._prepare(cfg, ep, warm, 4, 1, True, None, None,
                                    None)
    want = FRB.fused_rainbow_chunk_plain(cfg, ep, warm, 4, 1, greedy=True)
    for _ in range(2):
        st = FRB.working_state(warm)
        FRB.launch_rainbow(st, warm, cfg, ep, 4, 1, True, rounds, cols, us,
                           geometry=g)
        for k in K8_KEYS:
            assert torch.equal(st[k], want[k]), k
        assert float(st["loss"]) == want["last_loss"] > 0.0


def test_k8_refuses_a_geometry_its_layout_does_not_fit(cuda):
    """The C side checks the host's geometry: shared memory short of the
    forward's layout or of the gradient kernel's partials, or more lanes
    a block than it was built for, is refused before the launch."""
    cfg, ep, carry = _k8_case(cuda, 128)
    warm = FRB.fused_rainbow_chunk(cfg, ep, carry, 2, 0, greedy=True)
    g = FRB.learn_geometry(128, FM.sm_count(cuda))
    args = (warm, cfg, ep, 1, 1, True, [0], [0], [0.0])
    FRB.launch_rainbow(FRB.working_state(warm), *args, geometry=g)
    for bad in (g._replace(smem=g.smem - 4),
                g._replace(grad_smem=g.grad_smem - 4),
                g._replace(lanes=16, smem=FRB.learn_smem(16))):
        with pytest.raises(RuntimeError, match="invalid argument"):
            FRB.launch_rainbow(FRB.working_state(warm), *args, geometry=bad)


# The act kernel of K8 (rainbow_trainer.cu:rb_act_kernel) at the training
# CLI's 1,024 envs, where the rule gives 8 envs a block in 128 blocks with
# the online net held, here forced to 24 envs a block (43 blocks, the last
# with 16: the rule's power-of-two rows divide every env count the
# trainers take), against each opponent and with PER 3-step: (opponent,
# PER 3-step).
K8_ACT_CASES = {"l0_last_block_16_of_24": ("L0", False),
                "selfplay_last_block_16_of_24": ("selfplay", False),
                "frozen_last_block_16_of_24": ("frozen", False),
                "per_3step_last_block_16_of_24": ("selfplay", True)}


@pytest.mark.parametrize("case", list(K8_ACT_CASES))
def test_k8_act_partial_last_block_equals_plain_and_repeats(cuda, case):
    opponent, per = K8_ACT_CASES[case]
    n = 1024
    cfg = RB.RainbowConfig(lr=1e-3, gamma=0.9, target_sync_episodes=3,
                           memory_capacity=4 * n, obs_scale=0.01,
                           opponent=opponent)
    if per:
        cfg = cfg.replace(per=True, n_step=3, batch_size=40)
    kw = {}
    if opponent == "frozen":
        kw = dict(opp_params=qnet_init(
            torch.Generator(device=cuda).manual_seed(5), 10, 5))
    ep = EnvParams(max_steps=40)
    carry = FRB.fused_rainbow_init(0, cfg, ep, n, device=cuda, **kw)
    carry["env"] = _race_rows(carry["env"], n, cuda, 7)
    seats = 2 if opponent == "selfplay" else 1
    od = FT._dims(carry["opp"]) if opponent == "frozen" else None
    rule = FRB.act_geometry(n, FM.sm_count(cuda), seats, od)
    assert (rule.rows, rule.resident, -(-n // rule.rows)) == (8, 1, 128)
    g = FRB.act_tiling(24, seats, od)
    assert (-(-n // g.rows), n % g.rows) == (43, 16)
    got = want = again = carry
    before = kernels.launch_counts["rainbow_act"]
    for seed, T in enumerate((1, 12)):
        got = FRB.fused_rainbow_chunk(cfg, ep, got, T, seed, greedy=True,
                                      act_geom=g)
        want = FRB.fused_rainbow_chunk_plain(cfg, ep, want, T, seed,
                                             greedy=True)
        again = FRB.fused_rainbow_chunk(cfg, ep, again, T, seed,
                                        greedy=True, act_geom=g)
    assert kernels.launch_counts["rainbow_act"] - before == 2 * 13
    assert got["learns"] == 13 - cfg.n_step and got["episodes"] > 0
    for k in K8_KEYS:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], again[k]), k
    for k in ("episodes", "collisions", "wins", "sum_ep_reward", "last_loss"):
        assert got[k] == want[k] == again[k], k


def test_k8_act_refuses_a_geometry_its_layout_does_not_fit(cuda):
    """The C side checks the act kernel's geometry before the launch:
    shared memory short of its layout, more envs a block than owner
    threads, a held-net count other than 0 or 1, a micro-tile it does not
    instantiate, buffers without a frozen opponent, and a frozen
    opponent's buffers not 16-byte sized or short of one k-row of its
    widest layer.  The geometries it takes (the net held or read from
    global memory) give the plain version's step."""
    n = 256
    cfg = RB.RainbowConfig(gamma=0.9, memory_capacity=4 * n, obs_scale=0.01)
    ep = EnvParams(max_steps=40)
    fcfg = cfg.replace(opponent="frozen")
    opp = qnet_init(torch.Generator(device=cuda).manual_seed(5), 10, 5)
    carries = {c.opponent: FRB.fused_rainbow_init(
        0, c, ep, n, opp if c is fcfg else None, device=cuda)
        for c in (cfg, fcfg)}
    assert cfg.opponent == "selfplay"
    od = FT._dims(carries["frozen"]["opp"])
    g, gf = FRB.act_tiling(8, 2), FRB.act_tiling(8, 1, od)
    for c, ok in ((cfg, g), (cfg, FRB.act_tiling(8, 2, resident=0)),
                  (fcfg, gf), (fcfg, FRB.act_tiling(8, 1, od, resident=0))):
        carry = carries[c.opponent]
        got = FRB.fused_rainbow_chunk(c, ep, carry, 1, 0, greedy=True,
                                      act_geom=ok)
        want = FRB.fused_rainbow_chunk_plain(c, ep, carry, 1, 0, greedy=True)
        for k in ("env", "ring"):
            assert torch.equal(got[k], want[k]), k
    for c, bad in ((cfg, g._replace(smem=g.smem - 4)),
                   (cfg, g._replace(rows=64)), (cfg, g._replace(resident=2)),
                   (cfg, g._replace(rm=3)), (cfg, g._replace(chunk=256)),
                   (fcfg, gf._replace(chunk=gf.chunk - 2)),
                   (fcfg, gf._replace(chunk=96)),
                   (fcfg, gf._replace(smem=gf.smem - 16))):
        with pytest.raises(RuntimeError, match="invalid argument"):
            FRB.fused_rainbow_chunk(c, ep, carries[c.opponent], 1, 0,
                                    greedy=True, act_geom=bad)


def _shrink_drqn(flat):
    """Each of the twelve arrays centred and scaled by 0.05: a decisive
    argmax (tests/test_fused_drqn_e2e.py:_shrink)."""
    return FD.drqn_params_to_t({
        layer: {k: (x - x.mean()) * 0.05 for k, x in p.items()}
        for layer, p in FD.t_to_drqn_params(flat).items()})


@pytest.mark.parametrize("case", ["selfplay_greedy", "l0_lane_window",
                                  "frozen", "phi_random_start"])
def test_k9_equals_plain_and_repeats(cuda, case):
    n, L = 256, 4
    cfg = DR.DRQNConfig(lr=1e-3, gamma=0.9, target_sync=3, seq_len=L,
                        burn_in=1, memory_capacity=2 * n,
                        opponent="selfplay")
    ep, kw, greedy = EnvParams(max_steps=20), {}, True
    if case == "l0_lane_window":
        cfg = cfg.replace(opponent="L0", burn_in=0)
        kw = dict(learn_batch=128)
    elif case == "frozen":
        cfg = cfg.replace(opponent="frozen")
        kw = dict(opp_params=drqn_init(
            torch.Generator(device=cuda).manual_seed(5), 10, 5))
    elif case == "phi_random_start":
        ep, greedy = EnvParams(max_steps=12, random_start=True), False
    carry = FD.fused_drqn_init(0, cfg, ep, n, device=cuda, **kw)
    carry["p"], carry["tp"] = _shrink_drqn(carry["p"]), _shrink_drqn(
        carry["tp"])
    if case == "frozen":
        carry["opp"] = _shrink_drqn(carry["opp"])
    if greedy:
        carry["env"][0:8] = _race_rows(carry["env"], n, cuda, 4)[0:8]
        carry["win"][0:10] = FD._obs_rows(carry["env"][0:8])
    got = want = again = carry
    before = dict(kernels.launch_counts)
    # The first chunk ends mid-window and inside the R * L - 1 = 7 step
    # warm-up.
    for seed, T in enumerate((3, 13)):
        got = FD.fused_drqn_chunk(cfg, ep, got, T, seed, greedy=greedy)
        want = FD.fused_drqn_chunk_plain(cfg, ep, want, T, seed,
                                         greedy=greedy)
        again = FD.fused_drqn_chunk(cfg, ep, again, T, seed, greedy=greedy)
    counts = {k: kernels.launch_counts[k] - before[k]
              for k in kernels.launch_counts}
    assert got["learns"] == 16 - 7 and got["episodes"] > 0
    assert counts["drqn_act"] == 2 * 16
    assert counts["drqn_learn_in"] == counts["drqn_learn_rec"] == \
        counts["drqn_learn_grad"] == 2 * 9
    for k in ("p", "tp", "m", "v", "env", "win", "ring"):
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], again[k]), k
    for k in ("episodes", "collisions", "wins", "sum_ep_reward", "last_loss"):
        assert got[k] == want[k] == again[k], k


# K9's learner at the shapes its kernels must take: the training CLI's (L
# 16, burn-in 4, B 1,024 at 1,024 envs), L 1 and L 8, burn-in 0, burn-in
# >= L (every step masked, so msum is floored at 1 and the loss is 0), B 4
# (a single summation tile), B 4,096 at 4,096 envs, and a target sync on
# every learn.  Each runs the 2 L - 1 warm-up steps and four learns.
K9_SHAPES = {"cli_1024": dict(n=1024, L=16, burn_in=4),
             "L1": dict(n=256, L=1, burn_in=0),
             "L8": dict(n=256, L=8, burn_in=2),
             "burn_in_0": dict(n=256, L=4, burn_in=0),
             "burn_in_ge_L": dict(n=256, L=4, burn_in=4),
             "B4": dict(n=128, L=4, burn_in=1, B=4),
             "B4096": dict(n=4096, L=4, burn_in=1),
             "sync_every_learn": dict(n=256, L=4, burn_in=1, sync=1)}


@pytest.mark.parametrize("case", list(K9_SHAPES))
def test_k9_learner_shapes_equal_plain_and_repeat(cuda, case):
    kw = K9_SHAPES[case]
    n, L = kw["n"], kw["L"]
    cfg = DR.DRQNConfig(lr=1e-3, gamma=0.9, target_sync=kw.get("sync", 3),
                        seq_len=L, burn_in=kw["burn_in"],
                        memory_capacity=2 * n, opponent="selfplay")
    ep = EnvParams(max_steps=20)
    carry = FD.fused_drqn_init(0, cfg, ep, n, device=cuda)
    carry["p"], carry["tp"] = _shrink_drqn(carry["p"]), _shrink_drqn(
        carry["tp"])
    carry["opp"] = carry["p"]
    carry["env"][0:8] = _race_rows(carry["env"], n, cuda, 5)[0:8]
    carry["win"][0:10] = FD._obs_rows(carry["env"][0:8])
    carry["B"] = kw.get("B", n)
    T = 2 * L - 1 + 4
    before = dict(kernels.launch_counts)
    got = FD.fused_drqn_chunk(cfg, ep, carry, T, 0, greedy=True)
    want = FD.fused_drqn_chunk_plain(cfg, ep, carry, T, 0, greedy=True)
    again = FD.fused_drqn_chunk(cfg, ep, carry, T, 0, greedy=True)
    assert got["learns"] == 4 and got["episodes"] > 0
    for k in ("drqn_learn_in", "drqn_learn_rec", "drqn_learn_grad"):
        assert kernels.launch_counts[k] - before[k] == 2 * 4, k
    for k in ("p", "tp", "m", "v", "env", "win", "ring"):
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], again[k]), k
    for k in ("episodes", "collisions", "wins", "sum_ep_reward", "last_loss"):
        assert got[k] == want[k] == again[k], k
    if case == "burn_in_ge_L":
        assert got["last_loss"] == 0.0
    else:
        assert got["last_loss"] > 0.0


def test_k9_refuses_a_geometry_its_layout_does_not_fit(cuda):
    """The C side checks the host's geometry: shared memory short of the
    input side's or the recurrence's layout is refused before the
    launch."""
    cfg = DR.DRQNConfig(seq_len=4, burn_in=1, memory_capacity=256)
    carry = FD.fused_drqn_init(0, cfg, EnvParams(), 128, device=cuda)
    st = FD.working_state(carry)
    g = FD.learn_geometry(128, 4, FM.sm_count(cuda))
    FD.Learner(st, 128, 4, g).launch(cfg, 0, 0, False, 1)
    for bad in (g._replace(in_smem=g.in_smem - 16),
                g._replace(rec_smem=g.rec_smem - 4),
                g._replace(rec_windows=8)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            FD.Learner(st, 128, 4, bad).launch(cfg, 0, 0, False, 1)


# The act kernel of K9 (drqn_trainer.cu:act_kernel) at the training CLI's
# 1,024 envs, where the rule gives 8 envs a block in 128 blocks with every
# net held, here forced to 24 envs a block (43 blocks, the last with 16),
# against each opponent.
K9_ACT_CASES = ("L0", "selfplay", "frozen")


@pytest.mark.parametrize("opponent", K9_ACT_CASES)
def test_k9_act_partial_last_block_equals_plain_and_repeats(cuda, opponent):
    n, L = 1024, 4
    cfg = DR.DRQNConfig(lr=1e-3, gamma=0.9, target_sync=3, seq_len=L,
                        burn_in=1, memory_capacity=2 * n, opponent=opponent)
    ep, kw = EnvParams(max_steps=20), {}
    if opponent == "frozen":
        kw = dict(opp_params=drqn_init(
            torch.Generator(device=cuda).manual_seed(5), 10, 5))
    carry = FD.fused_drqn_init(0, cfg, ep, n, device=cuda, **kw)
    carry["p"], carry["tp"] = _shrink_drqn(carry["p"]), _shrink_drqn(
        carry["tp"])
    carry["opp"] = (_shrink_drqn(carry["opp"]) if opponent == "frozen"
                    else carry["p"])
    carry["env"][0:8] = _race_rows(carry["env"], n, cuda, 8)[0:8]
    carry["win"][0:10] = FD._obs_rows(carry["env"][0:8])
    seats, nets = FD.act_seats(opponent)
    rule = FD.act_geometry(n, FM.sm_count(cuda), seats, nets)
    assert (rule.rows, rule.resident, -(-n // rule.rows)) == (8, nets, 128)
    g = FD.act_tiling(24, seats, nets)
    assert (-(-n // g.rows), n % g.rows) == (43, 16)
    got = want = again = carry
    before = kernels.launch_counts["drqn_act"]
    for seed, T in enumerate((3, 13)):
        got = FD.fused_drqn_chunk(cfg, ep, got, T, seed, greedy=True,
                                  act_geom=g)
        want = FD.fused_drqn_chunk_plain(cfg, ep, want, T, seed, greedy=True)
        again = FD.fused_drqn_chunk(cfg, ep, again, T, seed, greedy=True,
                                    act_geom=g)
    assert kernels.launch_counts["drqn_act"] - before == 2 * 16
    assert got["learns"] == 16 - 7 and got["episodes"] > 0
    for k in ("p", "tp", "m", "v", "env", "win", "ring"):
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], again[k]), k
    for k in ("episodes", "collisions", "wins", "sum_ep_reward", "last_loss"):
        assert got[k] == want[k] == again[k], k


def test_k9_act_refuses_a_geometry_its_layout_does_not_fit(cuda):
    """The C side checks the act kernel's geometry before the launch:
    shared memory short of its layout, more envs a block than owner
    threads, more nets held than the launch has, a micro-tile it does not
    instantiate, and streaming buffers (it has none).  The geometries it
    takes (each count of nets held) give the plain version's step."""
    n = 256
    cfg = DR.DRQNConfig(seq_len=4, burn_in=1, memory_capacity=2 * n,
                        opponent="frozen")
    ep = EnvParams(max_steps=20)
    carry = FD.fused_drqn_init(0, cfg, ep, n, device=cuda, opp_params=(
        drqn_init(torch.Generator(device=cuda).manual_seed(5), 10, 5)))
    want = FD.fused_drqn_chunk_plain(cfg, ep, carry, 1, 0, greedy=True)
    for held in (0, 1, 2):
        got = FD.fused_drqn_chunk(cfg, ep, carry, 1, 0, greedy=True,
                                  act_geom=FD.act_tiling(8, 2, 2, held))
        for k in ("env", "win"):
            assert torch.equal(got[k], want[k]), k
    g = FD.act_tiling(8, 2, 2)
    for bad in (g._replace(smem=g.smem - 4), g._replace(rows=64),
                g._replace(resident=3), g._replace(rm=3),
                g._replace(chunk=8)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            FD.fused_drqn_chunk(cfg, ep, carry, 1, 0, greedy=True,
                                act_geom=bad)


def test_k3_refuses_a_geometry_its_layout_does_not_fit(cuda):
    """The C side checks the host's geometry: shared memory short of its
    layout, or a second weight buffer not 16-byte aligned, is refused
    before the launch."""
    p = qnet_init(torch.Generator(device=cuda).manual_seed(0), 10, 5)
    w = FM.cast_weights(p, torch.float32, cuda)
    x, q = torch.zeros(4, 10, device=cuda), torch.zeros(4, 5, device=cuda)
    g = FM.qnet_geometry(4, (10, 200, 100, 5), 4, FM.sm_count(cuda))
    FM.launch_mlp(w, x, q, g)
    for bad in (g._replace(smem=g.smem - 16), g._replace(chunk=g.chunk - 2)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            FM.launch_mlp(w, x, q, bad)


def test_kernels_refuse_mixed_devices(cuda):
    p = qnet_init(torch.Generator(device=cuda).manual_seed(0), 10, 5)
    with pytest.raises(ValueError, match="CUDA device"):
        FM.launch_mlp(FM.cast_weights(p, torch.float32, cuda),
                      torch.zeros(4, 10), torch.zeros(4, 5, device=cuda))


# K8's rb_post and rb_per_pick alone (rainbow_trainer.cu) against their
# plain versions (ops/fused_rainbow.py:post_plain, pick_plain), bit for bit.
# The post at the training CLI's 1,024 lanes, R 8, PER's B 32: (step i,
# regen, per_wb, check_sync, the step's finished episodes: 30 passes the
# sync rule from a total of 37, 0 does not).
RB_POST_MODES = {"chunk_opening": (0, 0, 0, 0, 0), **{
    f"regen{r}_sync{s}_per_wb{w}": (3, r, w, 1, 30 * s)
    for r in (0, 1) for s in (0, 1) for w in (0, 1)}}


def _rb_post_state(cuda, n=1024, R=8, B=32, seed=21):
    rng = np.random.default_rng(seed)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=cuda)
    st = {"p": f32(rng.standard_normal(FRB.NUM_P) * 0.1),
          "tp": f32(rng.standard_normal(FRB.NUM_P) * 0.1),
          "eps": f32(rng.standard_normal(FRB.NUM_E)),
          "teps": f32(rng.standard_normal(FRB.NUM_E)),
          "env": f32(rng.random((FRB.ENV_ROWS, n))),
          "ring": f32(rng.random((R * FRB.NUM_F, n))),
          "wp": torch.full((FRB.NUM_E,), float("nan"), device=cuda),
          "wt": torch.full((FRB.NUM_E,), float("nan"), device=cuda),
          "wpt": torch.full((FRB.NUM_T,), float("nan"), device=cuda)}
    sel = torch.as_tensor(np.stack([rng.integers(0, R, B),
                                    rng.integers(0, n, B)]),
                          dtype=torch.int32, device=cuda)
    ce = f32(rng.random(B) * 3)
    sel[:, 1], ce[1] = sel[:, 0], ce[0]  # a duplicate pick, the same CE
    return st, sel, ce


def _rb_post_run(cuda, st, sel, ce, mode, geometry=None, plain=False):
    i, regen, per_wb, check_sync, ep = mode
    tot = torch.zeros(5, dtype=torch.int32, device=cuda)
    tot[i] = 37
    ep_step = torch.zeros(4, dtype=torch.int32, device=cuda)
    ep_step[i] = ep
    st = {k: v.clone() for k, v in st.items()}
    key, inv = FRB.philox.seed_key(77), float(np.float32(1 / 20))
    if plain:
        FRB.post_plain(st, tot, ep_step, ce, sel, i=i, regen=regen,
                       per_wb=per_wb, check_sync=check_sync, gstep=11,
                       key=key, alpha=0.6, inv_sync=inv, synced0=1.0)
    else:
        FRB.post_launcher(st, tot, ep_step, ce, sel, sel.shape[1], key, 0.6,
                          inv, 1.0, geometry)(i, regen, per_wb, check_sync,
                                              11)
    st["tot"] = tot
    return st


@pytest.mark.parametrize("mode", list(RB_POST_MODES))
def test_rb_post_alone_equals_plain_twice(cuda, mode):
    st, sel, ce = _rb_post_state(cuda)
    want = _rb_post_run(cuda, st, sel, ce, RB_POST_MODES[mode], plain=True)
    before = kernels.launch_counts["rainbow_post"]
    for _ in range(2):
        got = _rb_post_run(cuda, st, sel, ce, RB_POST_MODES[mode])
        _equal(got, want)
    assert kernels.launch_counts["rainbow_post"] - before == 2
    assert torch.equal(want["tp"], st["p"]) == mode.startswith(
        ("regen0_sync1", "regen1_sync1"))


def test_rb_post_refuses_a_geometry_its_layout_does_not_fit(cuda):
    """Any geometry but the one the kernel is built for (16 x 32 tiles, 256
    threads, the tiles' blocks plus one): refused before the launch."""
    st, sel, ce = _rb_post_state(cuda, n=256, R=4, B=8)
    g = FRB.post_geometry()
    mode = RB_POST_MODES["regen1_sync0_per_wb1"]
    _rb_post_run(cuda, st, sel, ce, mode, g)
    for bad in (g._replace(blocks=g.blocks + 1), g._replace(threads=128),
                g._replace(threads=512), g._replace(ti=8),
                g._replace(ti=32), g._replace(to=64)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            _rb_post_run(cuda, st, sel, ce, mode, bad)


def _pick_ring(cuda, R, n, kind, seed):
    rng = np.random.default_rng(seed)
    ring = rng.random((R * FRB.NUM_F, n)).astype(np.float32)
    P = rng.random((R, n)).astype(np.float32) * 2
    if kind == "zeros":  # zero slots, an empty chunk, an empty round
        P[rng.random((R, n)) < 0.3] = 0.0
        P[0, :128 if n > 128 else 0] = 0.0
        P[R - 1] = 0.0
    elif kind == "tied":
        P[:] = 0.25
    elif kind == "dominant":
        P *= 1e-6
        P[R // 2, n - 1] = 1e3
    ring[FRB.NUM_F - 1::FRB.NUM_F] = P
    return torch.as_tensor(ring, device=cuda)


def _pick_run(cuda, ring, B, geometry=None):
    R, n = ring.shape[0] // FRB.NUM_F, ring.shape[1]
    us = torch.tensor([0.61], device=cuda)
    sel = torch.zeros(2, B, dtype=torch.int32, device=cuda)
    wts = torch.zeros(B, device=cuda)
    FRB.pick_launcher(ring, sel, wts, B, 3, 0.4, geometry)(R // 2, R, us)
    return (sel, wts), FRB.pick_plain(ring, us, R, n, B, R // 2, R, 3, 0.4)


# (R, n, B): the CLI's PER shape, a small ring, a batch of 1,024 and a grid
# too large for shared memory (the global cdf), each on four grids; the
# first two in the global layout too.
RB_PICK_CASES = [(*s, kind, None) for s in ((8, 1024, 32), (4, 128, 8),
                                            (8, 1024, 1024), (16, 4096, 32))
                 for kind in ("random", "zeros", "tied", "dominant")] + [
    (8, 1024, 32, "zeros", FRB.PICK_GLOBAL),
    (4, 128, 8, "dominant", FRB.PICK_GLOBAL)]


@pytest.mark.parametrize("R,n,B,kind,layout", RB_PICK_CASES)
def test_rb_per_pick_alone_equals_plain(cuda, R, n, B, kind, layout):
    g = (FRB.pick_geometry(R, n) if layout is None
         else FRB.pick_tiling(R, n, layout))
    assert g.layout == (FRB.PICK_GLOBAL if (R, n) == (16, 4096)
                        else layout or FRB.PICK_SHARED)
    ring = _pick_ring(cuda, R, n, kind, R * n + B)
    before = kernels.launch_counts["rainbow_per_pick"]
    for _ in range(2):
        (sel, wts), (want_sel, want_w) = _pick_run(cuda, ring, B, g)
        assert torch.equal(sel, want_sel) and torch.equal(wts, want_w)
    assert kernels.launch_counts["rainbow_per_pick"] - before == 2
    assert torch.isfinite(wts).all()


def test_rb_per_pick_refuses_a_layout_it_does_not_fit(cuda):
    """The shared layout with less shared memory than its grid or more
    than a block has (R 16, n 4,096), the global one with a short
    workspace or with shared memory, and an unknown layout: refused before
    the launch."""
    ring = _pick_ring(cuda, 8, 1024, "random", 1)
    g = FRB.pick_geometry(8, 1024)
    big = _pick_ring(cuda, 16, 4096, "random", 2)
    gg = FRB.pick_tiling(8, 1024, FRB.PICK_GLOBAL)
    for r, bad in ((ring, g._replace(smem=g.smem - 4)),
                   (big, FRB.PickGeometry(FRB.PICK_SHARED,
                                          4 * FRB.pick_floats(16, 4096), 0)),
                   (ring, gg._replace(ws_floats=gg.ws_floats - 1)),
                   (ring, gg._replace(smem=16)), (ring, g._replace(layout=2))):
        with pytest.raises(RuntimeError, match="invalid argument"):
            _pick_run(cuda, r, 32, bad)
