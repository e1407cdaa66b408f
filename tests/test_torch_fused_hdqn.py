"""K7 of the PyTorch port (plain version, on the CPU) against the JAX
package's ``ops.fused_hdqn`` kernel in interpret mode, from the same
carried-across carry (``hdqn_carry_from_numpy``).

Greedy mode with host-supplied ``lo_rounds``/``up_rounds``/``cols``
streams is deterministic in both packages, so whole chunks are held at
the tolerances of ``tests/test_fused_hdqn_e2e.py:225-254``: winner, goal,
opponent goal and option flags exact, the upper learn counter in state
row 15 exact, ``lo_learns`` and the metrics exact; positions, option and
episode returns to 1e-4 (positions with the 2-ulp allowance of ROADMAP
Queue 3), rings to 1e-4, all eight learner sets to rtol 2e-3, atol 2e-4,
the loss to rtol 1e-3.  The nets are that file's ``_shrink6``-ed ones
from ``_race`` starts (:46-75), so the argmax is decisive and the runs
cross wins, collisions and resets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merging_gym_tpu.agents.hdqn import HDQNConfig as JHDQNConfig
from merging_gym_tpu.core.env import EnvParams as JEnvParams
from merging_gym_tpu.core.geometry import lon2coord as jax_lon2coord
from merging_gym_tpu.nn.mlp import qnet_init as jax_qnet_init
from merging_gym_tpu.ops import fused_hdqn as JFH
from merging_gym_tpu.ops import fused_trainer as JFT
from merging_gym_tpu_torch.agents.hdqn import HDQNConfig
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.ops import fused_hdqn as FH
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def _interpret_mode():
    from jax.experimental import pallas as pl

    mp = pytest.MonkeyPatch()
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    mp.setattr(JFH.pl, "pallas_call", patched)
    yield
    mp.undo()


def _shrink6(t):
    return tuple((a - jnp.mean(a)) * 0.05 for a in t)


def _race(n, seed):
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(870.0, 948.0, n),
                    rng.uniform(870.0, 948.0, n)]).astype(np.float32)
    vel = np.stack([rng.uniform(5.0, 40.0, n),
                    rng.uniform(5.0, 40.0, n)]).astype(np.float32)
    return pos, vel


def _mk(cfg, ep, n, seed, race, learn_batch=None, frozen=None):
    """tests/test_fused_hdqn_e2e.py:_mk (a frozen opponent's nets given
    as ``frozen``)."""
    carry = JFH.fused_hdqn_init(jax.random.key(seed), cfg, ep, n,
                                opp_upper=frozen and frozen[0],
                                opp_lower=frozen and frozen[1],
                                learn_batch=learn_batch)
    for k in ("u_p", "u_tp", "l_p", "l_tp"):
        carry[k] = _shrink6(carry[k])
    if frozen is None:
        carry["opp_u"], carry["opp_l"] = carry["u_p"], carry["l_p"]
    pos, vel = race
    st = np.asarray(carry["state"]).copy()
    st[0:2], st[2:4] = pos, vel
    x1, y1 = jax_lon2coord(jnp.asarray(pos[0]), +1.0)
    x2, y2 = jax_lon2coord(jnp.asarray(pos[1]), -1.0)
    st[4:8] = np.stack([np.asarray(x1), np.asarray(y1),
                        np.asarray(x2), np.asarray(y2)])
    carry["state"] = jnp.asarray(st)
    return carry


def _frozen_nets(seed):
    def net(k, d_in, d_out):
        p = jax_qnet_init(jax.random.key(k), d_in, d_out)
        return jax.tree.map(lambda w: (w - jnp.mean(w)) * 0.05, p)
    return net(seed, 10, 3), net(seed + 1, 11, 5)


def _port_cfg(jcfg):
    return HDQNConfig(**{f: getattr(jcfg, f) for f in (
        "lr", "gamma", "target_sync", "memory_capacity",
        "goal_memory_capacity", "opponent", "hidden", "compute_dtype",
        "mask_terminal", "epsilon")})


def _run(chunk_fn, cfg, ep, carry, lo_rounds, up_rounds, cols, splits):
    T, lo = len(lo_rounds), 0
    for hi in splits + [T]:
        carry = chunk_fn(cfg, ep, carry, hi - lo, seed=0, greedy=True,
                         lo_rounds=lo_rounds[lo:hi],
                         up_rounds=up_rounds[lo:hi],
                         cols=None if cols is None else cols[2 * lo:2 * hi])
        lo = hi
    return carry


def _upper_count(state):
    return int(np.asarray(state, np.float32)[15][0:1].view(np.int32)[0])


def _check(got, want):
    g, w = got["state"].numpy(), np.asarray(want["state"])
    # XLA:CPU contracts pos + vel * DT into an FMA, the port rounds twice
    # (ROADMAP Queue 3): near 1,000 m an ulp is 6e-5, so beside the 1e-4
    # of tests/test_fused_hdqn_e2e.py two ulps are allowed.
    np.testing.assert_allclose(g[0:4], w[0:4], rtol=2.5e-7, atol=1e-4,
                               err_msg="pos/vel")
    for row, what in ((8, "winner"), (9, "t"), (11, "goal"),
                      (12, "opponent goal"), (14, "option start")):
        np.testing.assert_array_equal(g[row], w[row], err_msg=what)
    np.testing.assert_allclose(g[13], w[13], rtol=0, atol=1e-4,
                               err_msg="option return")
    np.testing.assert_allclose(g[10], w[10], rtol=0, atol=1e-4,
                               err_msg="episode reward")
    assert _upper_count(g) == _upper_count(w), "upper learn counter"
    for k in ("lo_ring", "up_ring"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    for k in FH.SETS[:8]:
        for i, (a, b) in enumerate(zip(got[k], want[k])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3,
                                       atol=2e-4, err_msg=f"{k}[{i}]")
    for k in ("lo_learns", "steps", "warm_lo", "warm_up", "env_steps",
              "episodes", "collisions", "wins"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["sum_ep_reward"], want["sum_ep_reward"],
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["last_loss"], want["last_loss"],
                               rtol=1e-3, atol=1e-6)


CASES = {
    # name: (n, R_lo, T, learn_batch, opponent, target_sync, max_steps,
    #        splits, seed, race seed, stream seed); R_up is 2 throughout.
    # tests/test_fused_hdqn_e2e.py:199-254: the 1-step first launch is
    # shorter than the R-1 = 1 step warm-up of both rings.
    "l0_cold_then_warm": (128, 2, 26, None, JFT.OPP_L0, 4, 25, [1], 2, 500,
                          55),
    # The CLI's ring sizes, R_lo = 4 and R_up = 2: the two rings warm up at
    # different steps (the launch at step 2 is warm above, cold below), and
    # the launch at step 11 starts both rings mid-cycle (base 11 % 8 = 3).
    "l0_rings_4_and_2": (128, 4, 16, None, JFT.OPP_L0, 4, 25, [1, 2, 11], 3,
                         600, 65),
    # :257-291, both lane windows drawn for both learners.
    "l0_lane_window": (256, 2, 20, 128, JFT.OPP_L0, 3, 20, [], 6, 900, 77),
    # Opponent modes the JAX kernel supports and its tests leave out.
    "selfplay": (128, 2, 10, None, JFT.OPP_SELFPLAY, 3, 20, [4], 8, 300, 31),
    "frozen": (128, 2, 10, None, JFT.OPP_FROZEN, 3, 20, [], 9, 400, 41),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunks_match_pallas_kernel(_interpret_mode, case):
    (n, R_lo, T, B, opp, sync, max_steps, splits, seed, race_seed,
     rs) = CASES[case]
    jcfg = JHDQNConfig(lr=1e-3, gamma=0.9, target_sync=sync,
                       memory_capacity=R_lo * n, goal_memory_capacity=2 * n,
                       opponent=opp)
    jep, ep = JEnvParams(max_steps=max_steps), EnvParams(max_steps=max_steps)
    rng = np.random.default_rng(rs)
    lo_rounds = rng.integers(0, R_lo, T).astype(np.int32)
    up_rounds = rng.integers(0, 2, T).astype(np.int32)
    cols = None if B is None else rng.integers(0, n // B, 2 * T).astype(
        np.int32)
    if cols is not None:
        assert cols[0::2].min() == 0 and cols[0::2].max() == 1
        assert cols[1::2].min() == 0 and cols[1::2].max() == 1
    frozen = _frozen_nets(seed + 50) if opp == JFT.OPP_FROZEN else None
    jcarry = _mk(jcfg, jep, n, seed, _race(n, race_seed), learn_batch=B,
                 frozen=frozen)
    carry = FH.hdqn_carry_from_numpy(jcarry, CPU)
    want = _run(JFH.fused_hdqn_chunk, jcfg, jep, jcarry, lo_rounds,
                up_rounds, cols, splits)
    got = _run(FH.fused_hdqn_chunk, _port_cfg(jcfg), ep, carry, lo_rounds,
               up_rounds, cols, splits)
    assert want["lo_learns"] > 0 and want["episodes"] > 0
    assert _upper_count(want["state"]) > 0, "upper learner must fire"
    _check(got, want)


def test_bf16_matches_f32_under_decisive_actions():
    """tests/test_fused_hdqn_e2e.py:335-389 for the port: with the output
    biases of both nets 500 apart every argmax is decisive in both dtypes,
    so the bf16 and f32 runs take the same goals and actions (state, both
    rings and the counters equal); each learner's params drift apart by at
    most 2 lr per update of that learner -- the upper one's count read
    from state row 15, not the lower one's."""
    n, T, lr = 128, 16, 1e-4
    jcfg = JHDQNConfig(lr=lr, gamma=0.9, target_sync=4,
                       memory_capacity=2 * n, goal_memory_capacity=2 * n,
                       opponent=JFT.OPP_L0)
    ep = EnvParams(max_steps=25)
    rng = np.random.default_rng(77)
    lo_rounds = rng.integers(0, 2, T).astype(np.int32)
    up_rounds = rng.integers(0, 2, T).astype(np.int32)
    jcarry = _mk(jcfg, JEnvParams(max_steps=25), n, 2, _race(n, 700))
    for k, na in (("u_p", 3), ("u_tp", 3), ("l_p", 5), ("l_tp", 5)):
        spread = jnp.arange(na, dtype=jnp.float32)[:, None] * 500.0
        jcarry[k] = jcarry[k][:5] + (jcarry[k][5] + spread,)
    jcarry["opp_u"], jcarry["opp_l"] = jcarry["u_p"], jcarry["l_p"]
    carry = FH.hdqn_carry_from_numpy(jcarry, CPU)
    cfg32 = _port_cfg(jcfg)
    g32 = _run(FH.fused_hdqn_chunk, cfg32, ep, carry, lo_rounds, up_rounds,
               None, [1])
    g16 = _run(FH.fused_hdqn_chunk, cfg32.replace(compute_dtype="bfloat16"),
               ep, carry, lo_rounds, up_rounds, None, [1])
    for k in ("state", "lo_ring", "up_ring"):
        assert torch.equal(g16[k], g32[k]), k
    for k in ("episodes", "collisions", "wins", "lo_learns"):
        assert g16[k] == g32[k], k
    up_learns = FH.upper_learns(g32["state"])
    assert g32["lo_learns"] > 0 and up_learns > 0
    assert np.isfinite(g16["last_loss"])
    for grp, learns in (("u_p", up_learns), ("l_p", g32["lo_learns"])):
        bound = 2.0 * lr * learns
        for a16, a32 in zip(g16[grp], g32[grp]):
            assert a16.dtype == torch.float32
            d = (a16 - a32).abs().max().item()
            assert d <= bound, f"{grp} drift {d:.2e} > {bound:.2e}"


def test_chunk_leaves_its_input_carry_and_counts_upper_learns():
    cfg = HDQNConfig(lr=1e-3, target_sync=3, memory_capacity=2 * 128,
                     goal_memory_capacity=2 * 128, opponent="selfplay")
    ep = EnvParams(max_steps=30)
    carry = FH.fused_hdqn_init(0, cfg, ep, 128, device=CPU)
    before = {k: carry[k].clone() for k in ("state", "lo_ring", "up_ring")}
    a = FH.fused_hdqn_chunk(cfg, ep, carry, 4, seed=3)
    b = FH.fused_hdqn_chunk(cfg, ep, carry, 4, seed=3)
    for k, v in before.items():
        assert torch.equal(carry[k], v), k
    for k in ("state", "lo_ring", "up_ring"):
        assert torch.equal(a[k], b[k]), k
    # Phi-greedy goals end options on most steps: the upper learner fires
    # from step R_up - 1 = 1 on where any ended, the lower one every step.
    assert a["lo_learns"] == 3 and 1 <= FH.upper_learns(a["state"]) <= 3
    assert a["warm_lo"] == a["warm_up"] == 1
    goals = a["state"][11]
    assert goals.min() >= 0 and goals.max() < 3


def test_launch_cfg_and_counters_match_jax():
    """The host schedule's inputs: ``hdqn_launch_cfg`` and the warm flags
    and lower learn count that ``apply_hdqn_chunk`` carries across chunks
    of uneven length, at R_lo = 4, R_up = 2."""
    ep, jep = EnvParams(max_steps=60), JEnvParams(max_steps=60)
    carry = {"R_lo": 4, "R_up": 2, "n": 128, "steps": 0, "warm_lo": 0,
             "warm_up": 0, "lo_learns": 0, "env_steps": 0, "episodes": 0.0,
             "collisions": 0.0, "wins": 0.0, "sum_ep_reward": 0.0}
    jcarry = dict(carry)
    for T in (1, 1, 3, 2, 9, 1, 40):
        assert FH.hdqn_launch_cfg(carry, ep, 7) == tuple(
            int(v) for v in np.asarray(JFH.hdqn_launch_cfg(jcarry, jep, 7)))
        out = (carry, [None] * 8, None, None, None, T, [0.0] * 4, 0.0)
        carry = FH.apply_hdqn_chunk(*out)
        jcarry = JFH.apply_hdqn_chunk(jcarry, *out[1:])
        for k in ("steps", "warm_lo", "warm_up", "lo_learns"):
            assert carry[k] == jcarry[k], (k, carry["steps"])
    assert carry["lo_learns"] == 57 - 3


def test_goal_status_on_stacked_obs_matches_jax():
    rng = np.random.default_rng(4)
    obs10 = (rng.standard_normal((10, 512)) * 30.0).astype(np.float32)
    obs10[0, :32] = -0.5 * obs10[9, :32]  # on a boundary
    got = FH._goal_status(torch.as_tensor(obs10))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JFH._goal_status(obs10)))


def test_init_and_chunk_validation():
    cfg = HDQNConfig(memory_capacity=4 * 128, goal_memory_capacity=2 * 128)
    ep = EnvParams()
    with pytest.raises(ValueError, match="faithful_meta"):
        FH.fused_hdqn_init(0, cfg.replace(faithful_meta=False), ep, 128,
                           device=CPU)
    with pytest.raises(ValueError, match="multiple of 128"):
        FH.fused_hdqn_init(0, cfg, ep, 100, device=CPU)
    with pytest.raises(ValueError, match="learn_batch"):
        FH.fused_hdqn_init(0, cfg, ep, 256, learn_batch=96, device=CPU)
    with pytest.raises(ValueError, match="goal_memory_capacity"):
        FH.fused_hdqn_init(0, cfg.replace(goal_memory_capacity=200), ep, 128,
                           device=CPU)
    with pytest.raises(ValueError, match="memory_capacity"):
        FH.fused_hdqn_init(0, cfg.replace(memory_capacity=128), ep, 128,
                           device=CPU)
    with pytest.raises(ValueError, match="frozen opponent"):
        FH.fused_hdqn_init(0, cfg.replace(opponent="frozen"), ep, 128,
                           device=CPU)
    carry = FH.fused_hdqn_init(0, cfg, ep, 128, device=CPU)
    assert (carry["R_lo"], carry["R_up"], carry["B"]) == (4, 2, 128)
    assert carry["lo_ring"].shape == (4 * FH.LO_F, 128)
    assert carry["up_ring"].shape == (2 * FH.UP_F, 128)
    assert FH.upper_learns(carry["state"]) == 0
    with pytest.raises(ValueError, match="num_steps"):
        FH.fused_hdqn_chunk(cfg, ep, carry, 0, 0)
    with pytest.raises(ValueError, match="lo_rounds must lie"):
        FH.fused_hdqn_chunk(cfg, ep, carry, 2, 0, lo_rounds=[0, 4],
                            up_rounds=[0, 0], cols=[0, 0, 0, 0])
    with pytest.raises(ValueError, match="up_rounds"):
        FH.fused_hdqn_chunk(cfg, ep, carry, 2, 0, lo_rounds=[0, 0],
                            up_rounds=[0, 2], cols=[0, 0, 0, 0])
    with pytest.raises(ValueError, match="cols must lie"):
        FH.fused_hdqn_chunk(cfg, ep, carry, 1, 0, cols=[0, 1])
    with pytest.raises(ValueError, match="i32"):
        FH.fused_hdqn_chunk(cfg, ep, carry, 2, 0, cols=[0, 0])
    with pytest.raises(ValueError, match="random starts"):
        FH.fused_hdqn_chunk(cfg, EnvParams(random_start=True), carry, 2, 0,
                            greedy=True)
