"""K5 of the PyTorch port (plain version, on the CPU) against the JAX
package: ``learn_math`` against ``ops.fused_trainer.learn_math``, and
whole ``fused_dqn_chunk`` runs against the Pallas kernel in interpret
mode, from the same carried-across carry.

Greedy mode with host-supplied ``rounds``/``cols`` streams is
deterministic in both packages, so the chunks are held at the
tolerances of ``tests/test_fused_trainer_e2e.py:_check``: events, learns
and counters exact; env and ring to 1e-4; params, target and Adam
moments to rtol 2e-3, atol 2e-4; the loss to rtol 1e-3.  The nets are
that file's ``_shrink``-ed ones from ``_race_start`` starts (:57-75), so
the argmax is decisive and the runs cross wins, collisions and resets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merging_gym_tpu.agents.dqn import DQNConfig as JDQNConfig
from merging_gym_tpu.core.env import EnvParams as JEnvParams
from merging_gym_tpu.core.geometry import lon2coord as jax_lon2coord
from merging_gym_tpu.nn.mlp import qnet_init as jax_qnet_init
from merging_gym_tpu.ops import fused_trainer as JFT
from merging_gym_tpu_torch.agents.dqn import DQNConfig
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.ops import fused_trainer as FT
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture
def _interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(JFT.pl, "pallas_call", patched)
    yield


# ---------------------------------------------------------------------------
# learn_math
# ---------------------------------------------------------------------------

def _rand_batch(rng, n):
    return {
        "obs": rng.standard_normal((10, n)).astype(np.float32) * 20.0,
        "action": rng.integers(0, 5, n).astype(np.int32),
        "reward": rng.standard_normal(n).astype(np.float32),
        "next_obs": rng.standard_normal((10, n)).astype(np.float32) * 20.0,
        "done": rng.random(n) < 0.1,
    }


def _nets(seed_a, seed_b):
    def mk(s):
        p = jax_qnet_init(jax.random.key(s), 10, 5)
        p = jax.tree.map(lambda w: (w.astype(jnp.float32) - 0.5) * 0.1, p)
        return JFT.params_to_t(p)
    return mk(seed_a), mk(seed_b)


def _t6(pt):
    return tuple(torch.tensor(np.asarray(a)) for a in pt)


def _assert_roundoff(got, want, lr, what):
    # The outlier rule of tests/test_fused_trainer.py:77-89: Adam's first
    # steps amplify reduction-order noise for near-zero gradients, so allow
    # <=0.1% of elements beyond the tight tolerance, none beyond 5% of lr.
    a = np.asarray(got, np.float64)
    b = np.asarray(want, np.float64)
    err = np.abs(a - b)
    loose = err > (5e-5 + 2e-4 * np.abs(b))
    assert loose.mean() <= 1e-3, f"{what}: {loose.sum()}/{loose.size} loose"
    assert err.max() < 0.05 * lr, f"{what}: max |diff| {err.max():.2e}"


@pytest.mark.parametrize("mask_terminal", [False, True])
def test_learn_math_matches_jax(mask_terminal):
    lr, gamma = 0.01, 0.9
    rng = np.random.default_rng(0)
    p, tp = _nets(1, 2)
    m = v = tuple(jnp.zeros_like(a) for a in p)
    tp_t = _t6(tp)
    p_t, m_t, v_t = _t6(p), _t6(m), _t6(v)
    for step in range(3):
        batch = _rand_batch(rng, 256)
        p, m, v, loss = JFT.learn_math(
            p, tp, m, v, jax.tree.map(jnp.asarray, batch),
            jnp.int32(step + 1), gamma=gamma, lr=lr, num_actions=5,
            mask_terminal=mask_terminal)
        p_t, m_t, v_t, loss_t = FT.learn_math(
            p_t, tp_t, m_t, v_t,
            {k: torch.as_tensor(x) for k, x in batch.items()}, step + 1,
            gamma=gamma, lr=lr, mask_terminal=mask_terminal)
        np.testing.assert_allclose(float(loss_t), float(loss), rtol=1e-5,
                                   err_msg=f"loss step {step}")
        for k in range(6):
            _assert_roundoff(p_t[k], p[k], lr, f"p[{k}] step {step}")
            # Moments: f32 round-off of the same gradient sums.
            np.testing.assert_allclose(m_t[k].numpy(), np.asarray(m[k]),
                                       rtol=1e-3, atol=1e-6)
            np.testing.assert_allclose(v_t[k].numpy(), np.asarray(v[k]),
                                       rtol=2e-3, atol=1e-9)


def test_learn_math_bf16_matches_jax_bf16():
    # bf16 rounds at other places in the two frameworks, so the rule is
    # that of tests/test_fused_trainer.py:102-147: the loss within bf16
    # resolution, masters f32, strong gradients moving the same way.
    lr = 0.01
    p, tp = _nets(11, 12)
    m = v = tuple(jnp.zeros_like(a) for a in p)
    batch = _rand_batch(np.random.default_rng(7), 256)
    jp, jm, _, jloss = JFT.learn_math(
        p, tp, m, v, jax.tree.map(jnp.asarray, batch), jnp.int32(1),
        gamma=0.9, lr=lr, num_actions=5, compute_dtype=jnp.bfloat16)
    tp6, tm6, tv6, tloss = FT.learn_math(
        _t6(p), _t6(tp), _t6(m), _t6(v),
        {k: torch.as_tensor(x) for k, x in batch.items()}, 1, gamma=0.9,
        lr=lr, compute_dtype="bfloat16")
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=5e-2)
    for a_t, a_j, a0, mm in zip(tp6, jp, p, jm):
        assert a_t.dtype == torch.float32
        g = np.abs(np.asarray(mm))
        strong = g >= 0.1 * g.max()
        agree = (np.sign(a_t.numpy() - np.asarray(a0))[strong]
                 == np.sign(np.asarray(a_j - a0))[strong])
        assert agree.mean() >= 0.99, agree.mean()
    for a in tm6 + tv6:
        assert a.dtype == torch.float32


@pytest.mark.parametrize("num_f,d_in,num_a", [(32, 11, 5), (24, 10, 3)],
                         ids=["hdqn_lower", "hdqn_upper"])
def test_ring_gather_and_learn_math_match_jax_at_hdqn_layouts(num_f, d_in,
                                                              num_a):
    """The learner shared with K7 takes the ring's field count and input
    width: ``ring_batch`` gathers a lane window of one round as the JAX
    h-DQN kernel slices it (``ops/fused_hdqn.py:212-222``, :261-268), and
    ``learn_math`` on it equals JAX's by the outlier rule above."""
    lr, R, n, W = 0.01, 2, 256, 128
    rng = np.random.default_rng(d_in)
    ring = (rng.standard_normal((R * num_f, n)) * 20.0).astype(np.float32)
    for r in range(R):
        ring[r * num_f + 2 * d_in] = rng.integers(0, num_a, n)
        ring[r * num_f + 2 * d_in + 2] = rng.random(n) < 0.1

    def mk(s):
        p = jax_qnet_init(jax.random.key(s), d_in, num_a)
        return JFT.params_to_t(
            jax.tree.map(lambda w: (w.astype(jnp.float32) - 0.5) * 0.1, p))

    p, tp = mk(1), mk(2)
    m = v = tuple(jnp.zeros_like(a) for a in p)
    p_t, tp_t, m_t, v_t = _t6(p), _t6(tp), _t6(m), _t6(v)
    for step, (r, c) in enumerate(((1, 0), (0, 1), (1, 1))):
        s = ring[r * num_f:(r + 1) * num_f, c * W:(c + 1) * W]
        jbatch = {"obs": s[0:d_in], "next_obs": s[d_in:2 * d_in],
                  "action": s[2 * d_in].astype(np.int32),
                  "reward": s[2 * d_in + 1], "done": s[2 * d_in + 2] > 0.5}
        batch = FT.ring_batch(torch.as_tensor(ring), [r], [c], W, num_f,
                              d_in)
        for k, x in jbatch.items():
            np.testing.assert_array_equal(batch[k].numpy(), x, err_msg=k)
        p, m, v, loss = JFT.learn_math(
            p, tp, m, v, jax.tree.map(jnp.asarray, jbatch),
            jnp.int32(step + 1), gamma=0.9, lr=lr, num_actions=num_a)
        p_t, m_t, v_t, loss_t = FT.learn_math(p_t, tp_t, m_t, v_t, batch,
                                              step + 1, gamma=0.9, lr=lr)
        np.testing.assert_allclose(float(loss_t), float(loss), rtol=1e-5)
        for k in range(6):
            _assert_roundoff(p_t[k], p[k], lr, f"p[{k}] step {step}")
            np.testing.assert_allclose(m_t[k].numpy(), np.asarray(m[k]),
                                       rtol=1e-3, atol=1e-6)


def test_param_layout_roundtrip():
    p = jax_qnet_init(jax.random.key(0), 10, 5)
    pt = FT.params_to_t(p)
    back = FT.t_to_params(pt)
    for name in ("fc0", "fc1", "fc2"):
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(back[name][leaf].numpy(),
                                          np.asarray(p[name][leaf]))
    for a, b in zip(pt, JFT.params_to_t(p)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    flat = FT._flat(pt)
    for a, b in zip(FT._transposed(flat, FT._dims(pt)), pt):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Whole chunks against the interpret-mode Pallas kernel
# ---------------------------------------------------------------------------

def _shrink(p6):
    return tuple((a - jnp.mean(a)) * 0.05 for a in p6)


def _race_start(n, seed):
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(870.0, 948.0, n),
                    rng.uniform(870.0, 948.0, n)]).astype(np.float32)
    vel = np.stack([rng.uniform(5.0, 40.0, n),
                    rng.uniform(5.0, 40.0, n)]).astype(np.float32)
    return pos, vel


def _mk(cfg, ep, n, learn_batch, seed, race=None, learn_rounds=1,
        spread=None):
    """The JAX carry of tests/test_fused_trainer_e2e.py:_mk (numpy
    leaves)."""
    carry = JFT.fused_dqn_init(jax.random.key(seed), cfg, ep, n,
                               learn_batch=learn_batch,
                               learn_rounds=learn_rounds, ring_hbm=False)
    carry["p"] = _shrink(carry["p"])
    carry["tp"] = _shrink(carry["tp"])
    if spread is not None:  # decisive last-layer biases
        s = jnp.arange(cfg.num_actions, dtype=jnp.float32)[:, None] * spread
        carry["p"] = carry["p"][:5] + (carry["p"][5] + s,)
        carry["tp"] = carry["tp"][:5] + (carry["tp"][5] + s,)
    carry["opp"] = carry["p"]
    if race is not None:
        pos, vel = race
        env = np.asarray(carry["env"]).copy()
        env[0:2], env[2:4] = pos, vel
        x1, y1 = jax_lon2coord(jnp.asarray(pos[0]), +1.0)
        x2, y2 = jax_lon2coord(jnp.asarray(pos[1]), -1.0)
        env[4:8] = np.stack([np.asarray(x1), np.asarray(y1),
                             np.asarray(x2), np.asarray(y2)])
        carry["env"] = jnp.asarray(env)
    return carry


def _run(chunk_fn, cfg, ep, carry, rounds, cols, splits):
    K = carry.get("K", 1)
    T = len(rounds) // K
    lo = 0
    for hi in splits + [T]:
        carry = chunk_fn(cfg, ep, carry, hi - lo, 0, greedy=True,
                         rounds=rounds[lo * K:hi * K],
                         cols=cols[lo * K:hi * K])
        lo = hi
    return carry


def _port_cfg(jcfg):
    return DQNConfig(**{f: getattr(jcfg, f) for f in (
        "lr", "gamma", "target_sync", "memory_capacity", "opponent",
        "hidden", "compute_dtype", "mask_terminal", "epsilon")})


def _check(got, want):
    """tests/test_fused_trainer_e2e.py:_check, port carry vs JAX carry."""
    g_env, w_env = got["env"].numpy(), np.asarray(want["env"])
    # XLA:CPU contracts pos + vel * DT into an FMA, the port rounds twice
    # (ROADMAP Queue 3): near 1,000 m an ulp is 6e-5, so beside _check's
    # 1e-4 two ulps are allowed.
    np.testing.assert_allclose(g_env[0:4], w_env[0:4], rtol=2.5e-7,
                               atol=1e-4, err_msg="pos/vel")
    np.testing.assert_array_equal(g_env[8], w_env[8], err_msg="winner")
    np.testing.assert_array_equal(g_env[9], w_env[9], err_msg="t")
    np.testing.assert_allclose(g_env[10], w_env[10], rtol=0, atol=1e-4,
                               err_msg="ep_reward")
    np.testing.assert_allclose(got["ring"].numpy(), np.asarray(want["ring"]),
                               rtol=1e-4, atol=1e-4, err_msg="ring")
    for name in ("p", "tp", "m", "v"):
        for k, (g, w) in enumerate(zip(got[name], want[name])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3,
                                       atol=2e-4, err_msg=f"{name}[{k}]")
    for k in ("learns", "steps", "warm", "env_steps", "episodes",
              "collisions", "wins"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["sum_ep_reward"], want["sum_ep_reward"],
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["last_loss"], want["last_loss"],
                               rtol=1e-3, atol=1e-6)


CASES = {
    # name: (n, T, R, learn_batch, K, opponent, target_sync, hidden,
    #        max_steps, splits, seed)
    # The 1-step first chunk is shorter than the R-1 = 2 step warm-up,
    # locking the global-step learn gate across launches.
    "selfplay_full_slab": (128, 40, 3, None, 1, JFT.OPP_SELFPLAY, 7,
                           (200, 100), 25, [1, 10], 0),
    "l0_lane_window": (256, 36, 2, 128, 1, JFT.OPP_L0, 5, (200, 100), 30,
                       [], 3),
    "learn_rounds_2": (256, 30, 3, 256, 2, JFT.OPP_L0, 6, (200, 100), 30,
                       [12], 9),
    "width_144_72": (128, 12, 2, None, 1, JFT.OPP_L0, 4, (144, 72), 25, [],
                     13),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunks_match_pallas_kernel(_interpret_mode, case):
    n, T, R, B, K, opp, sync, hidden, max_steps, splits, seed = CASES[case]
    jcfg = JDQNConfig(lr=1e-3, gamma=0.9, target_sync=sync, hidden=hidden,
                      memory_capacity=R * n, opponent=opp)
    rng = np.random.default_rng(seed + 40)
    W = (B or n) // K
    rounds = rng.integers(0, R, T * K).astype(np.int32)
    cols = rng.integers(0, n // W, T * K).astype(np.int32)
    race = _race_start(n, seed=100 + seed)
    jcarry = _mk(jcfg, JEnvParams(max_steps=max_steps), n, B, seed, race,
                 learn_rounds=K)
    carry = FT.carry_from_numpy(jcarry, CPU)
    want = _run(JFT.fused_dqn_chunk, jcfg, JEnvParams(max_steps=max_steps),
                jcarry, rounds, cols, splits)
    got = _run(FT.fused_dqn_chunk, _port_cfg(jcfg),
               EnvParams(max_steps=max_steps), carry, rounds, cols, splits)
    assert want["learns"] > 0 and want["episodes"] > 0
    assert want["collisions"] > 0 or want["wins"] > 0
    _check(got, want)


def test_bf16_matches_f32_under_decisive_actions(_interpret_mode):
    """tests/test_fused_trainer_e2e.py:361-411 for the port: with the
    last-layer biases 500 apart every argmax is decisive in both dtypes,
    so the bf16 and f32 runs take the same actions (env, ring and counters
    equal) and the params drift apart by at most 2 lr per learn.  The port's
    bf16 run also matches the JAX kernel's bf16 run."""
    n, T, lr = 128, 40, 1e-4
    jcfg32 = JDQNConfig(lr=lr, gamma=0.9, target_sync=7,
                        memory_capacity=3 * n, opponent=JFT.OPP_SELFPLAY)
    jcfg16 = jcfg32.replace(compute_dtype="bfloat16")
    ep = EnvParams(max_steps=25)
    rng = np.random.default_rng(5)
    rounds = rng.integers(0, 3, T).astype(np.int32)
    cols = np.zeros(T, np.int32)
    jcarry = _mk(jcfg32, JEnvParams(max_steps=25), n, None, 0,
                 _race_start(n, seed=200), spread=500.0)
    carry = FT.carry_from_numpy(jcarry, CPU)
    got32 = _run(FT.fused_dqn_chunk, _port_cfg(jcfg32), ep, carry, rounds,
                 cols, [10])
    got16 = _run(FT.fused_dqn_chunk, _port_cfg(jcfg16), ep, carry, rounds,
                 cols, [10])
    assert torch.equal(got16["env"], got32["env"])
    assert torch.equal(got16["ring"], got32["ring"])
    for k in ("episodes", "collisions", "wins", "learns"):
        assert got16[k] == got32[k], k
    assert got16["learns"] > 0 and np.isfinite(got16["last_loss"])
    bound = 2.0 * lr * got32["learns"]
    for a16, a32 in zip(got16["p"], got32["p"]):
        assert a16.dtype == torch.float32
        assert (a16 - a32).abs().max().item() <= bound
    want16 = _run(JFT.fused_dqn_chunk, jcfg16, JEnvParams(max_steps=25),
                  jcarry, rounds, cols, [10])
    np.testing.assert_array_equal(got16["env"][8:10].numpy(),
                                  np.asarray(want16["env"])[8:10])
    np.testing.assert_allclose(got16["ring"].numpy(),
                               np.asarray(want16["ring"]), rtol=1e-4,
                               atol=1e-4)
    for k in ("episodes", "collisions", "wins", "learns"):
        assert got16[k] == want16[k], k


def test_chunk_leaves_its_input_carry_and_is_repeatable():
    cfg = DQNConfig(lr=1e-3, memory_capacity=2 * 128, opponent="selfplay")
    carry = FT.fused_dqn_init(0, cfg, EnvParams(max_steps=40), 128,
                              device=CPU)
    before = {k: v.clone() for k, v in (("env", carry["env"]),
                                        ("ring", carry["ring"]))}
    a = FT.fused_dqn_chunk(cfg, EnvParams(max_steps=40), carry, 6, seed=3)
    b = FT.fused_dqn_chunk(cfg, EnvParams(max_steps=40), carry, 6, seed=3)
    assert torch.equal(carry["env"], before["env"])
    assert torch.equal(carry["ring"], before["ring"])
    for k in ("p", "m", "v"):
        for x, y in zip(a[k], b[k]):
            assert torch.equal(x, y)
    assert torch.equal(a["ring"], b["ring"]) and a["learns"] == 5


def test_init_and_chunk_validation():
    cfg = DQNConfig(memory_capacity=4 * 128)
    ep = EnvParams()
    with pytest.raises(ValueError, match="multiple of 128"):
        FT.fused_dqn_init(0, cfg, ep, 100, device=CPU)
    with pytest.raises(ValueError, match="learn_batch"):
        FT.fused_dqn_init(0, cfg, ep, 128, learn_batch=96, device=CPU)
    with pytest.raises(ValueError, match="learn_rounds"):
        FT.fused_dqn_init(0, cfg, ep, 128, learn_rounds=2, device=CPU)
    with pytest.raises(ValueError, match="memory_capacity"):
        FT.fused_dqn_init(0, cfg.replace(memory_capacity=200), ep, 128,
                          device=CPU)
    carry = FT.fused_dqn_init(0, cfg, ep, 128, device=CPU)
    assert carry["R"] == 4 and carry["B"] == 128 and carry["ring_hbm"] == 0
    with pytest.raises(ValueError, match="rounds must lie"):
        FT.fused_dqn_chunk(cfg, ep, carry, 2, 0, rounds=[0, 4], cols=[0, 0])
    with pytest.raises(ValueError, match="random starts"):
        FT.fused_dqn_chunk(cfg, EnvParams(random_start=True), carry, 2, 0,
                           greedy=True)
