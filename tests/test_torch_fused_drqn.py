"""K9 of the PyTorch port (plain version, on the CPU) against the JAX
package's ``ops.fused_drqn``: the learner math, the converters, the chunk
bookkeeping and the validation, and whole chunks against the Pallas kernel
in interpret mode from the same carried-across carry
(``drqn_carry_from_numpy``).

Greedy mode with host-supplied ``rounds``/``cols`` streams is deterministic
in both packages, so whole chunks are held at the tolerances of
``tests/test_fused_drqn_e2e.py:_check`` (:207-244): winner and t exact;
positions, velocities and episode rewards to 1e-4 (positions with the
2-ulp allowance of ROADMAP Queue 3); h/c to rtol 1e-4, atol 1e-5; window
and ring to 1e-4; params, target and Adam moments to rtol 2e-3, atol 2e-4;
learn and episode counters exact; the loss to rtol 2e-3.  The three cases
are that file's setups: self-play over a full slab split [3, 13] (a chunk
boundary mid-window and inside the warm-up), L0 with a 128-lane window of
256 envs, and a frozen DRQN opponent split [9].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merging_gym_tpu.agents.drqn import DRQNConfig as JDRQNConfig
from merging_gym_tpu.core.env import EnvParams as JEnvParams
from merging_gym_tpu.core.geometry import lon2coord as jax_lon2coord
from merging_gym_tpu.nn.lstm import drqn_init as jax_drqn_init
from merging_gym_tpu.ops import fused_drqn as JFD
from merging_gym_tpu_torch.agents.drqn import DRQNConfig
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.ops import fused_drqn as FD
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

    mp.setattr(JFD.pl, "pallas_call", patched)
    yield
    mp.undo()


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _port_params(jax_t):
    """JAX's transposed 12-tuple -> the port's flat buffer, through the
    ``nn.lstm`` dict."""
    return FD.drqn_params_to_t(_np(JFD.t_to_drqn_params(jax_t)), CPU)


def test_param_layout_roundtrips():
    params = _np(jax_drqn_init(jax.random.key(0), 10, 5))
    flat = FD.drqn_params_to_t(params, CPU)
    assert flat.shape == (FD.P,) == (7949,)
    back = FD.t_to_drqn_params(flat)
    for layer in params:
        for k in params[layer]:
            np.testing.assert_array_equal(back[layer][k].numpy(),
                                          params[layer][k])
    # JAX's 12-tuple goes to the same flat buffer.
    torch.testing.assert_close(
        FD._flat_from_jax_t(JFD.drqn_params_to_t(params), CPU), flat,
        rtol=0, atol=0)


def test_carry_from_numpy_on_a_jax_carry():
    cfg = JDRQNConfig(memory_capacity=2 * 128, seq_len=4)
    jc = JFD.fused_drqn_init(jax.random.key(3), cfg, JEnvParams(), 128)
    c = FD.drqn_carry_from_numpy(jc, CPU)
    for k in ("p", "tp", "m", "v", "opp"):
        torch.testing.assert_close(
            c[k], FD.drqn_params_to_t(_np(JFD.t_to_drqn_params(jc[k])), CPU),
            rtol=0, atol=0)
    for k in ("env", "win", "ring"):
        np.testing.assert_array_equal(c[k].numpy(), np.asarray(jc[k]), k)
    assert c["env"].shape == (FD.ENV_ROWS, 128)
    assert c["win"].shape == (5 * FD.SLOT, 128)
    for k in ("R", "n", "B", "L", "warm", "learns", "steps", "env_steps",
              "ring_hbm"):
        assert c[k] == jc[k], k
    # A fresh port carry has JAX's shapes, counters and first window.
    pc = FD.fused_drqn_init(0, DRQNConfig(memory_capacity=2 * 128,
                                          seq_len=4), EnvParams(), 128,
                            device=CPU)
    for k in ("env", "win", "ring"):
        assert pc[k].shape == c[k].shape, k
    np.testing.assert_allclose(pc["win"].numpy(), np.asarray(jc["win"]),
                               atol=1e-4)
    assert {k: v for k, v in pc.items() if not torch.is_tensor(v)} == {
        k: v for k, v in c.items() if not torch.is_tensor(v)}


def _rand_batch(rng, B, L, scale=5.0):
    """tests/test_fused_drqn.py:_rand_batch, env-last."""
    done = np.zeros((B, L), np.float32)
    ends = rng.integers(0, 2 * L, B)
    for b in range(B):
        if ends[b] < L:
            done[b, ends[b]] = 1.0
    obs = rng.standard_normal((B, L + 1, 10)).astype(np.float32) * scale
    return {"obs": [obs[:, t].T.copy() for t in range(L + 1)],
            "action": rng.integers(0, 5, (L, B)).astype(np.int32),
            "reward": rng.standard_normal((L, B)).astype(np.float32),
            "done": done.T.copy()}


@pytest.mark.parametrize("burn_in", [0, 4])
def test_learn_math_matches_jax(burn_in):
    """The plain ``drqn_learn_math`` against JAX's (plain jnp) over two
    steps from the same params, with the outlier rule of
    tests/test_fused_drqn.py:94-99 on the params."""
    L, lr = 8, 0.01
    rng = np.random.default_rng(0)

    def shrink(key):
        return jax.tree.map(lambda w: (w - jnp.mean(w)) * 0.4,
                            jax_drqn_init(jax.random.key(key), 10, 5))

    jp, jt = JFD.drqn_params_to_t(shrink(1)), JFD.drqn_params_to_t(shrink(2))
    jm = tuple(jnp.zeros_like(a) for a in jp)
    jv = jm
    p, tp = _port_params(jp), _port_params(jt)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    kw = dict(gamma=0.9, lr=lr, num_actions=5, seq_len=L, burn_in=burn_in)
    for step in range(2):
        batch = _rand_batch(rng, 128, L)
        jp, jm, jv, jloss = JFD.drqn_learn_math(
            jp, jt, jm, jv, jax.tree.map(jnp.asarray, batch),
            jnp.int32(step + 1), **kw)
        p, m, v, loss = FD.drqn_learn_math(
            p, tp, m, v, jax.tree.map(torch.tensor, batch), step + 1, **kw)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
        for name, mine, theirs in (("p", p, jp), ("m", m, jm), ("v", v, jv)):
            want = FD._flat_from_jax_t(theirs, CPU).numpy().astype(np.float64)
            err = np.abs(mine.numpy().astype(np.float64) - want)
            if name == "p":
                loose = err > (5e-5 + 2e-4 * np.abs(want))
                assert loose.mean() <= 2e-3, (step, loose.sum())
                assert err.max() < 0.05 * lr, (step, err.max())
            else:  # the moments of the same gradients
                assert np.all(err <= 1e-4 * np.abs(want) + 1e-9), name


def test_slab_to_batch_matches_jax():
    L, B = 4, 8
    rng = np.random.default_rng(3)
    slab = rng.standard_normal(((L + 1) * FD.SLOT, B)).astype(np.float32)
    for s in range(1, L + 1):
        slab[s * FD.SLOT + 10] = rng.integers(0, 5, B)
        slab[s * FD.SLOT + 12] = rng.random(B) < 0.3
    got = FD.slab_to_batch(torch.tensor(slab), L)
    want = JFD.slab_to_batch(jnp.asarray(slab), L)
    for t in range(L + 1):
        np.testing.assert_array_equal(got["obs"][t].numpy(),
                                      np.asarray(want["obs"][t]))
    for k in ("action", "reward", "done"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
    assert got["action"].dtype == torch.int32
    rows = FD._rows_batch(torch.tensor(slab), L)
    np.testing.assert_array_equal(rows["obs"][:, 2].numpy(), slab[32:42].T)
    np.testing.assert_array_equal(rows["done"].numpy(),
                                  np.asarray(want["done"]).T)


def _race_carry(jcfg, ep, n, seed, race_seed, learn_batch=None, opp=None):
    """tests/test_fused_drqn_e2e.py:_mk (the frozen case's opponent given
    as ``opp``, shrunk too)."""
    carry = JFD.fused_drqn_init(jax.random.key(seed), jcfg, ep, n,
                                opp_params=opp, learn_batch=learn_batch)

    def shrink(t):
        return tuple((a - jnp.mean(a)) * 0.05 for a in t)

    carry["p"], carry["tp"] = shrink(carry["p"]), shrink(carry["tp"])
    carry["opp"] = shrink(carry["opp"]) if opp is not None else carry["p"]
    rng = np.random.default_rng(race_seed)
    pos = np.stack([rng.uniform(870.0, 948.0, n),
                    rng.uniform(870.0, 948.0, n)]).astype(np.float32)
    vel = np.stack([rng.uniform(5.0, 40.0, n),
                    rng.uniform(5.0, 40.0, n)]).astype(np.float32)
    env = np.asarray(carry["env"]).copy()
    env[0:2], env[2:4] = pos, vel
    x1, y1 = jax_lon2coord(jnp.asarray(pos[0]), +1.0)
    x2, y2 = jax_lon2coord(jnp.asarray(pos[1]), -1.0)
    env[4:8] = np.stack([np.asarray(x1), np.asarray(y1), np.asarray(x2),
                         np.asarray(y2)])
    carry["env"] = jnp.asarray(env)
    win = np.asarray(carry["win"]).copy()
    win[0:10] = FD._obs_rows(torch.tensor(env[0:8])).numpy()
    carry["win"] = jnp.asarray(win)
    return carry


def _run(chunk_fn, cfg, ep, carry, rounds, cols, splits):
    lo = 0
    for hi in splits + [len(rounds)]:
        carry = chunk_fn(cfg, ep, carry, hi - lo, seed=0, greedy=True,
                         rounds=rounds[lo:hi], cols=cols[lo:hi])
        lo = hi
    return carry


def _check(got, want):
    g, w = got["env"].numpy(), np.asarray(want["env"])
    # XLA:CPU contracts pos + vel * DT into an FMA, the port rounds twice
    # (ROADMAP Queue 3): beside the 1e-4 of _check, two ulps are allowed.
    np.testing.assert_allclose(g[0:4], w[0:4], rtol=2.5e-7, atol=1e-4,
                               err_msg="pos/vel")
    np.testing.assert_array_equal(g[8], w[8], err_msg="winner")
    np.testing.assert_array_equal(g[9], w[9], err_msg="t")
    np.testing.assert_allclose(g[10], w[10], rtol=0, atol=1e-4,
                               err_msg="episode reward")
    np.testing.assert_allclose(g[11:], w[11:], rtol=1e-4, atol=1e-5,
                               err_msg="h/c")
    for k in ("win", "ring"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    for k in ("p", "tp", "m", "v"):
        np.testing.assert_allclose(
            got[k].numpy(), FD._flat_from_jax_t(want[k], CPU).numpy(),
            rtol=2e-3, atol=2e-4, err_msg=k)
    for k in ("learns", "steps", "warm", "env_steps", "episodes",
              "collisions", "wins"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["sum_ep_reward"], want["sum_ep_reward"],
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["last_loss"], want["last_loss"],
                               rtol=2e-3, atol=1e-6)


CASES = {
    # name: (n, T, learn_batch, opponent, target_sync, burn_in, max_steps,
    #        splits, seed, race seed, stream seed); L = 4, R = 2.
    # tests/test_fused_drqn_e2e.py:247-273
    "selfplay_full_slab": (128, 26, None, JFD.OPP_SELFPLAY, 5, 1, 20,
                           [3, 13], 0, 100, 42),
    # :275-293, both lane windows drawn
    "l0_lane_window": (256, 20, 128, JFD.OPP_L0, 3, 0, 16, [], 3, 200, 7),
    # :295-329
    "frozen": (128, 18, None, JFD.OPP_FROZEN, 4, 1, 16, [9], 5, 300, 11),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunks_match_pallas_kernel(_interpret_mode, case):
    (n, T, B, opp, sync, burn_in, max_steps, splits, seed, race_seed,
     rs) = CASES[case]
    kw = dict(lr=1e-3, gamma=0.9, target_sync=sync, seq_len=4,
              burn_in=burn_in, memory_capacity=2 * n, opponent=opp)
    jcfg, cfg = JDRQNConfig(**kw), DRQNConfig(**kw)
    jep, ep = JEnvParams(max_steps=max_steps), EnvParams(max_steps=max_steps)
    rng = np.random.default_rng(rs)
    rounds = rng.integers(0, 2, T).astype(np.int32)
    cols = (np.zeros(T, np.int32) if B is None
            else rng.integers(0, n // B, T).astype(np.int32))
    if B is not None:
        assert cols.min() == 0 and cols.max() == 1, "both windows drawn"
    frozen = (jax_drqn_init(jax.random.key(99), 10, 5)
              if opp == JFD.OPP_FROZEN else None)
    jcarry = _race_carry(jcfg, jep, n, seed, race_seed, B, frozen)
    carry = FD.drqn_carry_from_numpy(jcarry, CPU)
    want = _run(JFD.fused_drqn_chunk, jcfg, jep, jcarry, rounds, cols,
                splits)
    got = _run(FD.fused_drqn_chunk, cfg, ep, carry, rounds, cols, splits)
    assert want["learns"] > 0 and want["episodes"] > 0 and want["wins"] > 0
    _check(got, want)


def test_chunk_learns_and_cfg_over_cold_then_warm_chunks():
    """``drqn_launch_cfg``, ``drqn_chunk_learns`` and
    ``apply_drqn_chunk`` against JAX's (``fused_drqn.py:835-878``) over a
    cold chunk that ends inside the warm-up and mid-window, then warm ones,
    at the CLI's R = 4, L = 16 (the learner opens at step 63)."""
    n = 128
    jcfg = JDRQNConfig(memory_capacity=4 * n)
    jc = JFD.fused_drqn_init(jax.random.key(0), jcfg, JEnvParams(), n)
    c = FD.drqn_carry_from_numpy(jc, CPU)
    ep = EnvParams()
    met = np.array([3.0, 1.0, 2.0, -4.5])
    for T in (50, 20, 200, 7):
        want_cfg = [int(x) for x in np.asarray(
            JFD.drqn_launch_cfg(jc, JEnvParams(), 11))]
        assert list(FD.drqn_launch_cfg(c, ep, 11)) == want_cfg
        assert FD.drqn_chunk_learns(c, T) == JFD.drqn_chunk_learns(jc, T)
        sched = list(FD._schedule(c, ep, 11, T, 100))
        assert sum(s[4] for s in sched) == FD.drqn_chunk_learns(c, T)
        jc = JFD.apply_drqn_chunk(jc, [None] * 53, T, met, 0.25)
        c = FD.apply_drqn_chunk(c, {}, T, met, 0.25)
        for k in ("warm", "learns", "steps", "env_steps", "episodes",
                  "collisions", "wins", "sum_ep_reward", "last_loss"):
            assert c[k] == jc[k], (T, k)
    assert c["learns"] == 277 - 63 and c["warm"] == 1


def _raises_both(fn_jax, fn_port, match):
    with pytest.raises(ValueError, match=match):
        fn_jax()
    with pytest.raises(ValueError, match=match):
        fn_port()


@pytest.mark.parametrize("case", ["num_envs", "learn_batch", "capacity",
                                  "num_steps", "rounds", "greedy_random"])
def test_validation_errors_match_jax(case):
    n = 128
    jcfg, cfg = JDRQNConfig(memory_capacity=2 * n), DRQNConfig(
        memory_capacity=2 * n)
    jep, ep = JEnvParams(), EnvParams()

    def init(num_envs=n, capacity=2 * n, **kw):
        return (lambda: JFD.fused_drqn_init(
            jax.random.key(0), jcfg.replace(memory_capacity=capacity), jep,
            num_envs, **kw),
            lambda: FD.fused_drqn_init(
                0, cfg.replace(memory_capacity=capacity), ep, num_envs,
                device=CPU, **kw))

    if case == "num_envs":
        _raises_both(*init(num_envs=100, capacity=200), "multiple of 128")
    elif case == "learn_batch":
        _raises_both(*init(learn_batch=96), "learn_batch must be")
    elif case == "capacity":
        _raises_both(*init(capacity=n), "memory_capacity must be")
    else:
        jc = JFD.fused_drqn_init(jax.random.key(0), jcfg, jep, n)
        c = FD.fused_drqn_init(0, cfg, ep, n, device=CPU)
        if case == "num_steps":
            args, match = (0,), "num_steps must be >= 1"
        elif case == "rounds":
            args, match = (2,), "rounds must lie in"
        else:
            args, match = (2,), "random start"
        kw = {"rounds": np.array([0, 2], np.int32)} if case == "rounds" else {}
        greedy = case == "greedy_random"
        jep2 = JEnvParams(random_start=greedy)
        ep2 = EnvParams(random_start=greedy)
        _raises_both(
            lambda: JFD.fused_drqn_chunk(jcfg, jep2, jc, *args, seed=0,
                                         greedy=greedy, **kw),
            lambda: FD.fused_drqn_chunk(cfg, ep2, c, *args, seed=0,
                                        greedy=greedy, **kw), match)
