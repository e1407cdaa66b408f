"""The PyTorch port's env core against the JAX package and the f64 oracle.

Same inputs (made with numpy) through ``merging_gym_tpu`` and
``merging_gym_tpu_torch``; tolerances are the JAX tests' own: obs
atol 1e-3 / rtol 1e-6 (tests/test_fused_rollout.py:42-47), rewards 1e-6,
events exact, and 1e-9 against the f64 oracle (tests/test_env_parity.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merging_gym_tpu.core import constants as JC
from merging_gym_tpu.core import env as jenv
from merging_gym_tpu.core import geometry as jgeo
from merging_gym_tpu.core import vector as jvec
from merging_gym_tpu.core.oracle import OracleMergeEnv
from merging_gym_tpu_torch.core import constants as C
from merging_gym_tpu_torch.core import env as tenv
from merging_gym_tpu_torch.core import geometry as tgeo
from merging_gym_tpu_torch.core import vector as tvec

CPU = torch.device("cpu")


def test_constants_match_jax():
    names = [n for n in dir(JC) if n.isupper()]
    assert names
    for n in names:
        assert getattr(C, n) == getattr(JC, n), n
    assert [n for n in dir(C) if n.isupper()] == names


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_geometry_matches_jax(dtype):
    rng = np.random.default_rng(0)
    lon = rng.uniform(0, 1200, 4096)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    for side in (1.0, -1.0):
        xt, yt = tgeo.lon2coord(torch.as_tensor(lon, dtype=dtype), side)
        xj, yj = jgeo.lon2coord(jnp.asarray(lon, np_dt), side)
        tol = 1e-9 if dtype == torch.float64 else 1e-3
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=tol)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=tol)


def test_round_half_away_on_exact_halves():
    # tests/test_geometry.py:39: exact halves round away from zero, the
    # case where torch.round (half to even) would differ.
    v = np.concatenate([np.arange(-30, 30, 0.5), np.arange(0, 10, 0.25),
                        np.random.default_rng(1).uniform(-1100, 1100, 300)])
    got = tgeo.round_half_away(torch.as_tensor(v)).numpy()
    want = np.asarray(jgeo.round_half_away(jnp.asarray(v)))
    np.testing.assert_array_equal(got, want)
    assert tgeo.round_half_away(torch.tensor(2.5)).item() == 3.0
    assert tgeo.round_half_away(torch.tensor(-2.5)).item() == -3.0


def test_is_collided_matches_jax():
    rng = np.random.default_rng(2)
    x1, x2 = rng.uniform(900, 1000, (2, 5000))
    y1 = rng.uniform(145, 155, 5000)
    y2 = y1 + rng.uniform(-6, 6, 5000)
    got = tgeo.is_collided(*(torch.as_tensor(a) for a in (x1, y1, x2, y2)))
    want = jgeo.is_collided(*(jnp.asarray(a) for a in (x1, y1, x2, y2)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


def _run_pair(action_seq, params=None, max_steps=4000):
    """Port env in f64 against the oracle until the oracle reports done."""
    params = params or tenv.EnvParams()
    oracle = OracleMergeEnv(*params.reward_tuple())
    state = tenv.reset(params, None, 1, torch.float64, CPU)
    np.testing.assert_allclose(tenv.observe(state)[0].numpy(),
                               oracle.reset(), atol=1e-9)
    for i in range(max_steps):
        a1, a2 = action_seq(i)
        obs_o, r_o, done_o, info_o = oracle.step(a1, a2)
        a2t = C.ACTION_NONE if a2 is None else a2
        state, ts = tenv.step(params, state, torch.tensor([[a1, a2t]]))
        np.testing.assert_allclose(ts.obs[0].numpy(), obs_o, atol=1e-9,
                                   err_msg=f"obs step {i}")
        np.testing.assert_allclose(ts.rewards[0].numpy(), r_o, atol=1e-9,
                                   err_msg=f"reward step {i}")
        assert bool(ts.done[0]) == done_o, i
        assert bool(ts.collision[0]) == info_o["collision"], i
        assert int(ts.winner[0]) == (oracle.winner or 0), i
        if done_o:
            np.testing.assert_allclose(state.r_acc[0].numpy(),
                                       [oracle.r1_accumulate,
                                        oracle.r2_accumulate], atol=1e-9)
            return i + 1
    raise AssertionError("episode did not terminate")


def _random_seq(seed):
    rng = np.random.default_rng(seed)

    def seq(i):
        a2 = None if rng.random() < 0.2 else int(rng.integers(0, 5))
        return int(rng.integers(0, 5)), a2
    return seq


@pytest.mark.parametrize("name,seq,min_len", [
    ("l0_opponent", lambda i: (4, None), 40),
    ("abreast_collision", lambda i: (2, 2), 10),
    ("slow_vs_fast", lambda i: (1, 4), 20),
    ("winner_overwrite", lambda i: (4, 1), 40),
    ("random_a", _random_seq(12345), 1),
    ("random_b", _random_seq(7), 1),
])
def test_env_f64_matches_oracle(name, seq, min_len):
    assert _run_pair(seq) >= min_len


def test_env_f64_timeout_and_reward_params():
    assert _run_pair(lambda i: (0, 0), max_steps=2600) == C.TIMEOUT_STEPS
    p = tenv.EnvParams(r_first=5.0, r_second=0.5, r_collision=-100.0,
                       vel_penalty=0.01)
    assert _run_pair(lambda i: (3, 2), params=p) > 1


def _jax_state(st):
    return jenv.EnvState(
        pos=jnp.asarray(st.pos.numpy()), vel=jnp.asarray(st.vel.numpy()),
        acc=jnp.asarray(st.acc.numpy()), t=jnp.asarray(st.t.numpy()),
        winner=jnp.asarray(st.winner.numpy()),
        done=jnp.asarray(st.done.numpy()), r_acc=jnp.asarray(st.r_acc.numpy()))


def _assert_ts_close(ts_t, ts_j, msg=""):
    np.testing.assert_allclose(ts_t.obs.numpy(), np.asarray(ts_j.obs),
                               rtol=1e-6, atol=1e-3, err_msg=msg)
    np.testing.assert_allclose(ts_t.rewards.numpy(), np.asarray(ts_j.rewards),
                               rtol=1e-6, atol=1e-6, err_msg=msg)
    for k in ("done", "collision", "winner"):
        np.testing.assert_array_equal(getattr(ts_t, k).numpy(),
                                      np.asarray(getattr(ts_j, k)),
                                      err_msg=f"{k} {msg}")


def test_env_f32_step_matches_jax_on_random_states():
    n = 4096
    rng = np.random.default_rng(3)
    st = tenv.EnvState(
        pos=torch.as_tensor(rng.uniform(40, 990, (n, 2)), dtype=torch.float32),
        vel=torch.as_tensor(rng.uniform(0, 40, (n, 2)), dtype=torch.float32),
        acc=torch.zeros(n, 2),
        t=torch.as_tensor(rng.integers(0, 2502, n), dtype=torch.int32),
        winner=torch.as_tensor(rng.integers(0, 3, n), dtype=torch.int32),
        done=torch.zeros(n, dtype=torch.bool), r_acc=torch.zeros(n, 2))
    # Put some pairs abreast near the merge point so collisions occur.
    st.pos[: n // 4, 1] = st.pos[: n // 4, 0] + torch.as_tensor(
        rng.uniform(-10, 10, n // 4), dtype=torch.float32)
    actions = rng.integers(-1, 5, (n, 2)).astype(np.int32)
    params = tenv.EnvParams()
    nxt_t, ts_t = tenv.step(params, st, torch.as_tensor(actions))
    nxt_j, ts_j = jvec.step_batch(jenv.EnvParams(), _jax_state(st),
                                  jnp.asarray(actions))
    _assert_ts_close(ts_t, ts_j)
    np.testing.assert_allclose(nxt_t.pos.numpy(), np.asarray(nxt_j.pos),
                               rtol=1e-6)
    assert ts_t.collision.any() and ts_t.done.any()


@pytest.mark.parametrize("collect", ["full", "rewards", "none"])
def test_rollout_matches_jax_on_action_stream(collect):
    T, N = 200, 128
    rng = np.random.default_rng(4)
    stream = rng.integers(-1, C.NUM_ACTIONS, (T, N, 2)).astype(np.int32)

    def jax_policy(t, obs, key):
        return t + 1, jnp.asarray(stream)[t]

    def torch_policy(t, obs, gen):
        return t + 1, torch.as_tensor(stream[t])

    jp = jenv.EnvParams()
    (js, _), jtraj = jvec.rollout(jp, jvec.reset_batch(jp, jax.random.key(0), N),
                                  jax_policy, 0, jax.random.key(1), T,
                                  collect=collect)
    tp = tenv.EnvParams()
    (ts, t_end), ttraj = tvec.rollout(tp, tvec.reset_batch(tp, None, N,
                                                           device=CPU),
                                      torch_policy, 0, None, T,
                                      collect=collect)
    assert t_end == T
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), rtol=1e-6,
                               atol=1e-3)
    if collect == "full":
        _assert_ts_close(ttraj, jtraj)
        np.testing.assert_array_equal(ttraj.actions.numpy(), stream)
        assert ttraj.done.any()
    elif collect == "rewards":
        np.testing.assert_allclose(ttraj[0].numpy(), np.asarray(jtraj[0]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(ttraj[1].numpy(), np.asarray(jtraj[1]))
    else:
        assert ttraj is None


def test_random_start_moments():
    gen = torch.Generator().manual_seed(0)
    st = tvec.reset_batch(tenv.EnvParams(random_start=True), gen, 40000,
                          device=CPU)
    pos, vel = st.pos.numpy(), st.vel.numpy()
    # core/env.py:115-125: pos1 ~ N(50, 5), vel1 ~ N(20, 3),
    # pos2 ~ U(46, 54), vel2 ~ U(15, 30).
    np.testing.assert_allclose([pos[:, 0].mean(), pos[:, 0].std()], [50, 5],
                               atol=0.1)
    np.testing.assert_allclose([vel[:, 0].mean(), vel[:, 0].std()], [20, 3],
                               atol=0.06)
    assert 46 <= pos[:, 1].min() and pos[:, 1].max() <= 54
    assert 15 <= vel[:, 1].min() and vel[:, 1].max() <= 30
    np.testing.assert_allclose(vel[:, 1].mean(), 22.5, atol=0.1)


def test_autoreset_and_observe_after_reset():
    N = 128
    p = tenv.EnvParams(max_steps=3)
    st = tvec.reset_batch(p, None, N, device=CPU)
    for _ in range(3):
        st, ts = tvec.autoreset_step(p, st, torch.full((N, 2), 4))
    assert ts.done.all() and (st.t == 0).all()
    obs = tvec.observe_after_reset(p, st, ts)
    fresh = tenv.observe(tvec.reset_batch(p, None, 1, device=CPU))
    np.testing.assert_array_equal(obs.numpy(), fresh.expand(N, -1).numpy())


def test_swap_obs_matches_jax():
    obs = np.arange(30, dtype=np.float32).reshape(3, 10)
    np.testing.assert_array_equal(tenv.swap_obs(torch.as_tensor(obs)).numpy(),
                                  np.asarray(jenv.swap_obs(jnp.asarray(obs))))


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tenv.reset(tenv.EnvParams(), None, 4)
