"""The port's trajectory logs and session analysis against the JAX
package's.

``merging_gym_tpu_torch.io.trajectory.EpisodeLogger`` writes files byte
for byte equal to JAX's; ``dump_batch_trajectories`` of the port's
``core.vector.rollout`` matches JAX's dump of its rollout from the same
explicit action stream (the same file names, the action columns exact,
observations and rewards at atol 1e-3: the known XLA:CPU FMA divergence of
the f32 env); ``io.analysis`` gives JAX's dicts on the same logs and
writes every figure.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merging_gym_tpu.core.env import EnvParams as JEnvParams
from merging_gym_tpu.core.vector import reset_batch as jreset_batch
from merging_gym_tpu.core.vector import rollout as jrollout
from merging_gym_tpu.io import analysis as janalysis
from merging_gym_tpu.io import trajectory as jtraj
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.core.vector import reset_batch, rollout
from merging_gym_tpu_torch.io import analysis, trajectory
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
T, N = 700, 8


def _log(module, log_dir, episode, tag, steps):
    os.makedirs(log_dir, exist_ok=True)
    lg = module.EpisodeLogger(log_dir, episode, tag)
    for s in steps:
        lg.log_step(*s)
    lg.close()
    return lg.path


def _steps(seed, n=40, collide=False):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        obs = [np.float32(rng.standard_normal()) * 100, *map(
            float, rng.standard_normal(8) * 10), float(900 - 4 * t)]
        r1 = -10.0 if collide and t == n - 1 else float(
            np.float32(-0.001 * rng.random()))
        a2 = None if t % 3 == 0 else int(rng.integers(0, 5))
        winner = (None, None, 2, 1)[t % 4] if t > n // 2 else None
        out.append((obs, int(rng.integers(0, 5)), a2, [r1, -0.01], winner))
    return out


def test_episode_logger_bytes_equal_jax(tmp_path):
    assert trajectory.HEADER == jtraj.HEADER and len(trajectory.HEADER) == 14
    d = trajectory.make_log_dir(str(tmp_path / "log"))
    assert os.path.isdir(d) and len(os.path.basename(d)) == len(
        "2026--01--01 00:00:00")
    steps = _steps(0)
    steps.append((np.arange(10, dtype=np.float32) / 3, 4, None,
                  np.array([0.5, -0.25], np.float32), 2))
    steps.append((np.arange(10.0) / 7, 0, 3, [0.0, 0.0], None))
    got = _log(trajectory, str(tmp_path / "p"), 0, "tag a", steps)
    want = _log(jtraj, str(tmp_path / "j"), 0, "tag a", steps)
    assert os.path.basename(got) == os.path.basename(want) == "episode0 tag a"
    with open(got, "rb") as a, open(want, "rb") as b:
        data = a.read()
        assert data == b.read()
    rows = data.decode().strip().splitlines()
    assert len(rows) == 1 + sum(s[4] != 1 for s in steps)


@pytest.fixture(scope="module")
def action_stream():
    rng = np.random.default_rng(3)
    a1 = rng.integers(0, 5, (T, N))
    a2 = rng.integers(-1, 5, (T, N))
    return np.stack([a1, a2], -1).astype(np.int32)


@pytest.fixture(scope="module")
def rollouts(action_stream):
    acts_t = torch.as_tensor(action_stream)

    def policy(t, obs, gen):
        return t + 1, acts_t[t]
    _, traj = rollout(EnvParams(), reset_batch(EnvParams(), None, N,
                                               device=CPU),
                      policy, 0, None, T)
    acts_j = jnp.asarray(action_stream)

    def jpolicy(t, obs, key):
        return t + 1, acts_j[t]
    jp = JEnvParams()
    (_, _), jtraj_ = jax.jit(lambda s, k: jrollout(jp, s, jpolicy, 0, k, T))(
        jreset_batch(jp, jax.random.key(0), N), jax.random.key(1))
    return traj, jtraj_


def test_dump_batch_trajectories_matches_jax(tmp_path, rollouts):
    traj, jtraj_ = rollouts
    assert traj.obs.shape == (T, N, 10)
    got = trajectory.dump_batch_trajectories(
        trajectory.make_log_dir(str(tmp_path / "p")), traj)
    want = jtraj.dump_batch_trajectories(
        jtraj.make_log_dir(str(tmp_path / "j")), jtraj_)
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    assert len(got) == int(traj.done.sum()) >= N
    for g, w in zip(got, want):
        eg, ew = analysis.load_episode(g), janalysis.load_episode(w)
        assert eg["obs"].shape == ew["obs"].shape
        for k in ("action1", "action2"):
            np.testing.assert_array_equal(eg[k], ew[k])
        for k in ("obs", "reward1", "reward2"):
            np.testing.assert_allclose(eg[k], ew[k], rtol=0, atol=1e-3)
    # the first row is the reset observation, exactly
    np.testing.assert_array_equal(analysis.load_episode(got[0])["obs"][0],
                                  janalysis.load_episode(want[0])["obs"][0])
    capped = trajectory.dump_batch_trajectories(
        trajectory.make_log_dir(str(tmp_path / "c")), traj, tag="x",
        max_episodes=3)
    assert [os.path.basename(p) for p in capped] == [
        f"episode{i} x" for i in range(3)]


def _write_session(module, root, n_episodes=3, collide_last=True, seed=0):
    d = module.make_log_dir(root)
    for i in range(n_episodes):
        _log(module, d, i, "cond_A",
             _steps(seed + i, 20 + i, collide_last and i == n_episodes - 1))
    return d


def _assert_same(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want or (got != got and want != want), (got, want)


def test_analysis_equals_jax(tmp_path, rollouts):
    assert analysis.COLLISION_SCORE_THRESHOLD == \
        janalysis.COLLISION_SCORE_THRESHOLD
    root = tmp_path / "sessions"
    for name, collide, seed in (("s1", True, 0), ("s2", False, 5)):
        _write_session(trajectory, str(root / name), collide_last=collide,
                       seed=seed)
    dump = str(root / "dump")
    os.makedirs(dump)
    trajectory.dump_batch_trajectories(dump, rollouts[0], max_episodes=6)
    sessions = [os.path.join(root, n, os.listdir(root / n)[0])
                for n in ("s1", "s2")] + [dump]
    for d in sessions:
        eps = analysis.load_session(d)
        _assert_same(eps, janalysis.load_session(d))
        _assert_same([analysis.episode_stats(e) for e in eps],
                     [janalysis.episode_stats(e) for e in eps])
        _assert_same(analysis.session_summary(d),
                     janalysis.session_summary(d))
    assert analysis.session_summary(sessions[0])["collisions"] == 1
    _assert_same(analysis.group_sessions(str(tmp_path / "sessions")),
                 janalysis.group_sessions(str(tmp_path / "sessions")))
    groups = {name[:2]: [analysis.session_summary(d)]
              for name, d in zip(("s1", "s2", "du"), sessions)}
    figures = [analysis.plot_utility_bars(groups, str(tmp_path / "u.png")),
               analysis.plot_velocity_bars(groups, str(tmp_path / "v.png")),
               analysis.plot_reward_curves(sessions[0]),
               analysis.plot_xt_trajectories(sessions[2])]
    run = tmp_path / "run"
    run.mkdir()
    with open(run / "scalars.jsonl", "w") as f:
        for i in range(10):
            f.write(json.dumps({"step": i, "reward": -5 + i * 0.3,
                                "loss": 100 / (i + 1),
                                "collision_rate": 0.9 - i * 0.05,
                                "win_rate": 0.3 + i * 0.02}) + "\n")
    figures.append(analysis.plot_training_curves(str(run)))
    for path in figures:
        assert os.path.getsize(path) > 1000
    assert os.path.basename(figures[2]) == "reward_curve.png"
    assert os.path.basename(figures[3]) == "xt_trajectories.png"
