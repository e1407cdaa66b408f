"""The port's ``play`` path against the JAX package's.

Headless sessions (``SDL_VIDEODRIVER=dummy``, ``time_scale=0``) of
``merging_gym_tpu_torch.ui.human.run_session`` write trajectory CSVs byte
for byte equal to JAX's ``run_session`` with the ``l0`` opponent and with
the ``rainbow`` opponent (``model_zoo/RB_L0`` as a reference ``eval.pth``;
a differing action is allowed only where JAX's top two Q-values lie within
1e-5).  The ``dqn`` and ``hdqn`` opponents (``model_zoo/L2`` and
``model_zoo/HD_L1`` as reference ``.pth`` run directories) give JAX's
Q-values and greedy picks at the tolerance of ``tests/test_torch_mlp.py``;
their Phi(0.7)-greedy share is ``tests/test_torch_play_opponents.py``'s.
Then the ``play`` command's refusals.
"""

import ast
import csv
import os
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merging_gym_tpu.agents.hdqn import goal_obs as jax_goal_obs
from merging_gym_tpu.core.oracle import OracleMergeEnv
from merging_gym_tpu.ui import human as jhuman
from merging_gym_tpu_torch.agents.hdqn import goal_obs, goal_status
from merging_gym_tpu_torch.nn.mlp import qnet_apply
from merging_gym_tpu_torch.ui import human
from tests.torch_play_runs import write_run_dirs
from tests.torch_threads import one_torch_thread  # noqa: F401

os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SESSION = dict(episodes=2, max_steps=60, time_scale=0.0)
TIE = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return write_run_dirs(str(tmp_path_factory.mktemp("runs")))


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _session_pair(tmp_path, port_opp, jax_opp):
    got = human.run_session(port_opp, log_root=str(tmp_path / "port"),
                            **SESSION)
    want = jhuman.run_session(jax_opp, log_root=str(tmp_path / "jax"),
                              **SESSION)
    for k in ("sum_r1", "sum_r2", "collisions"):
        assert got[k] == want[k], k
    files = sorted(os.listdir(got["log_dir"]))
    assert files == sorted(os.listdir(want["log_dir"]))
    assert len(files) == SESSION["episodes"]
    return [(os.path.join(got["log_dir"], f), os.path.join(want["log_dir"], f))
            for f in files]


def _obs_of_session():
    """Pre-step observations of an oracle episode (ego 2, L0 opponent)."""
    env, out = OracleMergeEnv(), []
    state = env.reset()
    for _ in range(400):
        out.append(state)
        state, _, done, _ = env.step(2, None)
        if done:
            break
    scale = np.tile([30.0, 5.0, 10.0, 400.0, 15.0], 2)
    out += list(np.random.default_rng(0).standard_normal((64, 10)) * scale)
    return [[float(v) for v in o] for o in out]


def test_l0_session_csvs_equal_jax(tmp_path):
    pairs = _session_pair(tmp_path, human.ScriptedOpponent("l0"),
                          jhuman.ScriptedOpponent("l0"))
    for port_file, jax_file in pairs:
        with open(port_file, "rb") as a, open(jax_file, "rb") as b:
            assert a.read() == b.read()
        rows = _rows(port_file)
        assert len(rows) == SESSION["max_steps"] + 1
        assert all(len(r) == 14 and r[11] == "" for r in rows[1:])


def test_rainbow_session_csvs_equal_jax(tmp_path, runs):
    port_opp = human.load_opponent("rainbow", runs["rainbow"], CPU)
    jax_opp = jhuman.load_opponent("rainbow", runs["rainbow"])
    assert port_opp.device == CPU
    pairs = _session_pair(tmp_path, port_opp, jax_opp)
    actions = set()
    for port_file, jax_file in pairs:
        got, want = _rows(port_file), _rows(jax_file)
        assert len(got) == len(want)
        for k, (g, w) in enumerate(zip(got, want)):
            if g == w:
                actions.add(g[11])
                continue
            # Only a near-tie of JAX's Q-values may flip the pick.
            obs = [float(v) for v in w[:10]]
            q = np.sort(np.asarray(jax_opp._rb(
                jax_opp.params, jnp.asarray(human._swap(obs), jnp.float32))))
            assert q[-1] - q[-2] <= TIE, (port_file, k, g, w)
            warnings.warn(f"{os.path.basename(port_file)} row {k}: the port "
                          f"picks {g[11]}, JAX {w[11]}, at a Q gap of "
                          f"{q[-1] - q[-2]}")
            break
    assert actions - {"action2"} and "" not in actions


def test_dqn_opponent_equals_jax(runs):
    port_opp = human.load_opponent("dqn", runs["dqn"], CPU)
    jax_opp = jhuman.load_opponent("dqn", runs["dqn"])
    obs = _obs_of_session()
    x = torch.tensor([human._swap(o) for o in obs], dtype=torch.float32)
    got = qnet_apply(port_opp.params, x)
    want = np.stack([np.asarray(jax_opp._q(jax_opp.params, jnp.asarray(
        human._swap(o), jnp.float32))) for o in obs])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-3
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got.argmax(1).numpy()[clear],
                                  want.argmax(1)[clear])
    # act on one row: the same Q-values, then a pick in range
    for o in obs[:5]:
        a = port_opp.act(human._swap(o))
        assert isinstance(a, int) and 0 <= a < 5


def test_hdqn_opponent_equals_jax(runs):
    port_opp = human.load_opponent("hdqn", runs["hdqn"], CPU)
    jax_opp = jhuman.load_opponent("hdqn", runs["hdqn"])
    obs = _obs_of_session()
    x = torch.tensor([human._swap(o) for o in obs], dtype=torch.float32)
    xj = [jnp.asarray(human._swap(o), jnp.float32) for o in obs]
    got_meta = qnet_apply(port_opp.meta_params, x)
    want_meta = np.stack([np.asarray(jax_opp._q(jax_opp.meta_params, v))
                          for v in xj])
    np.testing.assert_allclose(got_meta.numpy(), want_meta, rtol=1e-5,
                               atol=1e-3)
    for goal in range(3):
        got = qnet_apply(port_opp.params, goal_obs(
            torch.full((len(obs),), goal), x))
        want = np.stack([np.asarray(jax_opp._q(jax_opp.params, jax_goal_obs(
            jnp.int32(goal), v))) for v in xj])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
        top2 = np.sort(want, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-3
        np.testing.assert_array_equal(got.argmax(1).numpy()[clear],
                                      want.argmax(1)[clear])
    # The goal is re-chosen only when none is set or it was achieved
    # (human_player.py:151-152).
    port_opp.reset()
    for o in obs[:120]:
        before = port_opp.goal
        status = int(goal_status(torch.tensor(human._swap(o))))
        a = port_opp.act(human._swap(o))
        assert 0 <= a < 5 and 0 <= port_opp.goal < 3
        if before is not None and before != status:
            assert port_opp.goal == before


def test_dqn_session_runs_headless(tmp_path, runs):
    opp = human.load_opponent("dqn", runs["dqn"], CPU)
    result = human.run_session(opp, episodes=1, log_root=str(tmp_path),
                               max_steps=20, time_scale=0.0)
    (name,) = os.listdir(result["log_dir"])
    assert name == "episode0 dqn"
    rows = _rows(os.path.join(result["log_dir"], name))
    assert len(rows) == 21 and all(r[11] in "01234" and r[11] for r in
                                   rows[1:])


def test_opponents_and_their_refusals():
    assert human.ScriptedOpponent("l0").act([0.0] * 10) is None
    assert human.load_opponent("pvp").mode == "pvp"
    with pytest.raises(ValueError, match="needs --load-path"):
        human.load_opponent("hdqn")
    with pytest.raises(ValueError, match="unknown opponent mode"):
        human.load_opponent("random", "somewhere")


def _cli(args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "merging_gym_tpu_torch.cli",
                           *args], capture_output=True, text=True,
                          timeout=120, env=env, cwd=REPO)


def test_cli_play_refusals(tmp_path):
    r = _cli(["--cpu", "play", "--op-model", "dqn", "--log-root",
              str(tmp_path)])
    assert r.returncode != 0 and "needs --load-path" in r.stderr
    assert not os.listdir(tmp_path)
    r = _cli(["play", "--op-model", "bogus"])
    assert r.returncode == 2 and "invalid choice" in r.stderr
    if not torch.cuda.is_available():
        r = _cli(["play", "--log-root", str(tmp_path)])
        assert r.returncode != 0 and "CUDA is not available" in r.stderr


def _cli_flags(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    flags, commands = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            args = [a.value for a in node.args
                    if isinstance(a, ast.Constant) and isinstance(a.value,
                                                                  str)]
            if node.func.attr == "add_argument":
                flags.update(a for a in args if a.startswith("--"))
            elif node.func.attr == "add_parser":
                commands.update(args[:1])
    return flags, commands


def test_cli_flags_cover_the_jax_cli():
    port = _cli_flags(os.path.join(REPO, "merging_gym_tpu_torch", "cli.py"))
    jax_cli = _cli_flags(os.path.join(REPO, "merging_gym_tpu", "cli.py"))
    assert {"--op-model", "--load-path", "--log-root"} <= port[0]
    assert jax_cli[0] - port[0] == set()
    assert jax_cli[1] - port[1] == set()


def test_imports_need_no_ui_libraries():
    code = ("import sys, torch, merging_gym_tpu_torch\n"
            "import merging_gym_tpu_torch.ui.human, "
            "merging_gym_tpu_torch.core.native, "
            "merging_gym_tpu_torch.core.spline, "
            "merging_gym_tpu_torch.io.analysis, "
            "merging_gym_tpu_torch.io.trajectory, "
            "merging_gym_tpu_torch.utils.debug, "
            "merging_gym_tpu_torch.utils.profiling, "
            "merging_gym_tpu_torch.cli\n"
            "print(sorted(m for m in ('pygame', 'gymnasium', 'matplotlib', "
            "'jax') if m in sys.modules), torch.cuda.is_initialized())\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["[]", "False"]
