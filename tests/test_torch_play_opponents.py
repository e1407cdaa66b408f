"""The Phi(0.7)-greedy share of ``play``'s learned opponents.

``merging_gym_tpu_torch.ui.human.ScriptedOpponent`` keeps the reference's
"epsilon-greedy" quirk (main.py:105, as the JAX package's
``ScriptedOpponent`` does): the pick is greedy iff a standard normal is
``<= 0.7``, else uniform over the actions, so P(greedy) = Phi(0.7) ~=
0.758.  Over 2,000 ``act`` calls of the ``dqn`` opponent (model_zoo/L2)
and of the ``hdqn`` opponent's actions (model_zoo/HD_L1), both loaded from
reference ``.pth`` run directories, the greedy share estimated from the
share of argmax picks lies within 2 SEM of Phi(0.7).
"""

import math

import numpy as np
import pytest
import torch

from merging_gym_tpu_torch.agents.hdqn import goal_obs
from merging_gym_tpu_torch.nn.mlp import qnet_apply
from merging_gym_tpu_torch.ui import human
from tests.torch_play_runs import write_run_dirs
from tests.torch_threads import one_torch_thread  # noqa: F401

CALLS = 2000
PHI = 0.5 * (1.0 + math.erf(0.7 / math.sqrt(2.0)))  # Phi(0.7)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return write_run_dirs(str(tmp_path_factory.mktemp("runs")))


def _observations(n):
    rng = np.random.default_rng(1)
    scale = np.tile([30.0, 5.0, 10.0, 400.0, 15.0], 2)
    return [[float(v) for v in o]
            for o in rng.standard_normal((n, 10)) * scale]


def _greedy_share(picks, argmax, num_actions):
    """(share, SEM): the argmax share m = g + (1 - g) / A, solved for g."""
    m = float(np.mean(picks == argmax))
    sem = math.sqrt(m * (1.0 - m) / len(picks))
    return (m - 1.0 / num_actions) / (1.0 - 1.0 / num_actions), \
        sem / (1.0 - 1.0 / num_actions)


@pytest.mark.parametrize("mode", ["dqn", "hdqn"])
def test_greedy_share_is_phi_of_epsilon(runs, mode):
    opp = human.load_opponent(mode, runs[mode], torch.device("cpu"))
    obs = _observations(CALLS)
    picks, goals = [], []
    for o in obs:
        picks.append(opp.act(o))
        goals.append(opp.goal)
    x = torch.tensor(obs, dtype=torch.float32)
    if mode == "hdqn":
        x = goal_obs(torch.tensor(goals), x)
        assert set(goals) <= {0, 1, 2}
    argmax = qnet_apply(opp.params, x).argmax(1).numpy()
    share, sem = _greedy_share(np.array(picks), argmax, 5)
    assert abs(share - PHI) <= 2 * sem, (share, sem, PHI)


def test_seeded_opponents_repeat():
    assert human.ScriptedOpponent("l0").generator is None
    g = torch.Generator().manual_seed(0)
    params = {f"fc{i}": {"w": torch.randn(k, j, generator=g),
                         "b": torch.randn(j, generator=g)}
              for i, (k, j) in enumerate(((10, 8), (8, 8), (8, 5)))}
    obs = _observations(50)

    def picks(seed):
        opp = human.ScriptedOpponent("dqn", params, seed=seed)
        return [opp.act(o) for o in obs]
    assert picks(3) == picks(3)
    assert picks(3) != picks(4)
