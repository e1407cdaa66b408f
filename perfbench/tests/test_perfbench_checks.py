"""The comparison that decides ``correct``, shown to fail: each cell run
through the harness on the CPU at a test's size (the port runs its plain
versions there), once sound, once with its control (the lower-precision
run), and once with each fault the cell can have planted underneath the
timed path.  The harness's look for a card is skipped; everything after it
runs.  A cell's limits are its traffic file's.
"""

from __future__ import annotations

import contextlib
import time

import pytest
import torch

from perfbench import faults, harness

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
SEED = 2 ** 31 + 977   # above 32 signed bits, as a check's seeds may be
TINY = {
    "dqn_train_l0": dict(num_envs=128, learn_batch=128, chunk_steps=3),
    "dqn_train_l0_wide": dict(num_envs=256, learn_batch=256, chunk_steps=3),
    "rainbow_train_l0": dict(num_envs=128, learn_batch=128, chunk_steps=3),
    # episodes capped at 12 steps, so that a short matchup finishes some
    "dqn_league_eval": dict(num_envs=128, num_steps=40, max_steps=12),
}
TRAIN = ("dqn_train_l0", "dqn_train_l0_wide", "rainbow_train_l0")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(workload, control=None):
    cells = {w["name"] for w in BENCH["workloads"]}
    if workload not in cells:
        pytest.skip(f"{workload} is not a cell of BENCHMARK.json")
    return harness.run_cell(BENCH, workload, SEED, 0.3, False,
                            torch.device("cpu"), time.perf_counter(),
                            traffic_overrides=TINY[workload],
                            control=control)


def port_module(workload):
    if workload.startswith("rainbow"):
        from merging_gym_tpu_torch.ops import fused_rainbow as m
    else:
        from merging_gym_tpu_torch.ops import fused_trainer as m
    return m


@contextlib.contextmanager
def unchanged(workload, monkeypatch):
    """Every chunk returns its carry unchanged."""
    m = port_module(workload)
    name = ("fused_rainbow_chunk" if workload.startswith("rainbow")
            else "fused_dqn_chunk")
    monkeypatch.setattr(m, name, lambda cfg, ep, c, steps, seed, **kw: c)
    yield


@pytest.mark.parametrize("workload", sorted(TINY))
def test_sound_run_is_correct(workload):
    result = run(workload)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_is_not_correct(workload):
    """The nearest precision below the configuration's f32: bf16."""
    result = run(workload, control="bfloat16")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("kind", ["unchanged", *faults.KINDS])
@pytest.mark.parametrize("workload", TRAIN)
def test_training_fault_is_not_correct(workload, kind, monkeypatch):
    if kind == "unchanged":
        ctx = unchanged(workload, monkeypatch)
    else:
        ctx = faults.planted(kind, port_module(workload))
    with ctx:
        result = run(workload)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
def test_evaluation_fault_is_not_correct(kind, monkeypatch):
    from merging_gym_tpu_torch.agents import evaluate as EV

    rollout, outcomes = EV.fused_policy_rollout, EV.fused_outcomes
    if kind == "unchanged":      # the env never steps: no event is written
        def still(*args, **kw):
            return {k: torch.zeros_like(v)
                    for k, v in rollout(*args, **kw).items()}
        monkeypatch.setattr(EV, "fused_policy_rollout", still)
    elif kind == "half_batch":   # the outcomes of the first half of the envs
        def half(done, winner, collision, rewards):
            h = done.shape[1] // 2
            return outcomes(done[:, :h], winner[:, :h], collision[:, :h],
                            rewards[:, :, :h])
        monkeypatch.setattr(EV, "fused_outcomes", half)
    else:                        # one outcome altered where it is summed
        def altered(*args):
            out = outcomes(*args).clone()
            out[1] += 1
            return out
        monkeypatch.setattr(EV, "fused_outcomes", altered)
    result = run("dqn_league_eval")
    assert not result["correct"], result["checks"]


def test_fault_planting_restores_the_module():
    m = port_module("dqn_train_l0")
    before = (m.learn_math, m.select)
    for kind in faults.KINDS:
        with faults.planted(kind, m):
            assert (m.learn_math, m.select) != before
    assert (m.learn_math, m.select) == before
