"""The DRQN cell (``drqn_train_l0``) through the harness on the CPU at a
test's size (the port runs its plain K9 there): sound, the run is correct;
with the bf16 control and with each planted fault (``half_batch``,
``altered_action``, ``unchanged``, planted in the reference put in the
program's place, as ``readings.py`` plants them on the card) it is not,
by the traffic file's limits.  A learner that gives fc1, fc2 and the LSTM
no gradient passes the comparison at the reference's saturated init and
fails the second one, from shrunk nets, where every leaf carries gradient.
And the frozen counts of K9 at 1,024 envs.
"""

from __future__ import annotations

import time

import pytest
import torch

from merging_gym_tpu_torch.ops import fused_drqn as FD
from perfbench import compare, faults, harness
from perfbench.paths import fused_drqn as cell_path
from perfbench.reference import counts_drqn
from perfbench.reference import drqn as ref

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
BENCH_TRAFFIC = harness.cell_spec(BENCH, "drqn_train_l0")[2]
SEED = 2 ** 31 + 977   # above 32 signed bits, as a check's seeds may be
# The ring of two rounds fills after 31 steps; one traced chunk.
TINY = dict(num_envs=128, learn_batch=128, ring_rounds=2, chunk_steps=3,
            trace_calls=1)
# fc1, fc2 and the LSTM's four leaves: the first 7,592 entries of the flat
# parameter layout; fc3 and fc4 follow.
TRUNK = sum(x.numel() for x in ref.views(torch.zeros(ref.P))[:8])
SHRUNK = ("shrunk_loss_gap", "shrunk_grad1_gap", "shrunk_change_gap")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(control=None):
    return harness.run_cell(BENCH, "drqn_train_l0", SEED, 0.3, False,
                            torch.device("cpu"), time.perf_counter(),
                            traffic_overrides=TINY, control=control)


def test_sound_run_is_correct():
    result = run()
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert all(row["value"] == 0.0 for row in result["checks"].values())


@pytest.mark.parametrize("control", [
    "bfloat16", "fault:unchanged", *(f"fault:{k}" for k in faults.KINDS)])
def test_control_and_faults_are_not_correct(control):
    result = run(control)
    assert not result["correct"], result["checks"]


def test_a_learner_without_trunk_gradients_fails_the_shrunk_comparison(
        monkeypatch):
    grads = FD._grads_plain

    def trunkless(*args, **kw):
        grad, loss, count = grads(*args, **kw)
        grad = grad.clone()
        grad[:TRUNK] = 0.0
        return grad, loss, count
    monkeypatch.setattr(FD, "_grads_plain", trunkless)
    result = run()
    limits = BENCH_TRAFFIC["limits"]
    checks = result["checks"]
    assert not result["correct"]
    assert all(checks[k]["value"] <= limits[k] for k in limits
               if k not in SHRUNK), checks
    assert checks["shrunk_grad1_gap"]["value"] > limits["shrunk_grad1_gap"]


def test_every_leaf_carries_gradient_only_from_the_shrunk_nets():
    """At the saturated init the trunk's eight leaves get exactly zero
    gradient; from the shrunk nets every leaf gets some, and the four
    weight matrices of fc1, fc2 and the LSTM move by ``compare.moving``'s
    rule (fc1's bias, against inputs of tens to hundreds, stays under a
    thousandth of the median leaf's at any scale)."""
    _, config, traffic = harness.cell_spec(BENCH, "drqn_train_l0")
    cell = cell_path.Cell(config, {**traffic, **TINY}, SEED,
                          torch.device("cpu"))
    saturated = compare.norms(ref.views(cell.first["m1"]))
    assert saturated[:8] == [0.0] * 8 and min(saturated[8:]) > 0.0
    shrunk = ref.views(cell.shrunk["m1"])
    assert min(compare.norms(shrunk)) > 0.0
    moving = compare.moving(shrunk)
    assert all(moving[i] for i in (0, 2, 4, 6)), moving


def test_fault_planting_restores_the_reference():
    before = (ref.learn_math, ref.select)
    for kind in faults.KINDS:
        with faults.planted(kind, ref):
            assert (ref.learn_math, ref.select) != before
    assert (ref.learn_math, ref.select) == before


def test_frozen_counts_of_k9():
    """At 1,024 envs, 1,024 windows of L 16 against L0: one learn 1,002.6
    MFLOP, bound 0.014966 ms with Adam; a warm step 1,019.3 MFLOP, bound
    0.015213 ms, by operations; 16,106 operations a row of the act
    forward."""
    assert counts_drqn.forward_flops() == 16106
    assert round(counts_drqn.learn_flops(1024, 16) / 1e6, 1) == 1002.6
    assert round(counts_drqn.learn_bound_ms(1024, 16), 6) == 0.014966
    ms, by = counts_drqn.step_bound_ms(1024, 1024, 16)
    assert by == "operations" and round(ms, 6) == 0.015213
    assert round(counts_drqn.step_flops(1024, 1024, 16) / 1e6, 1) == 1019.3
