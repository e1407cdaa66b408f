"""Full-carry checkpoints of the PyTorch port (``io.checkpoint``) on the
CPU.

* resume == continue, bit for bit, for all eight trainers (the four step
  loops and K5, K7, K8, K9): a carry saved after one chunk and restored
  into a fresh template continues exactly as the uninterrupted run, as
  ``tests/test_fused_trainer_recovery.py:49-84`` and
  ``tests/test_io.py:70-91`` hold the JAX package;
* against JAX for K5, K7, K8 and K9: the JAX package's orbax save, restore
  and continue (the kernels in interpret mode) beside the port's
  ``*_carry_from_numpy``, save, restore and continue, held at the
  whole-chunk tolerances of ``tests/test_torch_fused_*.py``'s ``_check``;
* the steps kept equal those that the JAX ``CheckpointManager`` keeps for
  the same save calls;
* a mismatched template, a generator of the other device type and an
  orbax directory are refused with a message, and a temporary file left by
  an interrupted save is not a step.
"""

import os

import jax
import numpy as np
import pytest
import torch

from merging_gym_tpu.agents.dqn import DQNConfig as JDQNConfig
from merging_gym_tpu.agents.drqn import DRQNConfig as JDRQNConfig
from merging_gym_tpu.agents.hdqn import HDQNConfig as JHDQNConfig
from merging_gym_tpu.agents.rainbow import RainbowConfig as JRainbowConfig
from merging_gym_tpu.core.env import EnvParams as JEnvParams
from merging_gym_tpu.io.checkpoint import CheckpointManager as JaxManager
from merging_gym_tpu.ops import fused_drqn as JFD
from merging_gym_tpu.ops import fused_hdqn as JFH
from merging_gym_tpu.ops import fused_rainbow as JFR
from merging_gym_tpu.ops import fused_trainer as JFT
from merging_gym_tpu_torch.agents import dqn as D
from merging_gym_tpu_torch.agents import drqn as DR
from merging_gym_tpu_torch.agents import hdqn as H
from merging_gym_tpu_torch.agents import rainbow as RB
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.io.checkpoint import (CheckpointManager, load_into,
                                                 state_tree)
from merging_gym_tpu_torch.ops import fused_drqn as FD
from merging_gym_tpu_torch.ops import fused_hdqn as FH
from merging_gym_tpu_torch.ops import fused_rainbow as FRB
from merging_gym_tpu_torch.ops import fused_trainer as FT
from tests import test_torch_fused_drqn as TD
from tests import test_torch_fused_hdqn as TH
from tests import test_torch_fused_rainbow as TR
from tests import test_torch_fused_trainer as T5
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
EP = EnvParams(max_steps=30)


def assert_same(a, b, path="carry"):
    """Two carries equal bit for bit (through :func:`state_tree`)."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


# ---------------------------------------------------------------------------
# resume == continue for the eight trainers
# ---------------------------------------------------------------------------

def _dqn_loop():
    cfg = D.DQNConfig(memory_capacity=256, batch_size=16, opponent="selfplay")
    return (lambda: D.train_init(0, cfg, EP, 128, device=CPU),
            lambda c: D.train_chunk(cfg, EP, c, 4),
            lambda c: int(c.dqn.learn_counter))


def _hdqn_loop():
    cfg = H.HDQNConfig(memory_capacity=48, goal_memory_capacity=32,
                       batch_size=16, opponent="selfplay")
    return (lambda: H.hdqn_init(0, cfg, EP, 16, device=CPU),
            lambda c: H.hdqn_train_chunk(cfg, EP, c, 4),
            lambda c: int(c.lower.learn_counter))


def _rainbow_loop(per):
    cfg = RB.RainbowConfig(memory_capacity=256, batch_size=16, per=per,
                           n_step=3 if per else 1, obs_scale=0.01,
                           opponent="selfplay")
    return (lambda: RB.rainbow_train_init(0, cfg, EP, 16, device=CPU),
            lambda c: RB.rainbow_train_chunk(cfg, EP, c, 6),
            lambda c: int(c.opt_state.count))


def _drqn_loop():
    cfg = DR.DRQNConfig(memory_capacity=32, batch_size=4, seq_len=4,
                        opponent="selfplay")
    return (lambda: DR.drqn_train_init(0, cfg, EP, 16, device=CPU),
            lambda c: DR.drqn_train_chunk(cfg, EP, c, 6),
            lambda c: int(c.learn_counter))


def _fused(mod, init, chunk, cfg, steps, learns="learns"):
    # Seed = run seed + global step count, as the CLI draws it.
    return (lambda: getattr(mod, init)(0, cfg, EP, 128, device=CPU),
            lambda c: getattr(mod, chunk)(cfg, EP, c, steps,
                                          seed=3 + c["steps"]),
            lambda c: c[learns])


TRAINERS = {
    "dqn_loop": _dqn_loop,
    "hdqn_loop": _hdqn_loop,
    "rainbow_loop": lambda: _rainbow_loop(False),
    "rainbow_loop_per_3step": lambda: _rainbow_loop(True),
    "drqn_loop": _drqn_loop,
    "k5": lambda: _fused(FT, "fused_dqn_init", "fused_dqn_chunk",
                         D.DQNConfig(memory_capacity=256,
                                     opponent="selfplay"), 3),
    "k7": lambda: _fused(FH, "fused_hdqn_init", "fused_hdqn_chunk",
                         H.HDQNConfig(memory_capacity=256,
                                      goal_memory_capacity=256,
                                      opponent="selfplay"), 3, "lo_learns"),
    "k8": lambda: _fused(FRB, "fused_rainbow_init", "fused_rainbow_chunk",
                         RB.RainbowConfig(memory_capacity=512, obs_scale=0.01,
                                          opponent="selfplay"), 4),
    "k8_per_3step": lambda: _fused(
        FRB, "fused_rainbow_init", "fused_rainbow_chunk",
        RB.RainbowConfig(memory_capacity=512, per=True, n_step=3,
                         obs_scale=0.01, opponent="selfplay"), 4),
    "k9": lambda: _fused(FD, "fused_drqn_init", "fused_drqn_chunk",
                         DR.DRQNConfig(memory_capacity=256, seq_len=4,
                                       opponent="selfplay"), 5),
}


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_resume_equals_continue(tmp_path, name):
    init, chunk, learns = TRAINERS[name]()
    first = chunk(init())
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(0, first)
    cont = chunk(first)
    # A restarted process restores into the carry its flags build.
    resumed = chunk(mgr.restore(init()))
    assert learns(cont) > 0
    assert_same(state_tree(cont), state_tree(resumed))


def test_restore_keeps_host_counter_types(tmp_path):
    """The fused carries' host counters come back as the Python ints and
    floats the chunk schedules on (no ``coerce_carry`` needed)."""
    init, chunk, _ = TRAINERS["k5"]()
    c = chunk(init())
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, c)
    r = mgr.restore(init())
    for k, v in c.items():
        if not isinstance(v, (torch.Tensor, tuple)):
            assert type(r[k]) is type(v) and r[k] == v, k
    assert type(r["steps"]) is int and type(r["episodes"]) is float


# ---------------------------------------------------------------------------
# Against the JAX package: orbax save, restore, continue
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def _interpret_mode():
    from jax.experimental import pallas as pl

    mp = pytest.MonkeyPatch()
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    mp.setattr(pl, "pallas_call", patched)
    yield
    mp.undo()


def _jax_resume(tmp_path, jc1, template, coerce):
    mgr = JaxManager(str(tmp_path / "jax_ckpt"))
    mgr.save(0, jc1, wait=True)
    restored = coerce(mgr.restore(template))
    mgr.close()
    return restored


def _port_resume(tmp_path, pc1, template):
    mgr = CheckpointManager(str(tmp_path / "port_ckpt"))
    mgr.save(0, pc1)
    return mgr.restore(template)


def _k5_case():
    n, R, T1, T2 = 128, 2, 3, 5
    jcfg = JDQNConfig(lr=1e-3, gamma=0.9, target_sync=3,
                      memory_capacity=R * n, opponent=JFT.OPP_SELFPLAY)
    rng = np.random.default_rng(5)
    rounds = rng.integers(0, R, T1 + T2).astype(np.int32)
    cols = np.zeros(T1 + T2, np.int32)
    jc0 = T5._mk(jcfg, JEnvParams(max_steps=25), n, None, 0,
                 T5._race_start(n, seed=100))

    def run(fn, cfg, ep, c, lo, hi):
        return fn(cfg, ep, c, hi - lo, 0, greedy=True, rounds=rounds[lo:hi],
                  cols=cols[lo:hi])

    return dict(
        T1=T1, T2=T2, jc0=jc0, jchunk=lambda c, lo, hi: run(
            JFT.fused_dqn_chunk, jcfg, JEnvParams(max_steps=25), c, lo, hi),
        pchunk=lambda c, lo, hi: run(FT.fused_dqn_chunk, T5._port_cfg(jcfg),
                                     EnvParams(max_steps=25), c, lo, hi),
        template=lambda: JFT.fused_dqn_init(jax.random.key(0), jcfg,
                                            JEnvParams(max_steps=25), n,
                                            ring_hbm=False),
        coerce=JFT.coerce_carry, to_port=FT.carry_from_numpy,
        check=T5._check, learns="learns")


def _k7_case():
    n, T1, T2 = 128, 2, 6
    jcfg = JHDQNConfig(lr=1e-3, gamma=0.9, target_sync=4,
                       memory_capacity=2 * n, goal_memory_capacity=2 * n,
                       opponent=JFT.OPP_L0)
    rng = np.random.default_rng(55)
    lo_r = rng.integers(0, 2, T1 + T2).astype(np.int32)
    up_r = rng.integers(0, 2, T1 + T2).astype(np.int32)
    jep, ep = JEnvParams(max_steps=25), EnvParams(max_steps=25)
    jc0 = TH._mk(jcfg, jep, n, 2, TH._race(n, 500))

    def run(fn, cfg, e, c, lo, hi):
        return fn(cfg, e, c, hi - lo, seed=0, greedy=True,
                  lo_rounds=lo_r[lo:hi], up_rounds=up_r[lo:hi], cols=None)

    return dict(
        T1=T1, T2=T2, jc0=jc0,
        jchunk=lambda c, lo, hi: run(JFH.fused_hdqn_chunk, jcfg, jep, c, lo,
                                     hi),
        pchunk=lambda c, lo, hi: run(FH.fused_hdqn_chunk, TH._port_cfg(jcfg),
                                     ep, c, lo, hi),
        template=lambda: JFH.fused_hdqn_init(jax.random.key(2), jcfg, jep, n),
        coerce=JFH.coerce_hdqn_carry, to_port=FH.hdqn_carry_from_numpy,
        check=TH._check, learns="lo_learns")


def _k8_case():
    n, T1, T2 = 128, 4, 6
    kw = dict(lr=1e-3, gamma=0.9, target_sync_episodes=3,
              memory_capacity=5 * n, obs_scale=0.01,
              opponent=JFT.OPP_SELFPLAY, per=True, n_step=3, per_alpha=0.6,
              per_beta=0.4, batch_size=32)
    jcfg, cfg = JRainbowConfig(**kw), RB.RainbowConfig(**kw)
    jep, ep = JEnvParams(max_steps=16), EnvParams(max_steps=16)
    rng = np.random.default_rng(23)
    T = T1 + T2
    hi_r = np.maximum(np.arange(T) - (cfg.n_step - 1), 0)
    rounds = np.minimum(rng.integers(0, 5, T), hi_r).astype(np.int32)
    cols = np.zeros(T, np.int32)
    us = rng.random(T).astype(np.float32)
    jc0 = TR._mk(jcfg, jep, n, 3, 900)

    def run(fn, c_, e, c, lo, hi):
        return fn(c_, e, c, hi - lo, seed=0, greedy=True,
                  rounds=rounds[lo:hi], cols=cols[lo:hi], us=us[lo:hi])

    def check(got, want):
        TR._check(got, FRB.rainbow_carry_from_numpy(want, CPU))

    return dict(
        T1=T1, T2=T2, jc0=jc0,
        jchunk=lambda c, lo, hi: run(JFR.fused_rainbow_chunk, jcfg, jep, c,
                                     lo, hi),
        pchunk=lambda c, lo, hi: run(FRB.fused_rainbow_chunk, cfg, ep, c, lo,
                                     hi),
        template=lambda: JFR.fused_rainbow_init(jax.random.key(3), jcfg, jep,
                                                n),
        coerce=JFR.coerce_rainbow_carry, to_port=FRB.rainbow_carry_from_numpy,
        check=check, learns="learns")


def _k9_case():
    n, T1, T2 = 128, 9, 9
    kw = dict(lr=1e-3, gamma=0.9, target_sync=5, seq_len=4, burn_in=1,
              memory_capacity=2 * n, opponent=JFD.OPP_SELFPLAY)
    jcfg, cfg = JDRQNConfig(**kw), DR.DRQNConfig(**kw)
    jep, ep = JEnvParams(max_steps=20), EnvParams(max_steps=20)
    rng = np.random.default_rng(42)
    rounds = rng.integers(0, 2, T1 + T2).astype(np.int32)
    cols = np.zeros(T1 + T2, np.int32)
    jc0 = TD._race_carry(jcfg, jep, n, 0, 100)

    def run(fn, c_, e, c, lo, hi):
        return fn(c_, e, c, hi - lo, seed=0, greedy=True,
                  rounds=rounds[lo:hi], cols=cols[lo:hi])

    return dict(
        T1=T1, T2=T2, jc0=jc0,
        jchunk=lambda c, lo, hi: run(JFD.fused_drqn_chunk, jcfg, jep, c, lo,
                                     hi),
        pchunk=lambda c, lo, hi: run(FD.fused_drqn_chunk, cfg, ep, c, lo, hi),
        template=lambda: JFD.fused_drqn_init(jax.random.key(0), jcfg, jep, n),
        coerce=JFD.coerce_drqn_carry, to_port=FD.drqn_carry_from_numpy,
        check=TD._check, learns="learns")


JAX_CASES = {"k5": _k5_case, "k7": _k7_case, "k8_per_3step": _k8_case,
             "k9": _k9_case}


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_save_restore_continue_matches_jax_orbax(_interpret_mode, tmp_path,
                                                 name):
    c = JAX_CASES[name]()
    T1, T = c["T1"], c["T1"] + c["T2"]
    jc1 = c["jchunk"](c["jc0"], 0, T1)
    # JAX: orbax save, restore into a fresh init's template, continue.
    want = c["jchunk"](_jax_resume(tmp_path, jc1, c["template"](),
                                   c["coerce"]), T1, T)
    # The port: the same state converted, its own save, restore, continue.
    pc1 = c["to_port"](jc1, CPU)
    got = c["pchunk"](_port_resume(tmp_path, pc1, c["to_port"](c["jc0"], CPU)),
                      T1, T)
    assert want[c["learns"]] > 0 and want["episodes"] > 0
    c["check"](got, want)


# ---------------------------------------------------------------------------
# Retention, refusals, interrupted saves
# ---------------------------------------------------------------------------

def _kept_by_jax(directory):
    return sorted(int(d) for d in os.listdir(directory) if d.isdigit())


def test_kept_steps_match_jax_checkpoint_manager(tmp_path):
    """``--checkpoint-every 1 --max-chunks 4``: saves 0..3, then the final
    save under 4; then a run resumed into the same directory saves 0 and
    the final 1 (both at or below the newest step: skipped), then 7."""
    sessions = [([0, 1, 2, 3], 4), ([0], 1), ([5, 6], 7)]
    state = {"a": np.arange(3, dtype=np.float32), "n": 1}
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    for i, (steps, final) in enumerate(sessions):
        jm, pm = JaxManager(jdir), CheckpointManager(pdir)
        for s in steps:
            jm.save(s, state)
            pm.save(s, {"a": torch.arange(3.0) + i, "n": s})
        jm.save(final, state, wait=True)
        pm.save(final, {"a": torch.arange(3.0) + i, "n": final}, wait=True)
        jm.close()
        pm.close()
        assert pm.all_steps() == _kept_by_jax(jdir)
        assert pm.latest_step() == jm.latest_step()
    assert pm.all_steps() == [5, 6, 7]
    back = pm.restore({"a": torch.zeros(3), "n": 0})
    assert back["n"] == 7 and torch.equal(back["a"], torch.arange(3.0) + 2)


def test_template_mismatch_names_the_leaf(tmp_path):
    init, chunk, _ = TRAINERS["k5"]()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, init())
    cfg = D.DQNConfig(memory_capacity=512, opponent="selfplay")
    wider = FT.fused_dqn_init(0, cfg, EP, 256, device=CPU)
    with pytest.raises(ValueError, match=r"state\['env'\]"):
        mgr.restore(wider)
    other_algo = FH.fused_hdqn_init(
        0, H.HDQNConfig(memory_capacity=256, goal_memory_capacity=256),
        EP, 128, device=CPU)
    with pytest.raises(ValueError, match="keys"):
        mgr.restore(other_algo)
    with pytest.raises(ValueError, match="int saved, float expected"):
        load_into({"steps": 1.0}, state_tree({"steps": 1}))


def test_rainbow_replay_kind_mismatch_is_refused(tmp_path):
    """The step-loop Rainbow carry's replay is a ReplayState or a PERState
    by ``--per``: a resume with the other is refused."""
    def init(per):
        cfg = RB.RainbowConfig(memory_capacity=256, per=per)
        return RB.rainbow_train_init(0, cfg, EP, 16, device=CPU)

    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, init(False))
    with pytest.raises(ValueError, match=r"state\.replay: a PERState "
                                         "expected, ReplayState saved"):
        mgr.restore(init(True))


def test_generator_of_the_other_device_type_is_refused(tmp_path):
    init, _, _ = _dqn_loop()
    tree = state_tree(init())
    assert tree["__dataclass__"] == "TrainCarry"
    # What a CUDA run writes: a Philox seed and offset.
    tree["fields"]["generator"] = {"__generator__": "cuda",
                                   "state": torch.zeros(16,
                                                        dtype=torch.uint8)}
    with pytest.raises(ValueError, match="a cuda generator's state cannot be "
                                         "restored into a cpu generator"):
        load_into(init(), tree)
    # The fused carries hold no generator.
    k5_init, _, _ = TRAINERS["k5"]()
    assert "__generator__" not in repr(state_tree(k5_init()))


def test_orbax_directory_is_refused(tmp_path):
    jm = JaxManager(str(tmp_path / "ckpt"))
    jm.save(0, {"a": np.zeros(2)}, wait=True)
    jm.close()
    with pytest.raises(ValueError, match="orbax checkpoints of the JAX "
                                         "package"):
        CheckpointManager(str(tmp_path / "ckpt")).restore({"a": None})
    with pytest.raises(ValueError, match="no checkpoints under"):
        CheckpointManager(str(tmp_path / "none")).restore({"a": None})


def test_interrupted_save_is_not_a_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.ones(2)})
    # A save killed before its rename leaves only its temporary file.
    with open(tmp_path / ".2.pt.999.tmp", "wb") as f:
        f.write(b"partial")
    assert mgr.latest_step() == 1 and mgr.all_steps() == [1]
    assert torch.equal(mgr.restore({"x": torch.zeros(2)})["x"],
                       torch.ones(2))
    assert mgr.save(2, {"x": torch.full((2,), 2.0)})
    assert mgr.latest_step() == 2


def test_checkpoint_loads_with_weights_only(tmp_path):
    init, chunk, _ = _rainbow_loop(True)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, chunk(init()))
    payload = torch.load(tmp_path / "0.pt", weights_only=True)
    assert payload["step"] == 0
    assert payload["state"]["fields"]["replay"]["__dataclass__"] == "PERState"
