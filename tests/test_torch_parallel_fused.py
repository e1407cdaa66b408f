"""K5 and K7 on every rank under local SGD, and checkpoints of a world
of ranks: the port on two gloo ranks on the CPU against the JAX package.

JAX's own sharded chunks are defined by its solo runs:
``tests/test_spmd_fused.py``'s two-device locks hold the ``shard_map``
result to the mean of two single-chip ``fused_*_chunk`` runs, each fed
one device's lanes and its ``fold_in(key(seed ^ salt), idx)`` draws.
Here the JAX side is exactly those two solo runs (the Pallas kernels in
interpret mode, no ``shard_map``), and each port rank starts from its
lanes of JAX's ``spmd_fused_*_init`` carry (``fused_carry_from_numpy``)
with the same draws, in greedy mode:

* the averaged sets equal the mean of JAX's solo sets at the tolerances
  of ``tests/test_torch_fused_trainer.py:_check`` (rtol 2e-3, atol 2e-4;
  ``tests/test_torch_fused_hdqn.py:_check`` for K7), the lanes each
  rank keeps equal JAX's solo lanes at those files' env and ring
  tolerances, and the counts are exact (learns equal, events summed);
* against the port's own solo runs everything is bit for bit: each
  rank's lanes are its solo's, and the averaged sets are ``(a + b) / 2``.

The stream rule in random mode: rank ``d`` draws under
``data_seed(seed, d)``, rank 0 under the run's seed, so its lanes equal a
single-chip chunk with ``seed`` and rank 1's differ.  A checkpoint of a
two-rank run resumes bit for bit (resume == continue, the check of
``examples/multiprocess_dryrun.py``), and each world refuses the other's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from merging_gym_tpu.agents.dqn import DQNConfig as JDQNConfig
from merging_gym_tpu.agents.hdqn import HDQNConfig as JHDQNConfig
from merging_gym_tpu.core.env import EnvParams as JEnvParams
from merging_gym_tpu.core.geometry import lon2coord as jax_lon2coord
from merging_gym_tpu.ops import fused_hdqn as JFH
from merging_gym_tpu.ops import fused_trainer as JFT
from merging_gym_tpu.parallel import spmd as JS
from merging_gym_tpu_torch.agents.dqn import DQNConfig
from merging_gym_tpu_torch.agents.hdqn import HDQNConfig
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.io.checkpoint import CheckpointManager
from merging_gym_tpu_torch.ops import fused_hdqn as FH
from merging_gym_tpu_torch.ops import fused_trainer as FT
from merging_gym_tpu_torch.parallel import spmd
from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_world import World, assert_results_equal

CPU = torch.device("cpu")
N, SETS5 = 2 * 128, ("p", "tp", "m", "v")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(2, tmp_path_factory.mktemp("world2"))
    yield w
    w.close()


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


def _mesh2():
    return Mesh(np.asarray(jax.devices()[:2]), ("data",))


def _numpy_carry(carry):
    def go(v):
        if isinstance(v, tuple):
            return tuple(np.asarray(a, np.float32) for a in v)
        if isinstance(v, jax.Array):
            return np.asarray(v)
        return v
    return {k: go(v) for k, v in carry.items()}


def _shrink6(t):
    return tuple((a - jnp.mean(a)) * 0.05 for a in t)


def _race(rows, lanes=slice(None)):
    """Rows 0-8 of an env (or K7 state) array with the race starts of
    tests/test_torch_fused_trainer.py:_race_start (lanes ``lanes`` of N),
    so that the short chunks cross wins, collisions and resets."""
    rng = np.random.default_rng(100)
    pos = np.stack([rng.uniform(870.0, 948.0, N),
                    rng.uniform(870.0, 948.0, N)]).astype(np.float32)
    vel = np.stack([rng.uniform(5.0, 40.0, N),
                    rng.uniform(5.0, 40.0, N)]).astype(np.float32)
    x1, y1 = jax_lon2coord(jnp.asarray(pos[0]), +1.0)
    x2, y2 = jax_lon2coord(jnp.asarray(pos[1]), -1.0)
    out = np.asarray(rows).copy()
    out[0:8] = np.concatenate([pos, vel, np.stack([
        np.asarray(x1), np.asarray(y1), np.asarray(x2),
        np.asarray(y2)])])[:, lanes]
    return jnp.asarray(out)


def _assert_mean(got, a, b, name, exact=False):
    for k, (g, x, y) in enumerate(zip(got, a, b)):
        x, y = np.asarray(x, np.float32), np.asarray(y, np.float32)
        want = (x + y) / np.float32(2.0)
        if exact:
            np.testing.assert_array_equal(np.asarray(g), want, f"{name}[{k}]")
        else:
            np.testing.assert_allclose(np.asarray(g), want, rtol=2e-3,
                                       atol=2e-4, err_msg=f"{name}[{k}]")


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

def test_fused_dqn_two_ranks_equal_mean_of_solo_runs(world, _interpret_mode):
    T, seed = 9, 11
    kw = dict(lr=1e-3, target_sync=4, memory_capacity=2 * N,
              opponent=JFT.OPP_SELFPLAY)
    jcfg, jep = JDQNConfig(**kw), JEnvParams(max_steps=25)

    def shrink(c, lanes=slice(None)):
        c["p"], c["tp"] = _shrink6(c["p"]), _shrink6(c["tp"])
        c["opp"] = c["p"]
        c["env"] = _race(c["env"], lanes)
        return c

    dist0 = _numpy_carry(shrink(JS.spmd_fused_dqn_init(
        jax.random.key(0), jcfg, jep, N, _mesh2())))
    inits, jax_solos, draws = [], [], []
    for idx in range(2):
        solo = shrink(JFT.fused_dqn_init(
            jax.random.key(0), jcfg.replace(memory_capacity=N), jep, N // 2),
            slice(idx * N // 2, (idx + 1) * N // 2))
        kd = jax.random.fold_in(jax.random.key(seed ^ 0x5EED), idx)
        k_r, k_c = jax.random.split(kd)
        draws.append((np.asarray(jax.random.randint(k_r, (T,), 0, solo["R"],
                                                    jnp.int32)),
                      np.asarray(jax.random.randint(k_c, (T,), 0, 1,
                                                    jnp.int32))))
        inits.append(_numpy_carry(solo))
        jax_solos.append(JFT.fused_dqn_chunk(
            jcfg, jep, solo, T, seed=seed, greedy=True, rounds=draws[-1][0],
            cols=draws[-1][1]))

    res = world.run("fused_dqn", dist0, kw, dict(max_steps=25), T, seed,
                    True, [d[0] for d in draws], [d[1] for d in draws])
    a, b = jax_solos
    cfg, ep = DQNConfig(**kw), EnvParams(max_steps=25)
    port_solos = []
    for idx in range(2):
        # The rank's lanes of the JAX spmd init are JAX's solo init.
        local = spmd.fused_carry_from_numpy(dist0, idx, 2, device=CPU)
        solo = FT.carry_from_numpy(inits[idx], device=CPU)
        for k in ("env", "ring", *SETS5):
            torch.testing.assert_close(local[k], solo[k], rtol=0, atol=0)
        assert (local["n"], local["n_local"], local["n_global"]) == (
            N // 2, N // 2, N)
        port_solos.append(FT.fused_dqn_chunk(
            cfg, ep, solo, T, seed, greedy=True, rounds=draws[idx][0],
            cols=draws[idx][1]))
    pa, pb = port_solos
    for r, got in enumerate(res):
        for k in SETS5:
            _assert_mean(got[k], a[k], b[k], k)
            _assert_mean(got[k], pa[k], pb[k], k, exact=True)
            for x, y in zip(got[k], res[0][k]):
                np.testing.assert_array_equal(x, y)
        want, own = (a, b)[r], port_solos[r]
        np.testing.assert_array_equal(got["env"], own["env"].numpy())
        np.testing.assert_array_equal(got["ring"], own["ring"].numpy())
        np.testing.assert_allclose(got["env"][0:4],
                                   np.asarray(want["env"])[0:4],
                                   rtol=2.5e-7, atol=1e-4)
        np.testing.assert_array_equal(got["env"][8:10],
                                      np.asarray(want["env"])[8:10])
        np.testing.assert_allclose(got["ring"], np.asarray(want["ring"]),
                                   rtol=1e-4, atol=1e-4)
        assert got["learns"] == a["learns"] == b["learns"]
        assert got["steps"] == T and got["env_steps"] == T * N
        for k in ("episodes", "collisions", "wins"):
            assert got[k] == a[k] + b[k], k
        np.testing.assert_allclose(
            got["last_loss"], (a["last_loss"] + b["last_loss"]) / 2.0,
            rtol=1e-3, atol=1e-6)
    assert a["episodes"] + b["episodes"] > 0


def test_fused_dqn_streams_per_rank(world):
    """Random mode: rank 0 is the single-chip chunk with the run's seed,
    rank 1 the one with ``data_seed(seed, 1)``; the sets are their
    mean."""
    kw = dict(lr=1e-3, target_sync=3, memory_capacity=4 * N,
              opponent="selfplay")
    ep_kw = dict(max_steps=30, random_start=True)
    cfg = DQNConfig(**kw).replace(memory_capacity=2 * N)
    ep = EnvParams(**ep_kw)
    solos = [FT.fused_dqn_chunk(cfg, ep, FT.fused_dqn_init(
        0, cfg, ep, N // 2, device=CPU), 4, spmd.data_seed(5, d))
        for d in range(2)]
    one = world.run("fused_dqn_fresh", kw, ep_kw, N, [(5, 4)])
    for d in range(2):
        np.testing.assert_array_equal(one[d]["env"], solos[d]["env"].numpy())
        np.testing.assert_array_equal(one[d]["ring"],
                                      solos[d]["ring"].numpy())
        for k in SETS5:
            _assert_mean(one[d][k], solos[0][k], solos[1][k], k, exact=True)
        assert one[d]["episodes"] == solos[0]["episodes"] + solos[1][
            "episodes"]
    assert not np.array_equal(one[0]["env"], one[1]["env"])

    two = world.run("fused_dqn_fresh", kw, ep_kw, N, [(5, 4), (6, 3)])
    for k in SETS5:
        for x, y in zip(two[0][k], two[1][k]):
            np.testing.assert_array_equal(x, y)
    assert two[0]["steps"] == 7 and two[0]["env_steps"] == 7 * N


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

def test_fused_hdqn_two_ranks_equal_mean_of_solo_runs(world, _interpret_mode):
    T, seed = 8, 13
    kw = dict(lr=1e-3, target_sync=3, memory_capacity=2 * N,
              goal_memory_capacity=2 * N, opponent=JFT.OPP_L0)
    jcfg, jep = JHDQNConfig(**kw), JEnvParams(max_steps=20)

    def shrink(c, lanes=slice(None)):
        for k in ("u_p", "u_tp", "l_p", "l_tp"):
            c[k] = _shrink6(c[k])
        c["opp_u"], c["opp_l"] = c["u_p"], c["l_p"]
        c["state"] = _race(c["state"], lanes)
        return c

    dist0 = _numpy_carry(shrink(JS.spmd_fused_hdqn_init(
        jax.random.key(0), jcfg, jep, N, _mesh2())))
    inits, jax_solos, draws = [], [], []
    for idx in range(2):
        solo = shrink(JFH.fused_hdqn_init(
            jax.random.key(0),
            jcfg.replace(memory_capacity=N, goal_memory_capacity=N), jep,
            N // 2), slice(idx * N // 2, (idx + 1) * N // 2))
        kd = jax.random.fold_in(jax.random.key(seed ^ 0x4D0), idx)
        k1, k2, _ = jax.random.split(kd, 3)
        draws.append((np.asarray(jax.random.randint(
            k1, (T,), 0, solo["R_lo"], jnp.int32)), np.asarray(
            jax.random.randint(k2, (T,), 0, solo["R_up"], jnp.int32))))
        inits.append(_numpy_carry(solo))
        jax_solos.append(JFH.fused_hdqn_chunk(
            jcfg, jep, solo, T, seed=seed, greedy=True,
            lo_rounds=draws[-1][0], up_rounds=draws[-1][1]))

    res = world.run("fused_hdqn", dist0, kw, dict(max_steps=20), T, seed,
                    True, [d[0] for d in draws], [d[1] for d in draws])
    a, b = jax_solos
    cfg, ep = HDQNConfig(**kw), EnvParams(max_steps=20)
    port_solos = [FH.fused_hdqn_chunk(
        cfg, ep, FH.hdqn_carry_from_numpy(inits[i], device=CPU), T, seed,
        greedy=True, lo_rounds=draws[i][0], up_rounds=draws[i][1])
        for i in range(2)]
    for r, got in enumerate(res):
        for k in FH.SETS[:8]:
            _assert_mean(got[k], a[k], b[k], k)
            _assert_mean(got[k], port_solos[0][k], port_solos[1][k], k,
                         exact=True)
        want, own = (a, b)[r], port_solos[r]
        for k in ("state", "lo_ring", "up_ring"):
            np.testing.assert_array_equal(got[k], own[k].numpy())
        g, w = got["state"], np.asarray(want["state"])
        np.testing.assert_allclose(g[0:4], w[0:4], rtol=2.5e-7, atol=1e-4)
        for row in (8, 9, 11, 12, 14):
            np.testing.assert_array_equal(g[row], w[row])
        for k in ("lo_ring", "up_ring"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       rtol=1e-4, atol=1e-4)
        assert got["lo_learns"] == a["lo_learns"] == b["lo_learns"]
        assert got["env_steps"] == T * N
        for k in ("episodes", "collisions", "wins"):
            assert got[k] == a[k] + b[k], k
        np.testing.assert_allclose(
            got["last_loss"], (a["last_loss"] + b["last_loss"]) / 2.0,
            rtol=1e-3, atol=1e-6)
    assert a["episodes"] + b["episodes"] > 0 and a["lo_learns"] > 0


# ---------------------------------------------------------------------------
# Refusals and checkpoints
# ---------------------------------------------------------------------------

def test_refusals_of_a_two_rank_world(world):
    out = world.run("refusals", N, 2 * N + 1)
    for r in out:
        assert "memory_capacity 513 must divide over 2" in r["fused_dqn"]
        assert "goal_memory_capacity 513 must divide" in r["fused_hdqn"]
        assert "num_envs 257 must divide over 2" in r["fused_envs"]
        assert "num_envs 3 must divide over 2" in r["loop_envs"]
        assert "pmean_axis='data'" in r["hdqn_axis"]


def test_checkpoint_resume_equals_continue_on_two_ranks(world, tmp_path):
    single = CheckpointManager(tmp_path / "single")
    cfg = DQNConfig(memory_capacity=2 * 256, opponent="selfplay")
    assert single.save(1, FT.fused_dqn_init(3, cfg, EnvParams(), 256,
                                            device=CPU))
    out = world.run("checkpoint_resume", str(tmp_path), 3)
    for r, res in enumerate(out):
        for name in ("fused", "loop"):
            assert res[name]["steps"] == [1, 2]
            assert_results_equal(res[name]["b"], res[name]["c"], name)
            assert_results_equal(res[name]["b"], res[name]["a"], name)
        assert "world of [1] rank(s); this run has 2" in res["refused"]
    assert sorted(os.listdir(tmp_path / "fused")) == sorted(
        [f"{s}.rank{r}-of-2.pt" for s in (1, 2) for r in (0, 1)]
        + ["1.of-2.done", "2.of-2.done"])
    with pytest.raises(ValueError, match=r"world of \[2\] rank"):
        CheckpointManager(tmp_path / "fused").restore(
            FT.fused_dqn_init(3, cfg, EnvParams(), 128, device=CPU))
    assert not np.array_equal(out[0]["fused"]["b"]["env"],
                              out[1]["fused"]["b"]["env"])


def test_checkpoint_cut_between_ranks_restores_the_same_step(world,
                                                            tmp_path):
    """A save cut after rank 0's rename and before rank 1's (so before
    the commit) leaves step 1 as the newest on both ranks: both restore
    it, and both write step 2 again, rank 0 over its own stale file."""
    out = world.run("checkpoint_cut_between_ranks", str(tmp_path))
    for r, res in enumerate(out):
        assert res["saved"] == [True, True]
        assert res["steps"] == [1] and res["latest"] == 1
        assert res["restored"]["step"] == 1 and res["restored"]["rank"] == r
        np.testing.assert_array_equal(res["restored"]["x"], 10.0 + r)
        assert res["resaved"] and res["steps_after"] == [1, 2]
        assert res["restored_after"]["step"] == 2
        np.testing.assert_array_equal(res["restored_after"]["x"], 20.0 + r)
    assert sorted(os.listdir(tmp_path)) == sorted(
        [f"{s}.rank{r}-of-2.pt" for s in (1, 2) for r in (0, 1)]
        + ["1.of-2.done", "2.of-2.done"])
