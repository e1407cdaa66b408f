"""K8 and K9 on every rank under local SGD, checkpoints of their worlds,
and the port's multi-process dryrun: the port on the CPU against the JAX
package and against its own single-chip chunks.

* A world of one (gloo in this process) equals the single-chip
  ``fused_rainbow_chunk`` (uniform, and PER 3-step) and
  ``fused_drqn_chunk`` bit for bit, in random and in greedy mode.
* On two gloo ranks the JAX side is its two solo chunks (the Pallas
  kernels in interpret mode, no ``shard_map``), as in
  ``tests/test_torch_parallel_fused.py``: each port rank starts from its
  lanes of JAX's ``spmd_fused_*_init`` carry (K8's noise block included,
  ``rainbow_fused_carry_from_numpy``, ``drqn_fused_carry_from_numpy``)
  and runs with explicit streams in greedy mode.  The averaged ``p``,
  ``tp``, ``m`` and ``v`` equal the mean of JAX's solo runs at the
  tolerances of ``_check`` in ``tests/test_torch_fused_rainbow.py`` and
  ``tests/test_torch_fused_drqn.py`` (rtol 2e-3, atol 2e-4), each rank's
  lanes, noise and windows equal its JAX solo run at that ``_check``'s
  env, ring and window tolerances (noise exactly), PER's running max
  (env row 13) is the larger of the two solo maxima, and the counts are
  exact.  Against the port's own solo runs everything is bit for bit.
* Random mode: rank ``d`` runs under ``data_seed(seed, d)`` and K8's
  rank ``d`` starts from the noise of ``fused_rainbow_init`` under that
  seed.
* A checkpoint of a two-rank K8, K9, Rainbow-loop and DRQN-loop run
  resumes bit for bit; the refusals of a two-rank world; and the dryrun
  (``python -m merging_gym_tpu_torch.parallel.dryrun``) at two processes
  with ``--cpu``: every tag of ``examples/multiprocess_dryrun.py`` on both
  ranks, with equal checksums and the expected env-steps.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from merging_gym_tpu.agents.drqn import DRQNConfig as JDRQNConfig
from merging_gym_tpu.agents.rainbow import RainbowConfig as JRainbowConfig
from merging_gym_tpu.core.env import EnvParams as JEnvParams
from merging_gym_tpu.core.geometry import lon2coord as jax_lon2coord
from merging_gym_tpu.ops import fused_drqn as JFD
from merging_gym_tpu.ops import fused_rainbow as JFR
from merging_gym_tpu.parallel import spmd as JS
from merging_gym_tpu_torch.agents.drqn import DRQNConfig
from merging_gym_tpu_torch.agents.rainbow import RainbowConfig
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.ops import fused_drqn as FD
from merging_gym_tpu_torch.ops import fused_rainbow as FR
from merging_gym_tpu_torch.parallel import dryrun
from merging_gym_tpu_torch.parallel import mesh as M
from merging_gym_tpu_torch.parallel import multihost, spmd
from tests.test_torch_parallel import assert_tree_equal
from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_world import World, assert_results_equal

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, SETS = 2 * 128, ("p", "tp", "m", "v")


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    store = tmp_path_factory.mktemp("world1") / "store"
    multihost.initialize(f"file://{store}", 1, 0, device="cpu")
    yield M.make_mesh(1, 1)
    dist.destroy_process_group()


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


def _race(env, lanes, seed=100):
    """Rows 0-7 of ``env`` with mid-race starts (lanes ``lanes`` of N), so
    that short chunks cross wins, collisions and resets."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(870.0, 948.0, N),
                    rng.uniform(870.0, 948.0, N)]).astype(np.float32)
    vel = np.stack([rng.uniform(5.0, 40.0, N),
                    rng.uniform(5.0, 40.0, N)]).astype(np.float32)
    x1, y1 = jax_lon2coord(jnp.asarray(pos[0]), +1.0)
    x2, y2 = jax_lon2coord(jnp.asarray(pos[1]), -1.0)
    out = np.asarray(env).copy()
    out[0:8] = np.concatenate([pos, vel, np.stack([
        np.asarray(x1), np.asarray(y1), np.asarray(x2),
        np.asarray(y2)])])[:, lanes]
    return jnp.asarray(out)


def _lanes(idx):
    return slice(idx * N // 2, (idx + 1) * N // 2)


def _assert_mean(got, a, b, name, exact=False):
    x, y = np.asarray(a, np.float32), np.asarray(b, np.float32)
    want = (x + y) / np.float32(2.0)
    if exact:
        np.testing.assert_array_equal(np.asarray(got), want, name)
    else:
        np.testing.assert_allclose(np.asarray(got), want, rtol=2e-3,
                                   atol=2e-4, err_msg=name)


# ---------------------------------------------------------------------------
# A world of one
# ---------------------------------------------------------------------------

RB_CASES = {
    "uniform": dict(lr=1e-3, target_sync_episodes=3, memory_capacity=2 * N,
                    obs_scale=0.01, opponent="selfplay"),
    "per_3step": dict(lr=1e-3, target_sync_episodes=3,
                      memory_capacity=5 * N, obs_scale=0.01,
                      opponent="selfplay", per=True, n_step=3,
                      batch_size=32),
}


def _single(carry):
    return {k: v for k, v in carry.items() if k not in ("n_local",
                                                        "n_global")}


@pytest.mark.parametrize("greedy", [False, True])
@pytest.mark.parametrize("case", sorted(RB_CASES))
def test_world_of_one_fused_rainbow_equals_single_chip(mesh1, case, greedy):
    n = N // 2
    cfg = RainbowConfig(**dict(RB_CASES[case],
                               memory_capacity=RB_CASES[case]
                               ["memory_capacity"] // 2))
    ep = EnvParams(max_steps=15, random_start=not greedy)
    got = spmd.spmd_fused_rainbow_init(0, cfg, ep, n, mesh1, device=CPU)
    want = FR.fused_rainbow_init(0, cfg, ep, n, device=CPU)
    assert (got["n"], got["n_local"], got["n_global"]) == (n, n, n)
    for seed, T in ((7, 3), (8, 4)):
        got = spmd.spmd_fused_rainbow_chunk(mesh1, cfg, ep, got, T, seed,
                                            greedy=greedy)
        want = FR.fused_rainbow_chunk(cfg, ep, want, T, seed, greedy=greedy)
    assert want["learns"] > 0
    assert_tree_equal(_single(got), want)


@pytest.mark.parametrize("greedy", [False, True])
def test_world_of_one_fused_drqn_equals_single_chip(mesh1, greedy):
    n = N // 2
    cfg = DRQNConfig(lr=1e-3, target_sync=3, seq_len=3, burn_in=1,
                     memory_capacity=2 * n, opponent="selfplay")
    ep = EnvParams(max_steps=20, random_start=not greedy)
    got = spmd.spmd_fused_drqn_init(0, cfg, ep, n, mesh1, device=CPU)
    want = FD.fused_drqn_init(0, cfg, ep, n, device=CPU)
    for seed, T in ((7, 5), (8, 4)):
        got = spmd.spmd_fused_drqn_chunk(mesh1, cfg, ep, got, T, seed,
                                         greedy=greedy)
        want = FD.fused_drqn_chunk(cfg, ep, want, T, seed, greedy=greedy)
    assert want["learns"] > 0
    assert_tree_equal(_single(got), want)


# ---------------------------------------------------------------------------
# K8 on two ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(RB_CASES))
def test_fused_rainbow_two_ranks_equal_mean_of_solo_runs(world,
                                                         _interpret_mode,
                                                         case):
    T, seed, kw = 10, 13, RB_CASES[case]
    jcfg, jep = JRainbowConfig(**kw), JEnvParams(max_steps=16)
    local = jcfg.replace(memory_capacity=kw["memory_capacity"] // 2)
    n_step = jcfg.n_step

    dist0 = JS.spmd_fused_rainbow_init(jax.random.key(0), jcfg, jep, N,
                                       _mesh2())
    dist0["env"] = _race(dist0["env"], slice(None))
    dist0 = _numpy_carry(dist0)
    rng = np.random.default_rng(seed)
    R = local.memory_capacity // (N // 2)
    hi = np.maximum(np.arange(T) - (n_step - 1), 0)
    streams = [(np.minimum(rng.integers(0, R, T), hi).astype(np.int32),
                np.zeros(T, np.int32), rng.random(T).astype(np.float32))
               for _ in range(2)]
    inits, jax_solos = [], []
    for idx in range(2):
        solo = JFR.fused_rainbow_init(jax.random.key(0), local, jep, N // 2)
        for k in ("eps", "teps"):   # this device's block of the noise
            solo[k] = tuple(jnp.asarray(np.split(a, 2, axis=1)[idx])
                            for a in dist0[k])
        solo["env"] = _race(solo["env"], _lanes(idx))
        inits.append(_numpy_carry(solo))
        rounds, cols, us = streams[idx]
        jax_solos.append(FR.rainbow_carry_from_numpy(JFR.fused_rainbow_chunk(
            local, jep, solo, T, seed=seed, greedy=True, rounds=rounds,
            cols=cols, us=us), CPU))

    res = world.run("fused_rainbow", dist0, kw, dict(max_steps=16), T, seed,
                    True, *([s[i] for s in streams] for i in range(3)))
    a, b = jax_solos
    cfg = RainbowConfig(**dict(kw, memory_capacity=local.memory_capacity))
    ep = EnvParams(max_steps=16)
    port_solos = []
    for idx in range(2):
        mine = spmd.rainbow_fused_carry_from_numpy(dist0, idx, 2, device=CPU)
        solo = FR.rainbow_carry_from_numpy(inits[idx], CPU)
        for k in ("env", "ring", "eps", "teps", *SETS):
            torch.testing.assert_close(mine[k], solo[k], rtol=0, atol=0)
        assert (mine["n"], mine["n_local"], mine["n_global"]) == (
            N // 2, N // 2, N)
        rounds, cols, us = streams[idx]
        port_solos.append(FR.fused_rainbow_chunk(
            cfg, ep, solo, T, seed, greedy=True, rounds=rounds, cols=cols,
            us=us))
    pa, pb = port_solos
    assert not np.array_equal(pa["eps"].numpy(), pb["eps"].numpy())
    for r, got in enumerate(res):
        for k in SETS:
            _assert_mean(got[k], a[k], b[k], k)
            _assert_mean(got[k], pa[k], pb[k], k, exact=True)
            np.testing.assert_array_equal(got[k], res[0][k])
        want, own = (a, b)[r], port_solos[r]
        own_env = own["env"].numpy().copy()
        if cfg.per:   # the running max priority is the ranks' maximum
            own_env[13] = np.maximum(pa["env"][13].numpy(),
                                     pb["env"][13].numpy())
            np.testing.assert_allclose(
                got["env"][13], np.maximum(a["env"][13].numpy(),
                                           b["env"][13].numpy()),
                rtol=1e-4, atol=1e-5)
            assert got["env"][13, 0] > 1.0
        np.testing.assert_array_equal(got["env"], own_env)
        for k in ("ring", "eps", "teps"):
            np.testing.assert_array_equal(got[k], own[k].numpy())
        g, w = got["env"], want["env"].numpy()
        np.testing.assert_allclose(g[0:4], w[0:4], rtol=2.5e-7, atol=1e-4)
        np.testing.assert_array_equal(g[8], w[8])
        np.testing.assert_allclose(g[10], w[10], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(g[11:13], w[11:13])
        np.testing.assert_allclose(got["ring"], want["ring"].numpy(),
                                   rtol=1e-4, atol=1e-4)
        for k in ("eps", "teps"):   # greedy: never redrawn
            np.testing.assert_array_equal(got[k], want[k].numpy())
        assert got["learns"] == a["learns"] == b["learns"] == T - n_step
        assert got["steps"] == T and got["env_steps"] == T * N
        for k in ("episodes", "collisions", "wins"):
            assert got[k] == a[k] + b[k], k
        np.testing.assert_allclose(
            got["last_loss"], (a["last_loss"] + b["last_loss"]) / 2.0,
            rtol=1e-3, atol=1e-6)
    assert a["episodes"] + b["episodes"] > 0


# ---------------------------------------------------------------------------
# K9 on two ranks
# ---------------------------------------------------------------------------

def _drqn_race(carry, lanes):
    """tests/test_torch_fused_drqn.py:_race_carry on lanes ``lanes``:
    centred, shrunk nets and mid-race starts with the window's first
    obs."""
    def shrink(t):
        return tuple((a - jnp.mean(a)) * 0.05 for a in t)
    carry["p"], carry["tp"] = shrink(carry["p"]), shrink(carry["tp"])
    carry["opp"] = carry["p"]
    carry["env"] = _race(carry["env"], lanes, seed=300)
    win = np.asarray(carry["win"]).copy()
    win[0:10] = FD._obs_rows(torch.tensor(np.asarray(
        carry["env"])[0:8])).numpy()
    carry["win"] = jnp.asarray(win)
    return carry


def test_fused_drqn_two_ranks_equal_mean_of_solo_runs(world, _interpret_mode):
    T, seed = 10, 21
    kw = dict(lr=1e-3, gamma=0.9, target_sync=3, seq_len=3, burn_in=1,
              memory_capacity=2 * N, opponent="selfplay")
    jcfg, jep = JDRQNConfig(**kw), JEnvParams(max_steps=20)
    local = jcfg.replace(memory_capacity=N)
    dist0 = _numpy_carry(_drqn_race(JS.spmd_fused_drqn_init(
        jax.random.key(0), jcfg, jep, N, _mesh2()), slice(None)))
    rng = np.random.default_rng(seed)
    streams = [(rng.integers(0, 2, T).astype(np.int32),
                np.zeros(T, np.int32)) for _ in range(2)]
    inits, jax_solos = [], []
    for idx in range(2):
        solo = _drqn_race(JFD.fused_drqn_init(jax.random.key(0), local, jep,
                                              N // 2), _lanes(idx))
        inits.append(_numpy_carry(solo))
        jax_solos.append(JFD.fused_drqn_chunk(
            local, jep, solo, T, seed=seed, greedy=True,
            rounds=streams[idx][0], cols=streams[idx][1]))

    res = world.run("fused_drqn", dist0, kw, dict(max_steps=20), T, seed,
                    True, [s[0] for s in streams], [s[1] for s in streams])
    a, b = jax_solos
    cfg, ep = DRQNConfig(**dict(kw, memory_capacity=N)), EnvParams(
        max_steps=20)
    port_solos = []
    for idx in range(2):
        mine = spmd.drqn_fused_carry_from_numpy(dist0, idx, 2, device=CPU)
        solo = FD.drqn_carry_from_numpy(inits[idx], CPU)
        for k in ("env", "win", "ring", *SETS):
            torch.testing.assert_close(mine[k], solo[k], rtol=0, atol=0)
        port_solos.append(FD.fused_drqn_chunk(
            cfg, ep, solo, T, seed, greedy=True, rounds=streams[idx][0],
            cols=streams[idx][1]))
    pa, pb = port_solos
    for r, got in enumerate(res):
        for k in SETS:
            _assert_mean(got[k], FD._flat_from_jax_t(a[k], CPU),
                         FD._flat_from_jax_t(b[k], CPU), k)
            _assert_mean(got[k], pa[k], pb[k], k, exact=True)
            np.testing.assert_array_equal(got[k], res[0][k])
        want, own = (a, b)[r], port_solos[r]
        for k in ("env", "win", "ring"):
            np.testing.assert_array_equal(got[k], own[k].numpy())
        g, w = got["env"], np.asarray(want["env"])
        np.testing.assert_allclose(g[0:4], w[0:4], rtol=2.5e-7, atol=1e-4)
        np.testing.assert_array_equal(g[8:10], w[8:10])
        np.testing.assert_allclose(g[10], w[10], rtol=0, atol=1e-4)
        np.testing.assert_allclose(g[11:], w[11:], rtol=1e-4, atol=1e-5)
        for k in ("win", "ring"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       rtol=1e-4, atol=1e-4)
        assert got["learns"] == a["learns"] == b["learns"] > 0
        assert got["env_steps"] == T * N
        for k in ("episodes", "collisions", "wins"):
            assert got[k] == a[k] + b[k], k
        np.testing.assert_allclose(
            got["last_loss"], (a["last_loss"] + b["last_loss"]) / 2.0,
            rtol=2e-3, atol=1e-6)
    assert a["episodes"] + b["episodes"] > 0


# ---------------------------------------------------------------------------
# Random mode, refusals, checkpoints, the dryrun
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["rainbow", "drqn"])
def test_fused_streams_and_noise_per_rank(world, family):
    """Rank ``d`` is the single-chip chunk under ``data_seed(seed, d)``;
    K8's rank ``d`` starts from ``fused_rainbow_init``'s noise under
    ``data_seed(0, d)``.  The sets are the mean of the two."""
    ep_kw = dict(max_steps=30, random_start=True)
    ep = EnvParams(**ep_kw)
    if family == "rainbow":
        kw = dict(RB_CASES["per_3step"], memory_capacity=8 * N)
        cfg = RainbowConfig(**dict(kw, memory_capacity=4 * N))
        init, chunk, T = FR.fused_rainbow_init, FR.fused_rainbow_chunk, 5
    else:
        kw = dict(seq_len=3, burn_in=1, memory_capacity=2 * N,
                  opponent="selfplay")
        cfg = DRQNConfig(**dict(kw, memory_capacity=N))
        init, chunk, T = FD.fused_drqn_init, FD.fused_drqn_chunk, 7
    solos = []
    for d in range(2):
        c = init(0, cfg, ep, N // 2, device=CPU)
        if family == "rainbow":
            own = init(spmd.data_seed(0, d), cfg, ep, N // 2, device=CPU)
            c["eps"], c["teps"] = own["eps"], own["teps"]
        solos.append(chunk(cfg, ep, c, T, spmd.data_seed(5, d)))
    res = world.run("fused_rb_fresh", family, kw, ep_kw, N, [(5, T)])
    for d in range(2):
        own = solos[d]
        keys = ["ring"] + (["eps", "teps"] if family == "rainbow"
                           else ["env", "win"])
        for k in keys:
            np.testing.assert_array_equal(res[d][k], own[k].numpy(), k)
        for k in SETS:
            _assert_mean(res[d][k], solos[0][k], solos[1][k], k, exact=True)
        assert res[d]["episodes"] == solos[0]["episodes"] + solos[1][
            "episodes"]
        assert res[d]["learns"] == own["learns"] > 0
    if family == "rainbow":
        for d in range(2):   # rows 0-12 rank-local; PER's max row shared
            np.testing.assert_array_equal(res[d]["env"][:13],
                                          solos[d]["env"][:13].numpy())
            np.testing.assert_array_equal(
                res[d]["env"][13], np.maximum(solos[0]["env"][13].numpy(),
                                              solos[1]["env"][13].numpy()))
    assert not np.array_equal(res[0]["ring"], res[1]["ring"])


def test_rainbow_drqn_refusals_of_a_two_rank_world(world):
    for r in world.run("refusals_rb", N):
        assert "memory_capacity 513 must divide over 2" in r[
            "fused_rainbow_capacity"]
        assert "num_envs 257 must divide over 2" in r["fused_rainbow_envs"]
        assert "memory_capacity 513 must divide over 2" in r[
            "fused_drqn_capacity"]
        assert "RainbowConfig(pmean_axis='data')" in r["rainbow_axis"]
        assert "num_envs 7 must divide over 2" in r["rainbow_envs"]
        assert "DRQNConfig(pmean_axis='data')" in r["drqn_axis"]
        assert "num_envs 7 must divide over 2" in r["drqn_envs"]
        assert "per-rank memory_capacity=3 < local envs 4" in r["drqn_ring"]


def test_checkpoint_resume_equals_continue_k8_k9_on_two_ranks(world,
                                                             tmp_path):
    out = world.run("checkpoint_resume_rb", str(tmp_path), 3)
    for res in out:
        for name in ("k8", "k9", "rainbow_loop", "drqn_loop"):
            assert res[name]["steps"] == [1, 2], name
            assert_results_equal(res[name]["b"], res[name]["c"], name)
    assert out[0]["k8"]["b"]["learns"] == 3
    assert out[0]["k9"]["b"]["learns"] == 1
    for name in ("k8", "k9"):
        assert sorted(os.listdir(tmp_path / name)) == sorted(
            [f"{s}.rank{r}-of-2.pt" for s in (1, 2) for r in (0, 1)]
            + ["1.of-2.done", "2.of-2.done"])
        assert not np.array_equal(out[0][name]["b"]["env"],
                                  out[1][name]["b"]["env"])


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_dryrun_two_processes_on_the_cpu(tmp_path):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "merging_gym_tpu_torch.parallel.dryrun",
         str(r), "2", str(port), "--cpu", "--ckpt-dir", str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out)
        assert p.returncode == 0, out[-3000:]
    lanes = 2 * dryrun.LANES
    for tag, steps in (("OK", 9 * dryrun.LOOP_ENVS),
                       ("FUSED OK", 6 * lanes), ("RAINBOW OK", 3 * lanes),
                       ("HDQN OK", 3 * lanes), ("DRQN OK", 6 * lanes),
                       ("CKPT OK", 15 * dryrun.LOOP_ENVS)):
        lines = [ln for r, out in enumerate(outs) for ln in out.splitlines()
                 if ln.startswith(f"PROC{r} {tag} env_steps=")]
        assert len(lines) == 2, (tag, outs)
        assert len({ln.split(" ", 1)[1] for ln in lines}) == 1, lines
        assert f"env_steps={steps} " in lines[0], lines
    assert os.listdir(tmp_path) == []   # the CKPT section cleans up


@pytest.mark.skipif(torch.cuda.is_available(), reason="the refusal of a "
                    "machine without a card")
def test_dryrun_refuses_without_a_card(monkeypatch):
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main(["0", "1", str(_free_port())])
    assert dryrun.place(1, 2, cpu=True) == ("cpu", "gloo")
