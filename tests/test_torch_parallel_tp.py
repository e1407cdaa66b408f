"""The port's SPMD step loops on a world of four gloo ranks on the CPU,
against ``merging_gym_tpu/parallel/spmd.py``.

* ``qnet_apply_tp`` on (1, 2) and (2, 2) meshes equals JAX's
  ``qnet_apply_tp`` under ``shard_map`` and the single-device forward, at
  ``tests/test_spmd.py``'s 1e-5;
* the pinned divergence: the port's tensor-parallel TD gradients equal
  JAX's single-device ``td_loss`` gradients (rtol 1e-5, atol 1e-6), while
  JAX's tensor-parallel gradients under ``check_vma=False`` are ``tp``
  times larger on the shards upstream of ``psum("model")`` (fc0.w, fc0.b,
  fc1.w) and equal on fc1.b and fc2;
* the analogs of ``tests/test_spmd.py``: data- and tensor-parallel runs
  learn, the params stay bitwise replicated over ``data``, the metrics
  are global and accumulate across chunks, and h-DQN runs data-parallel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from merging_gym_tpu.agents import dqn as JD
from merging_gym_tpu.nn.mlp import qnet_apply as jax_qnet_apply
from merging_gym_tpu.nn.mlp import qnet_init as jax_qnet_init
from merging_gym_tpu.parallel import spmd as JS
from merging_gym_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tests.torch_world import World

MESHES = [(1, 2), (2, 2)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("world4"))
    yield w
    w.close()


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def nets():
    # The reference's uniform [0, 1) init gives Q-values in the
    # thousands; centred and shrunk (tests/test_torch_fused_trainer.py
    # :_nets) the gradients are of order one.
    def net(seed):
        p = jax_qnet_init(jax.random.key(seed), 10, 5, dtype=jnp.float32)
        return _np(jax.tree.map(lambda w: (w - 0.5) * 0.1, p))

    params, target = net(2), net(5)
    rng = np.random.default_rng(3)
    batch = {"obs": rng.standard_normal((16, 10)).astype(np.float32),
             "action": rng.integers(0, 5, 16).astype(np.int32),
             "reward": rng.standard_normal(16).astype(np.float32),
             "next_obs": rng.standard_normal((16, 10)).astype(np.float32),
             "done": rng.random(16) < 0.2}
    return params, target, batch


def _jax_sharded(mesh, params):
    specs = JS.qnet_pspecs(params)
    return specs, jax.device_put(
        jax.tree.map(jnp.asarray, params),
        jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                     is_leaf=lambda v: isinstance(v, P)))


def _by_coord(results, data, model):
    """Rank results ``(d, m, value)`` -> ``{(d, m): value}``."""
    out = {(d, m): v for d, m, v in filter(None, results)}
    assert sorted(out) == [(d, m) for d in range(data)
                           for m in range(model)]
    return out


@pytest.mark.parametrize("data,model", MESHES)
def test_tp_forward_matches_jax_and_single_device(world, nets, devices8,
                                                  data, model):
    params = nets[0]
    x = np.random.default_rng(4).standard_normal((64, 10)).astype(
        np.float32) * 10
    got = _by_coord(world.run("tp_forward", data, model, params, x),
                    data, model)
    for d in range(data):  # the model ranks of a row agree bit for bit
        for m in range(1, model):
            np.testing.assert_array_equal(got[(d, m)], got[(d, 0)])
    q = np.concatenate([got[(d, 0)] for d in range(data)])

    mesh = jax_make_mesh(data=data, model=model,
                         devices=devices8[:data * model])
    specs, sharded = _jax_sharded(mesh, params)
    fn = jax.shard_map(JS.qnet_apply_tp, mesh=mesh,
                       in_specs=(specs, P("data")), out_specs=P("data"),
                       check_vma=False)
    want_tp = np.asarray(jax.jit(fn)(sharded, jnp.asarray(x)))
    want = np.asarray(jax_qnet_apply(jax.tree.map(jnp.asarray, params),
                                     jnp.asarray(x)))
    np.testing.assert_allclose(q, want_tp, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(q, want, rtol=1e-5, atol=1e-5)


def _unshard(shards):
    return {"fc0": {"w": np.concatenate([s["fc0"]["w"] for s in shards], 1),
                    "b": np.concatenate([s["fc0"]["b"] for s in shards])},
            "fc1": {"w": np.concatenate([s["fc1"]["w"] for s in shards]),
                    "b": shards[0]["fc1"]["b"]},
            "fc2": shards[0]["fc2"]}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("data,model", MESHES)
def test_tp_gradients_are_single_device_not_jax_tp(world, nets, devices8,
                                                   data, model):
    """The pinned divergence (ROADMAP.md, Queue 3): JAX's tp gradients
    are ``model`` times the single-device ones upstream of
    ``psum("model")``; the port's are the single-device ones."""
    params, target, batch = nets
    cfg_kw = dict(gamma=0.9)
    got = _by_coord(world.run("tp_grads", data, model, params, target, batch,
                              cfg_kw), data, model)
    for d in range(1, data):  # data replicas receive the same bits
        for m in range(model):
            jax.tree.map(np.testing.assert_array_equal, got[(d, m)],
                         got[(0, m)])
    port = _unshard([got[(0, m)] for m in range(model)])

    jcfg = JD.DQNConfig(gamma=0.9)
    jp, jt = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray,
                                                             target)
    single = _np(jax.grad(JD.td_loss)(jp, jt, _jax_batch(batch), jcfg))

    mesh = jax_make_mesh(data=data, model=model,
                         devices=devices8[:data * model])
    specs, sp = _jax_sharded(mesh, params)
    _, st = _jax_sharded(mesh, target)

    def grads(p, t, b):
        return jax.lax.pmean(jax.grad(JS._td_loss_tp)(p, t, b, jcfg), "data")

    fn = jax.shard_map(grads, mesh=mesh, in_specs=(specs, specs, P("data")),
                       out_specs=specs, check_vma=False)
    jax_tp = _np(jax.jit(fn)(sp, st, _jax_batch(batch)))

    for layer in ("fc0", "fc1", "fc2"):
        for k in ("w", "b"):
            g, s, j = port[layer][k], single[layer][k], jax_tp[layer][k]
            np.testing.assert_allclose(g, s, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{layer}.{k}")
            factor = model if (layer, k) in (("fc0", "w"), ("fc0", "b"),
                                             ("fc1", "w")) else 1
            np.testing.assert_allclose(j / factor, g, rtol=1e-5, atol=1e-6,
                                       err_msg=f"jax {layer}.{k}")
            big = np.abs(s) > 1e-3
            assert big.sum() > 0
            ratio = j[big] / s[big]
            np.testing.assert_allclose(np.median(ratio), factor, rtol=1e-4)


@pytest.mark.parametrize("data,model", MESHES)
def test_tp_actions_equal_k4_on_the_whole_net(world, nets, data, model):
    """The tensor-parallel actors pick what ``agents.dqn._choose_actions``
    (K4's plain version) picks on the unsharded net: the same Philox
    draws and Phi-select, for the ego and the self-play opponent."""
    obs = np.random.default_rng(6).standard_normal((64, 10)).astype(
        np.float32) * 10
    got = _by_coord(world.run("tp_actions", data, model, nets[0], obs,
                              dict(opponent="selfplay"), 11), data, model)
    for (d, m), (tp, whole) in got.items():
        np.testing.assert_array_equal(tp, whole, err_msg=f"rank {(d, m)}")
        np.testing.assert_array_equal(tp, got[(d, 0)][0])
        assert tp.shape == (64 // data, 2)
    picks = np.concatenate([got[(d, 0)][0] for d in range(data)])
    assert len(np.unique(picks[:, 0])) > 1 and len(np.unique(picks[:, 1])) > 1


@pytest.mark.parametrize("data,model", [(2, 1), (2, 2)])
def test_learn_over_data_equals_jax_learn_on_the_whole_batch(
        world, nets, data, model):
    """``agents.dqn.learn`` with the data group as ``axis``, each rank on
    its rows, equals JAX's ``learn`` on the concatenated batch: the
    averaged gradient shows in both Adam moments, and every data rank
    holds the same bits."""
    params, target, batch = nets
    kw = dict(gamma=0.9, lr=1e-3)
    got = _by_coord(world.run("learn_step", data, model, params, target,
                              batch, kw), data, model)
    for d in range(1, data):
        for m in range(model):
            jax.tree.map(np.testing.assert_array_equal, got[(d, m)],
                         got[(0, m)])

    def whole(key):
        parts = [got[(0, m)]["fields"] for m in range(model)]
        if key in ("mu", "nu"):
            parts = [p["opt_state"]["fields"] for p in parts]
        return _unshard([p[key] for p in parts])

    jcfg = JD.DQNConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    jst = JD.DQNState(params=jp,
                      target_params=jax.tree.map(jnp.asarray, target),
                      opt_state=JD.make_optimizer(jcfg).init(jp),
                      learn_counter=jnp.ones((), jnp.int32),
                      last_loss=jnp.zeros((), jnp.float32))
    want = JD.learn(jst, _jax_batch(batch), jcfg)
    adam = want.opt_state[0]
    fields = got[(0, 0)]["fields"]
    assert int(fields["learn_counter"]) == 2
    assert int(fields["opt_state"]["fields"]["count"]) == int(adam.count)
    np.testing.assert_allclose(fields["last_loss"], float(want.last_loss),
                               rtol=1e-5)
    for key, ref, rtol, atol in (("mu", adam.mu, 1e-5, 1e-7),
                                 ("nu", adam.nu, 2e-5, 1e-10),
                                 ("params", want.params, 0, 1e-6)):
        mine = whole(key)
        for layer in ("fc0", "fc1", "fc2"):
            for k in ("w", "b"):
                np.testing.assert_allclose(
                    mine[layer][k], np.asarray(ref[layer][k]), rtol=rtol,
                    atol=atol, err_msg=f"{key} {layer}.{k}")
    jax.tree.map(np.testing.assert_array_equal, whole("target_params"),
                 _np(want.target_params))


@pytest.mark.parametrize("data,model", [(4, 1), (2, 2)])
def test_spmd_train_runs_replicated(world, data, model):
    cfg_kw = dict(memory_capacity=64, batch_size=16,
                  opponent="selfplay" if model > 1 else "L0")
    res = [r for r in world.run("train_loop", data, model, cfg_kw,
                                data * 8, 0, [40]) if r is not None]
    assert len(res) == data * model
    for r in res:
        assert r["env_steps"] == [40 * data * 8]
        assert int(r["dqn"]["fields"]["learn_counter"]) > 0
        assert np.isfinite(r["dqn"]["fields"]["last_loss"])
        assert r["obs"].shape == (8, 10)
    by = {tuple(r["coord"]): r for r in res}
    for d in range(data):
        for m in range(model):
            # Params, moments and counters bitwise equal over data; the
            # metrics, summed every step, equal on every rank.
            jax.tree.map(np.testing.assert_array_equal,
                         by[(d, m)]["dqn"], by[(0, m)]["dqn"])
            jax.tree.map(np.testing.assert_array_equal,
                         by[(d, m)]["metrics"], by[(0, 0)]["metrics"])
            assert by[(d, m)]["seed"] == by[(d, 0)]["seed"]
            np.testing.assert_array_equal(by[(d, m)]["obs"],
                                          by[(d, 0)]["obs"])
    w = by[(0, 0)]["dqn"]["fields"]["params"]["fc0"]["w"]
    assert w.shape == (10, 200 // model) and np.isfinite(w).all()
    assert len({by[(d, 0)]["seed"] for d in range(data)}) == data


def test_spmd_metrics_accumulate_across_chunks(world):
    cfg_kw = dict(memory_capacity=32, batch_size=8, opponent="L0")
    res = world.run("train_loop", 4, 1, cfg_kw, 16, 7, [10, 10, 5])
    for r in res:
        assert r["env_steps"] == [10 * 16, 20 * 16, 25 * 16]
        assert int(r["metrics"]["fields"]["env_steps"]) == 25 * 16


def test_spmd_hdqn(world):
    cfg_kw = dict(memory_capacity=64, goal_memory_capacity=16, batch_size=8,
                  opponent="selfplay")
    res = world.run("hdqn_loop", cfg_kw, 16, 9, [30, 30])
    for r in res:
        assert r["env_steps"] == [30 * 16, 60 * 16]
        assert int(r["goal"].max()) < 3 and r["goal"].shape == (4,)
        assert np.isfinite(r["lower"]["fields"]["last_loss"])
        assert int(r["upper"]["fields"]["learn_counter"]) > 0
        for k in ("upper", "lower", "metrics"):
            jax.tree.map(np.testing.assert_array_equal, r[k], res[0][k])


def test_fused_local_sgd_on_four_ranks(world):
    """tests/test_spmd_fused.py:test_eight_device_local_sgd at four ranks:
    learners averaged into bitwise replicas, every lane counted, the
    rings split over the ranks."""
    n = 4 * 128
    kw = dict(lr=1e-3, target_sync=4, memory_capacity=2 * n, opponent="L0")
    res = world.run("fused_dqn_fresh", kw, dict(max_steps=30), n,
                    [(3, 8), (4, 8)])
    for r in res:
        assert r["env_steps"] == 2 * 8 * n and r["steps"] == 16
        assert r["learns"] == 16 - 1 and np.isfinite(r["last_loss"])
        assert r["ring"].shape == (2 * 24, 128) and r["n_global"] == n
        for k in ("p", "tp", "m", "v"):
            for x, y in zip(r[k], res[0][k]):
                np.testing.assert_array_equal(x, y)
    assert len({r["env"].tobytes() for r in res}) == 4
