"""The port's DRQN net, step-loop trainer and recurrent evaluation against
``merging_gym_tpu/nn/lstm.py``, ``agents/drqn.py`` and
``agents/evaluate.evaluate_drqn``.

Nets are held on the same numpy params at the JAX tests' tolerances
(``tests/test_drqn.py``, ``tests/test_fused_drqn.py``).  The step loop's
actor draws from other random streams than JAX's, so with ``epsilon = 40``
both packages' actors are greedy (a standard normal is ``<= 40``), and with
``batch_size`` above the number of windows written no learn fires: a whole
chunk from the same nets and race starts then takes the same actions, and is
held exactly on every discrete quantity (actions, done flags, window
lengths, cursors, counters) and on the floats at the port's f32 allowance
against XLA:CPU (obs at atol 1e-3, returns and h/c at 1e-4; ROADMAP
Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from merging_gym_tpu.agents import drqn as JDR
from merging_gym_tpu.agents import evaluate as JE
from merging_gym_tpu.core import env as jax_env
from merging_gym_tpu.core.env import EnvParams as JEnvParams
from merging_gym_tpu.nn import lstm as JL
from merging_gym_tpu_torch.agents import drqn as DR
from merging_gym_tpu_torch.agents import dqn as D
from merging_gym_tpu_torch.agents.evaluate import evaluate_drqn
from merging_gym_tpu_torch.core import env as core_env
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.nn import lstm as L
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _shrink(tree, scale):
    """Centred and scaled weights (tests/test_fused_drqn.py:63-67): the
    U(0, 1) fc1/fc2 init saturates the LSTM."""
    return jax.tree.map(lambda w: (w - jnp.mean(w)) * scale, tree)


@pytest.fixture(scope="module")
def nets():
    """Two JAX DRQN nets, centred and shrunk so each argmax is decisive."""
    return tuple(_np(_shrink(JL.drqn_init(jax.random.key(k), 10, 5), 0.05))
                 for k in (21, 22))


def test_lstm_cell_matches_jax_and_torch_lstm_cell():
    """tests/test_drqn.py:15-32; torch.nn.LSTMCell is a test oracle only."""
    p = _np(JL.lstm_cell_init(jax.random.key(0), 16, 16))
    x = np.random.default_rng(0).standard_normal((3, 16)).astype(np.float32)
    h0 = np.random.default_rng(1).standard_normal((3, 16)).astype(np.float32)
    c0 = np.random.default_rng(2).standard_normal((3, 16)).astype(np.float32)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    out, (h, c) = L.lstm_cell_apply(tp, torch.tensor(x),
                                    (torch.tensor(h0), torch.tensor(c0)))
    _, (hj, cj) = JL.lstm_cell_apply(p, jnp.asarray(x),
                                     (jnp.asarray(h0), jnp.asarray(c0)))
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), atol=1e-5)
    assert torch.equal(out, h)
    cell = torch.nn.LSTMCell(16, 16)
    with torch.no_grad():
        cell.weight_ih.copy_(torch.tensor(p["w_ih"].T))
        cell.weight_hh.copy_(torch.tensor(p["w_hh"].T))
        cell.bias_ih.copy_(torch.tensor(p["b_ih"]))
        cell.bias_hh.copy_(torch.tensor(p["b_hh"]))
        ht, ct = cell(torch.tensor(x), (torch.tensor(h0), torch.tensor(c0)))
    np.testing.assert_allclose(h.numpy(), ht.numpy(), atol=1e-5)
    np.testing.assert_allclose(c.numpy(), ct.numpy(), atol=1e-5)


def test_init_shapes_and_ranges():
    p = L.drqn_init(torch.Generator().manual_seed(0), 10, 5, device=CPU)
    j = JL.drqn_init(jax.random.key(0), 10, 5)
    for layer in j:
        for k in j[layer]:
            assert tuple(p[layer][k].shape) == j[layer][k].shape, (layer, k)
    assert sum(v.numel() for layer in p.values() for v in layer.values()) \
        == 7949
    for layer in ("fc1", "fc2"):  # U(0, 1) weights (main.py:34-39)
        w = p[layer]["w"]
        assert w.min() >= 0.0 and w.max() <= 1.0 and w.mean() > 0.4
    k = 0.25  # 1 / sqrt(16): torch's LSTM and fc3/fc4 bounds
    for v in (*p["lstm"].values(), p["fc3"]["w"], p["fc4"]["w"]):
        assert v.abs().max() <= k and v.min() < 0.0 < v.max()


def test_unroll_matches_steps_and_jax(nets):
    """tests/test_drqn.py:35-45 on the same numpy params."""
    params = L.drqn_params_from_numpy(nets[0], CPU)
    obs = np.random.default_rng(2).standard_normal((7, 3, 10)).astype(
        np.float32) * 20
    qs, (h, c) = L.drqn_unroll(params, torch.tensor(obs),
                               L.lstm_zero_carry((3,), device=CPU))
    assert qs.shape == (7, 3, 5)
    carry = L.lstm_zero_carry((3,), device=CPU)
    for t in range(7):
        q, carry = L.drqn_step(params, torch.tensor(obs[t]), carry)
        assert torch.equal(q, qs[t])
    qj, (hj, cj) = JL.drqn_unroll(nets[0], jnp.asarray(obs),
                                  JL.lstm_zero_carry((3,)))
    np.testing.assert_allclose(qs.numpy(), np.asarray(qj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), atol=1e-5)
    qp, _ = L.drqn_unroll(params, torch.tensor(obs[::-1].copy()),
                          L.lstm_zero_carry((3,), device=CPU))
    assert not torch.allclose(qp[-1], qs[-1])  # the recurrence matters


def _rand_batch(rng, B, seq_len, scale=5.0):
    """tests/test_fused_drqn.py:_rand_batch: some windows end mid-window."""
    done = np.zeros((B, seq_len), bool)
    ends = rng.integers(0, 2 * seq_len, B)
    for b in range(B):
        if ends[b] < seq_len:
            done[b, ends[b]] = True
    return {
        "obs": rng.standard_normal((B, seq_len + 1, 10)).astype(np.float32)
        * scale,
        "action": rng.integers(0, 5, (B, seq_len)).astype(np.int32),
        "reward": rng.standard_normal((B, seq_len)).astype(np.float32),
        "done": done,
    }


def _torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("burn_in", [0, 4])
def test_loss_and_adam_match_jax_grad_and_optax(burn_in):
    """``drqn_loss`` + the Adam of agents.dqn for three steps against
    ``jax.grad(drqn_loss)`` + ``optax.adam``, with the outlier rule of
    tests/test_fused_drqn.py:94-99."""
    seq_len = 8
    kw = dict(lr=0.01, gamma=0.9, seq_len=seq_len, burn_in=burn_in)
    jcfg, cfg = JDR.DRQNConfig(**kw), DR.DRQNConfig(**kw)
    rng = np.random.default_rng(0)
    jp = _shrink(JL.drqn_init(jax.random.key(1), 10, 5), 0.4)
    jt = _shrink(JL.drqn_init(jax.random.key(2), 10, 5), 0.4)
    opt = optax.adam(cfg.lr)
    jopt = opt.init(jp)
    p = L.drqn_params_from_numpy(_np(jp), CPU)
    t = L.drqn_params_from_numpy(_np(jt), CPU)
    state = D.AdamState(torch.zeros((), dtype=torch.int32),
                        D._tree_map(torch.zeros_like, p),
                        D._tree_map(torch.zeros_like, p))
    for step in range(3):
        batch = _rand_batch(rng, 128, seq_len)
        loss_ref, grads = jax.value_and_grad(JDR.drqn_loss)(
            jp, jt, jax.tree.map(jnp.asarray, batch), jcfg)
        updates, jopt = opt.update(grads, jopt, jp)
        jp = optax.apply_updates(jp, updates)

        with torch.enable_grad():
            pg = D._tree_map(lambda x: x.detach().requires_grad_(True), p)
            loss = DR.drqn_loss(pg, t, _torch_batch(batch), cfg)
            flat = torch.autograd.grad(loss, D._leaves(pg))
        it = iter(flat)
        p, state = D._adam(p, D._tree_map(lambda _: next(it), p), state,
                           cfg.lr)
        np.testing.assert_allclose(float(loss.detach()), float(loss_ref),
                                   rtol=1e-4,
                                   err_msg=f"loss step {step}")
        for layer in p:
            for k in p[layer]:
                a = p[layer][k].numpy().astype(np.float64)
                b = np.asarray(jp[layer][k], np.float64)
                err = np.abs(a - b)
                loose = err > (5e-5 + 2e-4 * np.abs(b))
                assert loose.mean() <= 2e-3, (layer, k, step, loose.sum())
                assert err.max() < 0.05 * cfg.lr, (layer, k, step)


def test_loss_masks_post_done_steps(nets):
    """tests/test_drqn.py:51-69."""
    cfg = DR.DRQNConfig(seq_len=8, burn_in=2, batch_size=4)
    params = L.drqn_params_from_numpy(nets[0], CPU)
    target = L.drqn_params_from_numpy(nets[1], CPU)
    rng = np.random.default_rng(0)
    batch = {
        "obs": torch.tensor(rng.normal(size=(4, 9, 10)), dtype=torch.float32),
        "action": torch.tensor(rng.integers(0, 5, (4, 8)), dtype=torch.int32),
        "reward": torch.tensor(rng.normal(size=(4, 8)), dtype=torch.float32),
        "done": torch.zeros(4, 8, dtype=torch.bool),
    }
    batch["done"][0, 3] = True
    base = DR.drqn_loss(params, target, batch, cfg)
    poisoned = dict(batch, reward=batch["reward"].clone())
    poisoned["reward"][0, 5] = 1e6
    assert float(DR.drqn_loss(params, target, poisoned, cfg)) == pytest.approx(
        float(base), rel=1e-6)
    poisoned["reward"] = batch["reward"].clone()
    poisoned["reward"][0, 2] = 1e3
    assert abs(float(DR.drqn_loss(params, target, poisoned, cfg))
               - float(base)) > 1.0


def test_config_defaults_and_init_checks():
    assert set(DR.DRQNConfig.__dataclass_fields__) == set(
        JDR.DRQNConfig.__dataclass_fields__)
    for name, field in DR.DRQNConfig.__dataclass_fields__.items():
        assert getattr(JDR.DRQNConfig(), name) == field.default, name
    # pmean_axis is accepted; a step refuses it without the mesh's groups
    # (parallel.spmd.spmd_drqn_chunk passes them).
    ep = EnvParams()
    cfg = DR.DRQNConfig(pmean_axis="data", memory_capacity=16, batch_size=4)
    carry = DR.drqn_train_init(0, cfg, ep, 4, device=CPU)
    with pytest.raises(ValueError, match="pmean_axis"):
        DR.drqn_train_step(cfg, ep, carry)
    with pytest.raises(ValueError, match="frozen opponent needs params"):
        DR.drqn_train_init(0, DR.DRQNConfig(opponent="frozen"), ep, 8,
                           device=CPU)
    with pytest.raises(ValueError, match="at least one synchronized flush"):
        DR.drqn_train_init(0, DR.DRQNConfig(memory_capacity=8), ep, 16,
                           device=CPU)


def _race(rng, n):
    pos = rng.uniform(870.0, 948.0, (n, 2)).astype(np.float32)
    vel = rng.uniform(5.0, 40.0, (n, 2)).astype(np.float32)
    return pos, vel


def test_greedy_learn_free_chunk_equals_jax(nets):
    n, T, seq_len = 64, 30, 4
    kw = dict(epsilon=40.0, memory_capacity=1024, batch_size=512,
              seq_len=seq_len, burn_in=1, opponent="selfplay")
    jcfg, cfg = JDR.DRQNConfig(**kw), DR.DRQNConfig(**kw)
    jep, ep = JEnvParams(max_steps=25), EnvParams(max_steps=25)
    pos, vel = _race(np.random.default_rng(11), n)

    jc = JDR.drqn_train_init(jax.random.key(4), jcfg, jep, n)
    es = jc.env_state.replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel))
    obs = jax.vmap(jax_env.observe)(es)
    win = dict(jc.window)
    win["obs"] = win["obs"].at[:, 0].set(obs)
    jc = jc.replace(env_state=es, obs=obs, window=win,
                    params=jax.tree.map(jnp.asarray, nets[0]),
                    target_params=jax.tree.map(jnp.asarray, nets[1]))

    c = DR.drqn_train_init(0, cfg, ep, n, device=CPU)
    c.env_state.pos, c.env_state.vel = torch.tensor(pos), torch.tensor(vel)
    c.obs = core_env.observe(c.env_state)
    c.window["obs"][:, 0] = c.obs
    c.params = L.drqn_params_from_numpy(nets[0], CPU)
    c.target_params = L.drqn_params_from_numpy(nets[1], CPU)

    jc = JDR.drqn_train_chunk(jcfg, jep, jc, T)
    c = DR.drqn_train_chunk(cfg, ep, c, T)

    assert int(jc.learn_counter) == int(c.learn_counter) == 0
    assert int(c.replay.cursor) == int(jc.replay.cursor) == n * (T // seq_len)
    np.testing.assert_array_equal(c.window_len.numpy(),
                                  np.asarray(jc.window_len))
    for k in ("action", "done"):
        np.testing.assert_array_equal(c.replay.data[k].numpy(),
                                      np.asarray(jc.replay.data[k]), k)
        np.testing.assert_array_equal(c.window[k].numpy(),
                                      np.asarray(jc.window[k]), k)
    np.testing.assert_allclose(c.replay.data["obs"].numpy(),
                               np.asarray(jc.replay.data["obs"]), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(c.window["obs"].numpy(),
                               np.asarray(jc.window["obs"]), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(c.replay.data["reward"].numpy(),
                               np.asarray(jc.replay.data["reward"]), rtol=0,
                               atol=1e-4)
    for k in ("lstm_h", "lstm_c", "lstm_h2", "lstm_c2"):
        np.testing.assert_allclose(getattr(c, k).numpy(),
                                   np.asarray(getattr(jc, k)), rtol=0,
                                   atol=1e-4, err_msg=k)
    assert bool((c.lstm_h2 != 0).any())  # the opponent seat is live
    np.testing.assert_allclose(c.ep_reward.numpy(), np.asarray(jc.ep_reward),
                               atol=1e-4)
    m, jm = c.metrics, jc.metrics
    for k in ("env_steps", "episodes", "collisions", "wins"):
        assert int(getattr(m, k)) == int(getattr(jm, k)), k
    assert int(m.episodes) > 0 and int(m.wins) > 0
    np.testing.assert_allclose(float(m.sum_ep_reward),
                               float(jm.sum_ep_reward), rtol=1e-5, atol=1e-3)


def test_learning_chunk_and_l0_seat_two_stays_zero():
    """tests/test_drqn.py:72-82,118-124 for the port: learns fire once a
    batch of windows is stored, the loss is finite, and under L0 the
    opponent seat's state stays zero."""
    cfg = DR.DRQNConfig(memory_capacity=32, batch_size=8, seq_len=8,
                        burn_in=2)
    c = DR.drqn_train_init(10, cfg, EnvParams(), 8, device=CPU)
    c = DR.drqn_train_chunk(cfg, EnvParams(), c, 30)
    assert int(c.metrics.env_steps) == 30 * 8
    assert int(c.replay.cursor) == 8 * 3
    assert int(c.learn_counter) == 30 - 7  # 8 windows stored after step 8
    assert torch.isfinite(c.last_loss) and float(c.last_loss) > 0.0
    assert not bool((c.lstm_h2 != 0).any() or (c.lstm_c2 != 0).any())


def _clock_net(rate):
    """A DRQN that ignores its obs: its cell integrates ``rate`` per step
    (input, forget and output gates open), and it accelerates (action 4)
    while h < 0.5, then brakes (action 0).  Its play depends on the LSTM
    state being zeroed at each episode start."""
    z = np.zeros
    b_ih = np.full(64, 10.0, np.float32)
    b_ih[32:48] = rate
    w4 = z((16, 5), np.float32)
    w4[0, 4] = -2.0
    return {"fc1": {"w": z((10, 200), np.float32), "b": z(200, np.float32)},
            "fc2": {"w": z((200, 16), np.float32), "b": z(16, np.float32)},
            "lstm": {"w_ih": z((16, 64), np.float32),
                     "w_hh": z((16, 64), np.float32), "b_ih": b_ih,
                     "b_hh": z(64, np.float32)},
            "fc3": {"w": np.eye(16, dtype=np.float32),
                    "b": z(16, np.float32)},
            "fc4": {"w": w4, "b": np.array([0, 0, 0, 0, 1], np.float32)}}


@pytest.mark.parametrize("seat2,clock", [
    ("l0", False), ("drqn", False), ("l0", True), ("drqn", True)],
    ids=["l0", "drqn", "l0_clock", "drqn_clock"])
def test_greedy_evaluate_drqn_equals_jax(nets, seat2, clock):
    """Greedy ``evaluate_drqn`` in both packages from the same nets: the
    shrunk ones, or clock nets whose outcomes change if h/c survive a
    reset (400-step episodes)."""
    p1, p2 = ((_clock_net(0.003), _clock_net(0.006)) if clock else nets)
    p2 = p2 if seat2 == "drqn" else None
    kw = dict(num_envs=4, min_episodes=1, chunk_steps=700, max_chunks=1,
              greedy=True)
    extra = {"max_steps": 400} if clock else {}
    jres = JE.evaluate_drqn(
        jax.tree.map(jnp.asarray, p1),
        drqn_params2=None if p2 is None else jax.tree.map(jnp.asarray, p2),
        env_params=JEnvParams(**extra), key=jax.random.key(0), **kw)
    res = evaluate_drqn(
        L.drqn_params_from_numpy(p1, CPU),
        drqn_params2=None if p2 is None else L.drqn_params_from_numpy(p2,
                                                                      CPU),
        env_params=EnvParams(**extra),
        # The default is a generator seeded with 0 on the params' device.
        generator=None if p2 is not None and not clock
        else torch.Generator().manual_seed(0), **kw)
    assert res["episodes"] > 4
    for k in ("episodes", "p1_first", "p2_first", "collisions", "timeouts"):
        assert res[k] == jres[k], k
    for k in ("mean_return_p1", "mean_return_p2"):
        assert res[k] == pytest.approx(jres[k], rel=1e-4, abs=1e-4), k
