"""The port's Rainbow modules against the JAX package: ``nn.noisy``,
``nn.rainbow_net``, ``ops.projection``, ``ops.nstep``, ``ops.per``,
``ops.segment_tree``, ``agents.rainbow`` and ``rainbow_policy``.

Same numpy inputs through both packages, at the JAX tests' tolerances:
the net forward at ``tests/test_fused_rainbow.py:76-85``'s (dists rtol
1e-5, atol 1e-7; E[Z] rtol 1e-4, atol 5e-6), the learner at
``:129-147``'s (loss rtol 1e-5; params rtol 1e-3, atol 2e-5 / 3e-5).  The
step loop is held on a chunk in which neither package learns (the batch
is above n * T, so both learn gates stay shut and the noise is never
resampled): with the same nets, noise and race starts both take the same
actions, so actions, done flags, cursors and counters are exact, floats
at the port's f32 allowance against XLA:CPU (obs 1e-3, rewards 1e-4;
ROADMAP Queue 3).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merging_gym_tpu.agents import policies as JP
from merging_gym_tpu.agents import rainbow as JR
from merging_gym_tpu.core import env as jax_env
from merging_gym_tpu.core.env import EnvParams as JEnvParams
from merging_gym_tpu.nn import noisy as JN
from merging_gym_tpu.nn import rainbow_net as JRN
from merging_gym_tpu.ops import nstep as JNS
from merging_gym_tpu.ops import per as JPER
from merging_gym_tpu.ops import segment_tree as JST
from merging_gym_tpu.ops.projection import categorical_projection as jproj
from merging_gym_tpu_torch.agents import dqn as D
from merging_gym_tpu_torch.agents import policies as P
from merging_gym_tpu_torch.agents import rainbow as R
from merging_gym_tpu_torch.core import env as core_env
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.io.checkpoint import load_params_npz
from merging_gym_tpu_torch.nn import noisy as N
from merging_gym_tpu_torch.nn import rainbow_net as RN
from merging_gym_tpu_torch.ops import nstep as NS
from merging_gym_tpu_torch.ops import per as PER
from merging_gym_tpu_torch.ops import segment_tree as ST
from merging_gym_tpu_torch.ops.projection import categorical_projection
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
ZOO_RB = os.path.join(os.path.dirname(__file__), "..", "model_zoo",
                      "RB_L0_FUSED", "params.npz")


@pytest.fixture(scope="module")
def jax_net():
    """JAX params, noise and target noise (numpy) of the reference net."""
    kp, kn, kt = jax.random.split(jax.random.key(0), 3)
    tree = jax.tree.map(np.asarray, (JRN.rainbow_init(kp, 10, 5),
                                     JRN.rainbow_sample_noise(kn, 5),
                                     JRN.rainbow_sample_noise(kt, 5)))
    return tree


def _t(tree):
    return RN.rainbow_params_from_numpy(tree, CPU)


def test_noisy_apply_matches_jax_with_and_without_noise():
    rng = np.random.default_rng(0)
    p = {"w_mu": rng.uniform(-0.1, 0.1, (64, 51)).astype(np.float32),
         "w_sigma": np.full((64, 51), 0.05, np.float32),
         "b_mu": rng.uniform(-0.1, 0.1, 51).astype(np.float32),
         "b_sigma": np.full(51, 0.056, np.float32)}
    noise = {"w_eps": rng.standard_normal((64, 51)).astype(np.float32),
             "b_eps": rng.standard_normal(51).astype(np.float32)}
    x = rng.standard_normal((32, 64)).astype(np.float32)
    for nz in (noise, None):
        want = np.asarray(JN.noisy_apply(p, jnp.asarray(x), nz))
        got = N.noisy_apply({k: torch.as_tensor(v) for k, v in p.items()},
                            torch.as_tensor(x),
                            None if nz is None else
                            {k: torch.as_tensor(v) for k, v in nz.items()})
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_noisy_init_fills_and_rank_one_noise():
    g = torch.Generator().manual_seed(0)
    p = N.noisy_init(g, 64, 51)
    r = 1.0 / np.sqrt(64)
    assert float(p["w_mu"].abs().max()) <= r
    np.testing.assert_array_equal(p["w_sigma"].numpy(),
                                  np.full((64, 51), 0.4 / np.sqrt(64),
                                          np.float32))
    np.testing.assert_array_equal(p["b_sigma"].numpy(),
                                  np.full(51, 0.4 / np.sqrt(51), np.float32))
    eps = N.noisy_sample_noise(g, 64, 51)["w_eps"].double().numpy()
    sv = np.linalg.svd(eps, compute_uv=False)
    assert sv[1] <= 1e-6 * sv[0]
    params = RN.rainbow_init(g, 10, 5)
    assert sum(v.numel() for layer in params.values()
               for v in layer.values()) == 58884


@pytest.mark.parametrize("noisy", [True, False])
def test_rainbow_apply_and_q_values_match_jax(jax_net, noisy):
    params, noise, _ = jax_net
    x = (np.random.default_rng(9).standard_normal((64, 10)) * 3.0
         ).astype(np.float32)
    nz = noise if noisy else None
    want = np.asarray(JRN.rainbow_apply(params, jnp.asarray(x), nz))
    got = RN.rainbow_apply(_t(params), torch.as_tensor(x),
                           None if nz is None else _t(nz))
    assert got.shape == (64, 5, 51)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        RN.rainbow_q_values(got).numpy(),
        np.asarray(JRN.rainbow_q_values(jnp.asarray(want))),
        rtol=1e-4, atol=5e-6)


@pytest.mark.parametrize("weight", [True, False])
def test_projection_matches_jax(weight):
    """tests/test_rainbow.py:45-57's inputs and tolerance, both modes, in
    f64 as there."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(16, 51))
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    rewards = rng.normal(size=16) * 3
    dones = (rng.random(16) < 0.3).astype(np.float64)
    want = np.asarray(jproj(jnp.asarray(probs), jnp.asarray(rewards),
                            jnp.asarray(dones), JRN.support(jnp.float64),
                            0.99, weight))
    got = categorical_projection(torch.as_tensor(probs),
                                 torch.as_tensor(rewards),
                                 torch.as_tensor(dones),
                                 RN.support(torch.float64), 0.99, weight)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-8)


def test_projection_atom_edge():
    """tests/test_rainbow.py:60-78: done=1 puts Tz = 0 on atom 25; the
    faithful mode loses the mass, the textbook mode keeps it there."""
    probs = torch.full((1, 51), 1 / 51.0, dtype=torch.float64)
    sup = RN.support(torch.float64)
    faithful = categorical_projection(probs, torch.zeros(1, dtype=torch.float64),
                                      torch.ones(1), sup, 0.99, True)
    assert abs(float(faithful.sum())) < 1e-9
    textbook = categorical_projection(probs, torch.zeros(1, dtype=torch.float64),
                                      torch.ones(1), sup, 0.99, False)[0]
    assert abs(float(textbook[25]) - 1.0) < 1e-9
    assert abs(float(textbook.sum()) - 1.0) < 1e-9


NSTEP_CASES = {  # tests/test_nstep.py's streams (n, rewards, dones)
    "full": (3, [1.0, 2.0, 3.0, 4.0, 5.0, 6.0], [False] * 6),
    "done_flush": (3, [1.0, 2.0, 3.0, 4.0], [False, False, False, True]),
    "new_episode": (3, [10.0, 20.0, 1.0, 2.0, 3.0, 4.0],
                    [False, True, False, False, False, False]),
    "random": (4, list(np.random.default_rng(0).normal(size=40)),
               list(np.random.default_rng(0).random(40) < 0.15)),
    "n1": (1, [1.0, 2.0, 3.0], [False, False, True]),
}


@pytest.mark.parametrize("case", sorted(NSTEP_CASES))
def test_nstep_update_equals_jax(case):
    n, rewards, dones = NSTEP_CASES[case]
    envs, gamma = 3, 0.9
    jst, st = JNS.nstep_init(n, envs, 2), NS.nstep_init(n, envs, 2)
    for t, (r, d) in enumerate(zip(rewards, dones)):
        obs = np.full((envs, 2), float(t), np.float32)
        obs[1] += 100.0
        nxt = obs + 1.0
        act = np.full(envs, t % 5, np.int32)
        rew = np.asarray([r, -r, 0.5 * r], np.float32)
        done = np.asarray([d, not d, d])
        jst, jit, jm = JNS.nstep_update(jst, jnp.asarray(obs), jnp.asarray(act),
                                        jnp.asarray(rew), jnp.asarray(done),
                                        jnp.asarray(nxt), gamma)
        st, it, m = NS.nstep_update(st, torch.as_tensor(obs),
                                    torch.as_tensor(act), torch.as_tensor(rew),
                                    torch.as_tensor(done),
                                    torch.as_tensor(nxt), gamma)
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        for k in it:
            np.testing.assert_array_equal(it[k].numpy(), np.asarray(jit[k]),
                                          err_msg=f"{case} t={t} {k}")
        for k in ("obs", "action", "ret", "length"):
            np.testing.assert_array_equal(getattr(st, k).numpy(),
                                          np.asarray(getattr(jst, k)))


def test_per_writes_priorities_and_weights_equal_jax():
    cap, alpha, beta = 16, 0.6, 0.4
    ex = {"v": np.zeros((), np.float32)}
    jst = JPER.per_init(cap, {"v": jnp.zeros((), jnp.float32)}, alpha)
    st = PER.per_init(cap, {"v": torch.zeros(())}, alpha)
    del ex
    rng = np.random.default_rng(1)
    for step in range(3):  # wraps the ring on the third add
        items = np.arange(7, dtype=np.float32) + 10 * step
        mask = rng.random(7) < 0.8
        jst = JPER.per_add_batch(jst, {"v": jnp.asarray(items)},
                                 jnp.asarray(mask))
        st = PER.per_add_batch(st, {"v": torch.as_tensor(items)},
                               torch.as_tensor(mask))
        idx = rng.permutation(min(int(st.base.cursor), cap))[:4]
        pr = rng.uniform(0.1, 3.0, 4).astype(np.float32)
        jst = JPER.per_update_priorities(jst, jnp.asarray(idx),
                                         jnp.asarray(pr))
        st = PER.per_update_priorities(st, torch.as_tensor(idx),
                                       torch.as_tensor(pr))
        # The written slots exactly; a value x ** alpha to 2 ulps (torch's
        # and XLA's pow round differently).
        np.testing.assert_array_equal(st.priorities.numpy() > 0,
                                      np.asarray(jst.priorities) > 0)
        np.testing.assert_allclose(st.priorities.numpy(),
                                   np.asarray(jst.priorities), rtol=2.5e-7,
                                   atol=0)
        assert float(st.max_priority) == float(jst.max_priority)
        assert int(st.base.cursor) == int(jst.base.cursor)
        np.testing.assert_array_equal(st.base.data["v"].numpy(),
                                      np.asarray(jst.base.data["v"]))
    # The weights of per_sample's own draws, recomputed by JAX's formula
    # (per.py:83-88) at the same indices.
    _, idx, w = PER.per_sample(st, torch.Generator().manual_seed(0), 64, beta)
    p = np.asarray(jst.priorities)
    filled = min(int(jst.base.cursor), cap)
    valid = np.arange(cap) < filled
    pv = jnp.where(jnp.asarray(valid), jnp.asarray(p), 0.0)
    total = jnp.sum(pv)
    probs = pv[jnp.asarray(idx.numpy())] / total
    want = (probs * filled) ** (-beta) / (
        (jnp.min(jnp.where(jnp.asarray(valid), pv, jnp.inf)) / total
         * filled) ** (-beta))
    np.testing.assert_allclose(w.numpy(), np.asarray(want), rtol=1e-6)
    assert float(w.max()) <= 1.0 + 1e-6


def test_per_draws_are_proportional():
    """tests/test_rainbow.py:107-128 on the port: frequencies ~ priority."""
    st = PER.per_init(8, {"v": torch.zeros(())}, alpha=1.0)
    st = PER.per_add_batch(st, {"v": torch.arange(8, dtype=torch.float32)})
    st = PER.per_update_priorities(st, torch.arange(8),
                                   torch.arange(1.0, 9.0))
    g = torch.Generator().manual_seed(0)
    counts = np.zeros(8)
    for _ in range(64):
        batch, idx, _ = PER.per_sample(st, g, 128, beta=1.0)
        np.testing.assert_array_equal(batch["v"].numpy(), idx.numpy())
        counts += np.bincount(idx.numpy(), minlength=8)
    np.testing.assert_allclose(counts / counts.sum(),
                               np.arange(1.0, 9.0) / 36.0, atol=0.01)


def test_rainbow_loss_and_three_adam_steps_match_jax(jax_net):
    import optax

    params, noise, tnoise = jax_net
    tparams = jax.tree.map(np.asarray,
                           JRN.rainbow_init(jax.random.key(7), 10, 5))
    kw = dict(lr=1e-3, gamma=0.9, obs_scale=0.01, n_step=2)
    jcfg, cfg = JR.RainbowConfig(**kw), R.RainbowConfig(**kw)
    rng = np.random.default_rng(5)
    n = 128
    batch = {"obs": rng.normal(0, 30, (n, 10)).astype(np.float32),
             "next_obs": rng.normal(0, 30, (n, 10)).astype(np.float32),
             "action": rng.integers(0, 5, n).astype(np.int32),
             "reward": rng.normal(0, 2, n).astype(np.float32),
             "done": rng.random(n) < 0.3}
    w = rng.uniform(0.2, 1.0, n).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}

    opt = optax.adam(cfg.lr)
    jp, jopt = params, opt.init(params)
    carry = R.rainbow_train_init(0, cfg, EnvParams(), 8, device=CPU)
    p, ost = _t(params), carry.opt_state
    def jstep(jp, jopt):  # eager, as tests/test_fused_rainbow.py:110
        (jloss, jce), grads = jax.value_and_grad(JR.rainbow_loss,
                                                 has_aux=True)(
            jp, tparams, noise, tnoise, jb, jnp.asarray(w), jcfg)
        upd, jopt = opt.update(grads, jopt, jp)
        return optax.apply_updates(jp, upd), jopt, jloss, jce

    for step in range(3):
        jp, jopt, jloss, jce = jstep(jp, jopt)
        with torch.enable_grad():
            leaves = D._tree_map(lambda a: a.detach().requires_grad_(True), p)
            loss, ce = R.rainbow_loss(leaves, _t(tparams), _t(noise),
                                      _t(tnoise), tb, torch.as_tensor(w), cfg)
            g = torch.autograd.grad(loss, D._leaves(leaves))
        it = iter(g)
        p, ost = D._adam(p, D._tree_map(lambda _: next(it), leaves), ost,
                         cfg.lr)
        np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5,
                                   atol=1e-7)
        # Per item (the JAX test holds only the mean): f32 sums over 51
        # atoms in another order.
        np.testing.assert_allclose(ce.detach().numpy(), np.asarray(jce),
                                   rtol=1e-4, atol=1e-5)
        for layer in params:
            for k in params[layer]:
                np.testing.assert_allclose(
                    p[layer][k].numpy(), np.asarray(jp[layer][k]),
                    rtol=1e-3, atol=3e-5, err_msg=f"step {step} {layer}.{k}")


def _race(rng, n):
    pos = rng.uniform(870.0, 948.0, (n, 2)).astype(np.float32)
    vel = rng.uniform(5.0, 40.0, (n, 2)).astype(np.float32)
    return pos, vel


@pytest.mark.parametrize("case", ["selfplay_roll3", "l0_per_3step"])
def test_learn_free_chunk_equals_jax(case):
    n, T = 64, 24
    kw = dict(obs_scale=0.01, memory_capacity=4 * n * T, batch_size=2 * n * T,
              target_sync_episodes=3)
    if case == "selfplay_roll3":
        kw.update(opponent=D.OPP_SELFPLAY, opponent_roll=3)
    else:
        kw.update(opponent=D.OPP_L0, per=True, n_step=3)
    jcfg, cfg = JR.RainbowConfig(**kw), R.RainbowConfig(**kw)
    jep, ep = JEnvParams(max_steps=25), EnvParams(max_steps=25)
    pos, vel = _race(np.random.default_rng(11), n)

    jc = JR.rainbow_train_init(jax.random.key(4), jcfg, jep, n)
    es = jc.env_state.replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel))
    jc = jc.replace(env_state=es, obs=jax.vmap(jax_env.observe)(es))

    c = R.rainbow_train_init(0, cfg, ep, n, device=CPU)
    c.env_state.pos, c.env_state.vel = (torch.as_tensor(pos),
                                        torch.as_tensor(vel))
    c.obs = core_env.observe(c.env_state)
    c.params = _t(jax.tree.map(np.asarray, jc.params))
    c.target_params = c.params
    c.noise = _t(jax.tree.map(np.asarray, jc.noise))
    c.target_noise = _t(jax.tree.map(np.asarray, jc.target_noise))

    jc = JR.rainbow_train_chunk(jcfg, jep, jc, T)
    c = R.rainbow_train_chunk(cfg, ep, c, T)

    assert int(c.opt_state.count) == int(jc.opt_state[0].count) == 0
    jrep, rep = ((jc.replay.base, c.replay.base) if cfg.per
                 else (jc.replay, c.replay))
    assert int(rep.cursor) == int(jrep.cursor) > 0
    for k in ("action", "done"):
        np.testing.assert_array_equal(rep.data[k].numpy(),
                                      np.asarray(jrep.data[k]), err_msg=k)
    for k in ("obs", "next_obs"):
        np.testing.assert_allclose(rep.data[k].numpy(),
                                   np.asarray(jrep.data[k]), rtol=0,
                                   atol=1e-3, err_msg=k)
    np.testing.assert_allclose(rep.data["reward"].numpy(),
                               np.asarray(jrep.data["reward"]), rtol=0,
                               atol=1e-4)
    if cfg.per:  # every stored item at max_priority ** alpha = 1
        np.testing.assert_array_equal(c.replay.priorities.numpy(),
                                      np.asarray(jc.replay.priorities))
    np.testing.assert_allclose(c.env_state.pos.numpy(),
                               np.asarray(jc.env_state.pos), rtol=2.5e-7,
                               atol=1e-4)
    m, jm = c.metrics, jc.metrics
    for k in ("env_steps", "episodes", "collisions", "wins"):
        assert int(getattr(m, k)) == int(getattr(jm, k)), k
    assert int(m.episodes) > 0
    assert int(c.sync_chunks) == int(jc.sync_chunks) > 0
    np.testing.assert_allclose(float(m.sum_ep_reward),
                               float(jm.sum_ep_reward), rtol=1e-5, atol=1e-3)
    for layer in c.params:  # the sync copied the unchanged net
        for k in c.params[layer]:
            np.testing.assert_array_equal(
                c.target_params[layer][k].numpy(),
                np.asarray(jc.target_params[layer][k]))


def test_rainbow_policy_greedy_actions_equal_jax():
    """The zoo's fused-trained Rainbow net (obs scale 0.01, its meta.json)
    acts greedily as JAX's ``rainbow_policy`` does."""
    params = load_params_npz(ZOO_RB)
    rng = np.random.default_rng(3)
    obs = (rng.standard_normal((512, 10)) * 200.0).astype(np.float32)
    obs[:, 9] = np.abs(obs[:, 9])
    jpol = JP.rainbow_policy(jax.tree.map(jnp.asarray, params), greedy=True,
                             obs_scale=0.01)
    want = np.asarray(jpol.act(jpol.params, jnp.asarray(obs),
                               jax.random.key(0)))
    pol = P.rainbow_policy(RN.rainbow_params_from_numpy(params, CPU),
                           greedy=True, obs_scale=0.01)
    got = pol.act(pol.params, torch.as_tensor(obs), None)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want.tolist())) > 1
    # Not greedy: the Phi(0.7) pick keeps the greedy action on ~76%.
    pol = P.rainbow_policy(pol.params, greedy=False, obs_scale=0.01)
    kept = (pol.act(pol.params, torch.as_tensor(obs),
                    torch.Generator().manual_seed(1)) == got).float().mean()
    assert 0.7 < float(kept) < 0.9


def test_segment_trees_match_jax():
    """tests/test_segment_tree.py's cases on both packages."""
    rng = np.random.default_rng(0)
    cap = 16
    vals = rng.uniform(0.1, 2.0, cap).astype(np.float32)
    jst = JST.tree_set(JST.tree_init(cap, "sum"), jnp.arange(cap),
                       jnp.asarray(vals))
    st = ST.tree_set(ST.tree_init(cap, "sum"), torch.arange(cap),
                     torch.as_tensor(vals))
    np.testing.assert_array_equal(st.tree.numpy(), np.asarray(jst.tree))
    masses = rng.uniform(0, float(jst.tree[1]) - 1e-3, 50).astype(np.float32)
    np.testing.assert_array_equal(
        ST.find_prefixsum_idx(st, torch.as_tensor(masses)).numpy(),
        np.asarray(JST.find_prefixsum_idx(jst, jnp.asarray(masses))))
    # Min tree with a later partial update.
    v8 = np.asarray([5.0, 3.0, 9.0, 1.0, 7.0, 2.0, 8.0, 4.0], np.float32)
    mt = ST.tree_set(ST.tree_init(8, "min"), torch.arange(8),
                     torch.as_tensor(v8))
    assert float(ST.tree_total(mt)) == 1.0
    mt = ST.tree_set(mt, torch.tensor([3]), torch.tensor([10.0]))
    assert float(ST.tree_total(mt)) == 2.0
    # Partial sum update, the rebuild and a batched descent (strict >).
    s = ST.tree_set(ST.tree_init(8, "sum"), torch.arange(8), torch.ones(8))
    s = ST.tree_set(s, torch.tensor([2, 5]), torch.tensor([3.0, 0.0]))
    assert float(ST.tree_total(s)) == 9.0
    np.testing.assert_array_equal(
        ST.find_prefixsum_idx(s, torch.tensor([0.5, 1.5, 4.9, 8.99])).numpy(),
        [0, 1, 2, 7])
    assert ST.find_prefixsum_idx(s, torch.tensor([1.0])).tolist() == [1]
    with pytest.raises(ValueError, match="power of 2"):
        ST.find_prefixsum_idx(ST.tree_init(6, "sum"), torch.tensor([0.0]))
