"""K8 of the PyTorch port (plain version, on the CPU) against the JAX
package's ``ops.fused_rainbow``: its layouts, learner math, n-step and PER
building blocks, and whole chunks of the Pallas kernel in interpret mode
from the same carried-across carry (``rainbow_carry_from_numpy``).

Greedy mode with host-supplied ``rounds``/``cols``/``us`` is deterministic
in both packages, so whole chunks are held at ``_check``'s tolerances of
``tests/test_fused_rainbow.py:343-371``: winners, learns, episodes,
collisions and wins exact; positions, velocities and episode rewards to
1e-4 (positions with the 2-ulp allowance of ROADMAP Queue 3); the PER
running max to rtol 1e-4; the ring (PER priorities included) to 1e-4;
p, tp, m and v to rtol 2e-3, atol 2e-4; the loss to rtol 1e-3.  The
cases are the JAX tests' setups (mid-race starts, so short runs cross
wins, collisions, resets and target syncs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merging_gym_tpu.agents.rainbow import RainbowConfig as JRainbowConfig
from merging_gym_tpu.core.env import EnvParams as JEnvParams
from merging_gym_tpu.core.geometry import lon2coord as jax_lon2coord
from merging_gym_tpu.nn.mlp import qnet_init as jax_qnet_init
from merging_gym_tpu.nn.rainbow_net import rainbow_apply as jax_rainbow_apply
from merging_gym_tpu.nn.rainbow_net import rainbow_init as jax_rainbow_init
from merging_gym_tpu.nn.rainbow_net import \
    rainbow_sample_noise as jax_rainbow_noise
from merging_gym_tpu.ops import fused_rainbow as JFR
from merging_gym_tpu.ops import fused_trainer as JFT
from merging_gym_tpu_torch.agents.rainbow import RainbowConfig
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.ops import fused_rainbow as FR
from merging_gym_tpu_torch.ops import philox
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def _interpret_mode():
    from jax.experimental import pallas as pl

    mp = pytest.MonkeyPatch()
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    mp.setattr(JFR.pl, "pallas_call", patched)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def nets():
    """JAX params of two nets and two noise sets, numpy, packed."""
    k = jax.random.split(jax.random.key(1), 4)
    p = jax.tree.map(np.asarray, jax_rainbow_init(k[0], 10, 5))
    tp = jax.tree.map(np.asarray, jax_rainbow_init(k[1], 10, 5))
    eps = jax.tree.map(np.asarray, jax_rainbow_noise(k[2], 5))
    teps = jax.tree.map(np.asarray, jax_rainbow_noise(k[3], 5))
    return p, tp, eps, teps


def _packed(tree):
    return tuple(np.asarray(a) for a in JFR.rainbow_params_to_packed(tree))


def _packed_noise(tree):
    return tuple(np.asarray(a) for a in JFR.rainbow_noise_to_packed(tree))


def test_layout_converters_round_trip(nets):
    p, _, eps, _ = nets
    flat = FR.params_to_flat(p)
    assert flat.shape == (FR.NUM_P,) == (58884,)
    back = FR.flat_to_params(flat)
    from_packed = FR.params_from_packed(_packed(p))
    jax_back = JFR.rainbow_packed_to_params(JFR.rainbow_params_to_packed(p))
    for layer in p:
        for k in p[layer]:
            np.testing.assert_array_equal(back[layer][k].numpy(), p[layer][k])
            np.testing.assert_array_equal(from_packed[layer][k],
                                          np.asarray(jax_back[layer][k]))
    nflat = FR.noise_to_flat(eps)
    assert nflat.shape == (FR.NUM_E,) == (28210,)
    nback = FR.flat_to_noise(nflat)
    npk = FR.noise_from_packed(_packed_noise(eps))
    for layer in eps:
        for k in eps[layer]:
            np.testing.assert_array_equal(nback[layer][k].numpy(),
                                          eps[layer][k])
            np.testing.assert_array_equal(npk[layer][k], eps[layer][k])
    # Effective weights: mu + sigma * eps per element.
    eff = FR.flat_to_noise(FR.effective_weights(flat, nflat))
    w = p["noisy_advantage2"]
    np.testing.assert_array_equal(
        eff["noisy_advantage2"]["w_eps"].numpy(),
        w["w_mu"] + w["w_sigma"] * eps["noisy_advantage2"]["w_eps"])


def test_forward_matches_jax_packed_forward(nets):
    p, _, eps, _ = nets
    x = (np.random.default_rng(9).standard_normal((64, 10)) * 3.0
         ).astype(np.float32)
    flat = FR.params_to_flat(p)
    got = FR.rb_forward(flat, FR.effective_weights(flat, FR.noise_to_flat(eps)),
                        torch.as_tensor(x))["dist"]
    want = JFR._rb_fwd(JFR.rainbow_params_to_packed(p),
                       JFR.rainbow_noise_to_packed(eps), jnp.asarray(x.T))
    for a in range(5):
        np.testing.assert_allclose(got[:, a].numpy(),
                                   np.asarray(want["dists"][a][:51]).T,
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(FR.rb_q(got).numpy(),
                               np.asarray(JFR._rb_q(want["dists"])).T,
                               rtol=1e-4, atol=5e-6)


def test_fresh_noise_has_jax_noise_semantics(nets):
    """K8's noise regeneration (``fresh_noise``, which ``rb_post`` equals
    on the card) against JAX's ``_fresh_eps``/``noisy_sample_noise``: per
    noisy layer the w block, read in the JAX dict layout, is the rank-one
    ``outer(f(eps_in), f(eps_out))`` of shape (in, out); the bias vector is
    independent of it; ``f(x) = sign(x) * sqrt(|x|)`` shows in the moments
    (E f = 0, E f^2 = sqrt(2 / pi), E f^4 = 1); and JAX's ``rainbow_apply``
    under the drawn noise equals the port's forward on the same flat
    draw."""
    p, _, eps, _ = nets
    key = philox.seed_key(7)
    b_all, out_all, w_sq = [], [], []
    for gstep in range(12):
        flat = [FR.fresh_noise(gstep, net, key, CPU) for net in (0, 1)]
        assert not torch.equal(flat[0], flat[1])
        for f in flat:
            assert f.shape == (FR.NUM_E,)
            noise = {k: {n: a.numpy().astype(np.float64) for n, a in v.items()}
                     for k, v in FR.flat_to_noise(f).items()}
            for layer in eps:
                w, b = noise[layer]["w_eps"], noise[layer]["b_eps"]
                assert w.shape == eps[layer]["w_eps"].shape
                assert b.shape == eps[layer]["b_eps"].shape
                # Rank one in the (in, out) layout: w = outer(w[:, 0] /
                # w[0, 0], w[0, :]) up to rounding.
                np.testing.assert_allclose(
                    np.outer(w[:, 0] / w[0, 0], w[0, :]), w, rtol=1e-5,
                    atol=1e-6, err_msg=layer)
                b_all.append(b)
                out_all.append(w[0, :] / np.sqrt(np.mean(w[0, :] ** 2)))
                w_sq.append(np.mean(w * w))
    b_all = np.concatenate(b_all)           # 12 x 2 x 434 draws of f(N)
    # The bias is drawn apart from the out factor of the w block.
    assert abs(np.corrcoef(b_all, np.concatenate(out_all))[0, 1]) < 0.05
    assert abs(np.mean(b_all)) < 0.03
    np.testing.assert_allclose(np.mean(b_all ** 2), np.sqrt(2 / np.pi),
                               rtol=0.03)
    np.testing.assert_allclose(np.mean(b_all ** 4), 1.0, rtol=0.08)
    np.testing.assert_allclose(np.mean(w_sq), 2 / np.pi, rtol=0.05)

    x = (np.random.default_rng(4).standard_normal((32, 10)) * 3.0
         ).astype(np.float32)
    flat_p, flat_e = FR.params_to_flat(p), FR.fresh_noise(3, 0, key, CPU)
    got = FR.rb_forward(flat_p, FR.effective_weights(flat_p, flat_e),
                        torch.as_tensor(x))["dist"]
    jnoise = {k: {n: a.numpy() for n, a in v.items()}
              for k, v in FR.flat_to_noise(flat_e).items()}
    want = jax_rainbow_apply(p, jnp.asarray(x), jnoise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("faithful,obs_scale,weighted",
                         [(True, 0.01, False), (False, None, True)])
def test_learn_math_matches_jax(nets, faithful, obs_scale, weighted):
    """tests/test_fused_rainbow.py:88-147's batch and tolerances against
    JAX's plain ``rainbow_learn_math``, two Adam steps; with PER weights
    the CE stays unweighted."""
    p, tp, eps, teps = nets
    n = 128
    rng = np.random.default_rng(5)
    batch = {"obs": rng.normal(0, 30, (10, n)).astype(np.float32),
             "next_obs": rng.normal(0, 30, (10, n)).astype(np.float32),
             "action": rng.integers(0, 5, n).astype(np.int32),
             "reward": rng.normal(0, 2, n).astype(np.float32),
             "done": rng.random(n) < 0.3}
    w = rng.uniform(0.1, 1.0, n).astype(np.float32) if weighted else None
    kw = dict(gamma=0.9, lr=1e-3, obs_scale=obs_scale, faithful=faithful)
    jp, jtp = JFR.rainbow_params_to_packed(p), JFR.rainbow_params_to_packed(tp)
    jz = tuple(jnp.zeros_like(a) for a in jp)
    je, jte = (JFR.rainbow_noise_to_packed(eps),
               JFR.rainbow_noise_to_packed(teps))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    fp, ftp = FR.params_to_flat(p), FR.params_to_flat(tp)
    fz = torch.zeros_like(fp)
    fe, fte = FR.noise_to_flat(eps), FR.noise_to_flat(teps)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    jm = jv = jz
    fm = fv = fz
    for t in (1, 2):
        jp, jm, jv, jloss, jce = JFR.rainbow_learn_math(
            jp, jtp, jm, jv, je, jte, jbatch, jnp.int32(t),
            weights=None if w is None else jnp.asarray(w), **kw)
        fp, fm, fv, loss, ce = FR.rainbow_learn_math(
            fp, ftp, fm, fv, fe, fte, tbatch, t,
            weights=None if w is None else torch.as_tensor(w), **kw)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(ce.numpy(), np.asarray(jce), rtol=1e-4,
                                   atol=1e-5)
        want = FR.params_to_flat(JFR.rainbow_packed_to_params(jp))
        np.testing.assert_allclose(fp.numpy(), want.numpy(), rtol=1e-3,
                                   atol=3e-5, err_msg=f"step {t}")


def test_nstep_batch_from_slabs_equals_jax():
    rng = np.random.default_rng(1)
    slabs = []
    for _ in range(3):
        s = rng.normal(size=(24, 64)).astype(np.float32)
        s[20] = rng.integers(0, 5, 64)
        s[22] = rng.random(64) < 0.3
        slabs.append(s)
    want = JFR.nstep_batch_from_slabs([jnp.asarray(s) for s in slabs], 0.9)
    got = FR.nstep_batch_from_slabs([torch.as_tensor(s) for s in slabs], 0.9)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_per_pick_indices_equal_jax():
    """tests/test_fused_rainbow.py:525-543's grid: invalid rounds zeroed,
    targets across the whole mass, the clip at the top edge."""
    rng = np.random.default_rng(0)
    R, n, B = 8, 256, 64
    P = rng.random((R, n)).astype(np.float32)
    P[5:] = 0.0
    cdf, total = FR.per_cdf(torch.as_tensor(P))
    np.testing.assert_allclose(float(total), P.sum(dtype=np.float64),
                               rtol=1e-5)
    u = ((np.arange(B) + rng.random()) / B * float(total)).astype(np.float32)
    u[-1] = float(total) * 2.0  # beyond the mass: clipped to the last slot
    ohR, ohL, p_sel = JFR.per_pick(jnp.asarray(P),
                                   jnp.asarray(u[:, None], jnp.float32))
    r, lane, p = FR.per_pick(torch.as_tensor(P), torch.as_tensor(u), cdf)
    np.testing.assert_array_equal(r.numpy(), np.asarray(ohR).argmax(1))
    np.testing.assert_array_equal(lane.numpy(), np.asarray(ohL).argmax(1))
    np.testing.assert_array_equal(p.numpy(), P[r.numpy(), lane.numpy()])
    assert (r.numpy()[-1], lane.numpy()[-1]) == (R - 1, n - 1)


def _race(n, seed):
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(870.0, 948.0, n),
                    rng.uniform(870.0, 948.0, n)]).astype(np.float32)
    vel = np.stack([rng.uniform(5.0, 40.0, n),
                    rng.uniform(5.0, 40.0, n)]).astype(np.float32)
    return pos, vel


def _mk(cfg, ep, n, seed, race_seed, learn_batch=None, opp=None):
    """tests/test_fused_rainbow.py:_mk, with an optional frozen opponent."""
    carry = JFR.fused_rainbow_init(jax.random.key(seed), cfg, ep, n, opp,
                                   learn_batch=learn_batch)
    pos, vel = _race(n, race_seed)
    env = np.asarray(carry["env"]).copy()
    env[0:2], env[2:4] = pos, vel
    x1, y1 = jax_lon2coord(jnp.asarray(pos[0]), +1.0)
    x2, y2 = jax_lon2coord(jnp.asarray(pos[1]), -1.0)
    env[4:8] = np.stack([np.asarray(v) for v in (x1, y1, x2, y2)])
    carry["env"] = jnp.asarray(env)
    return carry


def _run(chunk_fn, cfg, ep, carry, rounds, cols, us, splits):
    lo = 0
    for hi in splits + [len(rounds)]:
        carry = chunk_fn(cfg, ep, carry, hi - lo, seed=0, greedy=True,
                         rounds=rounds[lo:hi], cols=cols[lo:hi],
                         us=us[lo:hi])
        lo = hi
    return carry


def _check(got, want):
    g, w = got["env"].numpy(), want["env"].numpy()
    np.testing.assert_allclose(g[0:4], w[0:4], rtol=2.5e-7, atol=1e-4,
                               err_msg="pos/vel")
    np.testing.assert_array_equal(g[8], w[8], err_msg="winner")
    np.testing.assert_allclose(g[10], w[10], rtol=0, atol=1e-4,
                               err_msg="ep_reward")
    np.testing.assert_array_equal(g[11:13], w[11:13],
                                  err_msg="synced / episode counts")
    np.testing.assert_allclose(g[13], w[13], rtol=1e-4, atol=1e-5,
                               err_msg="max_priority")
    np.testing.assert_allclose(got["ring"].numpy(), want["ring"].numpy(),
                               rtol=1e-4, atol=1e-4, err_msg="ring")
    for k in ("p", "tp", "m", "v"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=2e-3, atol=2e-4, err_msg=k)
    for k in ("eps", "teps"):  # greedy: the noise is never redrawn
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    for k in ("learns", "steps", "warm", "env_steps", "episodes",
              "collisions", "wins"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["sum_ep_reward"], want["sum_ep_reward"],
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["last_loss"], want["last_loss"],
                               rtol=1e-3, atol=1e-6)


CASES = {
    # name: (n, T, splits, max_steps, learn_batch, seed, race seed, cfg)
    # :386-407, cold (3 steps) then warm; the sync must fire twice.
    "selfplay_faithful": (128, 24, [3], 20, None, 0, 500, dict(
        lr=1e-3, gamma=0.9, target_sync_episodes=3, memory_capacity=3 * 128,
        obs_scale=0.01, opponent=JFT.OPP_SELFPLAY)),
    # :410-427's setup with self-play and the reference's roll-3 bug.
    "selfplay_roll3_textbook": (128, 20, [], 18, None, 7, 600, dict(
        lr=5e-4, gamma=0.99, target_sync_episodes=4,
        memory_capacity=2 * 128, obs_scale=None, faithful_c51=False,
        opponent=JFT.OPP_SELFPLAY, opponent_roll=3)),
    # :661-686, uniform 3-step starts on a 128-lane window of 256 envs.
    "uniform_3step_window": (256, 20, [9], 15, 128, 9, 902, dict(
        lr=1e-3, gamma=0.9, target_sync_episodes=4, memory_capacity=4 * 256,
        obs_scale=0.01, opponent=JFT.OPP_L0, n_step=3)),
    # :609-635, PER 3-step in two launches.
    "per_3step": (128, 24, [7], 16, None, 3, 900, dict(
        lr=1e-3, gamma=0.9, target_sync_episodes=3, memory_capacity=5 * 128,
        obs_scale=0.01, opponent=JFT.OPP_SELFPLAY, per=True, n_step=3,
        per_alpha=0.6, per_beta=0.4, batch_size=32)),
    # :638-657, PER 1-step against L0, textbook, one launch.
    "per_1step_l0": (128, 20, [], 18, None, 5, 901, dict(
        lr=5e-4, gamma=0.99, target_sync_episodes=4, memory_capacity=3 * 128,
        obs_scale=0.01, faithful_c51=False, opponent=JFT.OPP_L0, per=True,
        n_step=1, per_beta=0.5, batch_size=40)),
    # A frozen MLP opponent through the Phi(0.7) pick (greedy here).
    "frozen_opponent": (128, 16, [], 20, None, 11, 903, dict(
        lr=1e-3, gamma=0.9, target_sync_episodes=3, memory_capacity=3 * 128,
        obs_scale=0.01, opponent=JFT.OPP_FROZEN)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunks_match_pallas_kernel(_interpret_mode, case):
    n, T, splits, max_steps, B, seed, race_seed, kw = CASES[case]
    jcfg, cfg = JRainbowConfig(**kw), RainbowConfig(**kw)
    jep, ep = JEnvParams(max_steps=max_steps), EnvParams(max_steps=max_steps)
    rng = np.random.default_rng(seed + 20)
    hi = np.maximum(np.arange(T) - (cfg.n_step - 1), 0)
    R = cfg.memory_capacity // n
    rounds = np.minimum(rng.integers(0, R, T), hi).astype(np.int32)
    cols = (np.zeros(T, np.int32) if B is None
            else rng.integers(0, n // B, T).astype(np.int32))
    us = rng.random(T).astype(np.float32)
    opp = None
    if cfg.opponent == JFT.OPP_FROZEN:
        opp = jax.tree.map(lambda w: (w - jnp.mean(w)) * 0.05,
                           jax_qnet_init(jax.random.key(seed + 50), 10, 5))
    jcarry = _mk(jcfg, jep, n, seed, race_seed, learn_batch=B, opp=opp)
    carry = FR.rainbow_carry_from_numpy(jcarry, CPU)
    want = _run(JFR.fused_rainbow_chunk, jcfg, jep, jcarry, rounds, cols, us,
                splits)
    got = _run(FR.fused_rainbow_chunk, cfg, ep, carry, rounds, cols, us,
               splits)
    want = FR.rainbow_carry_from_numpy(want, CPU)
    assert want["learns"] == T - cfg.n_step and want["episodes"] > 0
    if case == "selfplay_faithful":
        assert want["env"][11, 0] >= 2, "the episodic sync must fire twice"
    if cfg.per:
        assert float(want["env"][13, 0]) > 1.0, "the running max moved"
    _check(got, want)


def test_learn_counts_and_schedule_match_jax():
    """``apply_rainbow_chunk`` gives JAX's warm flag and learn count over
    uneven chunks, cold to warm, for n-step 1 and 3."""
    for n_step in (1, 3):
        carry = {"R": 4, "n": 128, "steps": 0, "warm": 0, "learns": 0,
                 "env_steps": 0, "episodes": 0.0, "collisions": 0.0,
                 "wins": 0.0, "sum_ep_reward": 0.0}
        jcarry = dict(carry)
        for T in (1, 1, 2, 5, 1, 9):
            sched = list(FR._schedule(carry, T, n_step))
            carry = FR.apply_rainbow_chunk(carry, {}, T, [0.0] * 4, 0.0,
                                           nwarm=n_step)
            jcarry = JFR.apply_rainbow_chunk(jcarry, [None] * 36, None, None,
                                             T, [0.0] * 4, 0.0, nwarm=n_step)
            for k in ("steps", "warm", "learns"):
                assert carry[k] == jcarry[k], (n_step, k)
            learned = sum(1 for s in sched if s[2])
            assert [s[3] for s in sched if s[2]] == list(
                range(carry["learns"] - learned + 1, carry["learns"] + 1))
        assert carry["learns"] == 19 - n_step


def test_host_streams_are_valid_draws():
    carry = {"R": 4, "steps": 1}
    g = torch.Generator().manual_seed(3)
    r1 = FR.draw_start_rounds(carry, 200, g, 1)
    assert int(r1.min()) >= 0 and int(r1.max()) <= 3
    assert int(r1[0]) <= 1  # two rounds stored after step 0 of this chunk
    r3 = FR.draw_start_rounds({"R": 8, "steps": 20}, 500, g, 3)
    stored_start = (20 + torch.arange(500)) % 8
    age = (stored_start - r3) % 8
    assert int(age.min()) >= 2 and int(age.max()) <= 7


def test_validation_errors_match_jax():
    """Each refusal of the JAX ``fused_rainbow_init``/``_chunk``, one for
    one (the same configurations refused with the same message)."""
    n = 128
    ok = dict(memory_capacity=2 * n, opponent=JFT.OPP_L0)
    bad_init = [
        (dict(ok, num_atoms=41), {}, "compiled for"),
        (dict(ok, n_step=0), {}, "n_step must be"),
        (dict(ok, per=True, batch_size=4), dict(learn_batch=12),
         "multiple of 8"),
        (ok, dict(learn_batch=96), "learn_batch must be"),
        (dict(ok, memory_capacity=n), {}, "memory_capacity must be"),
        (dict(ok, n_step=2), {}, "memory_capacity must be"),
        (dict(ok, opponent=JFT.OPP_FROZEN), {}, "opp_params"),
        (dict(ok, per=True), dict(ring_hbm=True), "ring_hbm"),
    ]
    for kw, extra, msg in bad_init:
        with pytest.raises(ValueError, match=msg):
            JFR.fused_rainbow_init(jax.random.key(0), JRainbowConfig(**kw),
                                   JEnvParams(), n, **extra)
        with pytest.raises(ValueError, match=msg):
            FR.fused_rainbow_init(0, RainbowConfig(**kw), EnvParams(), n,
                                  device=CPU, **extra)
    with pytest.raises(ValueError, match="multiple of 128"):
        FR.fused_rainbow_init(0, RainbowConfig(**ok), EnvParams(), 100,
                              device=CPU)
    cfg = RainbowConfig(**ok)
    carry = FR.fused_rainbow_init(0, cfg, EnvParams(), n, device=CPU)
    for kw, msg in ((dict(rounds=[0, 2]), "rounds must lie"),
                    (dict(cols=[0, 1]), "cols in"),
                    (dict(us=[0.5, 1.0]), "us must lie"),
                    (dict(rounds=[0]), "i32")):
        with pytest.raises(ValueError, match=msg):
            FR.fused_rainbow_chunk(cfg, EnvParams(), carry, 2, 0, **kw)
    with pytest.raises(ValueError, match="num_steps"):
        FR.fused_rainbow_chunk(cfg, EnvParams(), carry, 0, 0)
    with pytest.raises(ValueError, match="random starts"):
        FR.fused_rainbow_chunk(cfg, EnvParams(random_start=True), carry, 2,
                               0, greedy=True)
