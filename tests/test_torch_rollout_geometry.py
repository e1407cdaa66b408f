"""K1/K2's launch geometry and lane-split step
(``kernels/csrc/env_rollout.cu``, ``ops.fused_rollout.rollout_geometry``)
on the CPU, without a card.

The geometry covers every env with one group of lanes and fills the
H100's SMs at 4,096 envs; the C constants equal the Python ones.  A
transcription of the kernel's step, lane by lane (each lane's own
coordinate of ``lon2coord``, the three shuffles, the reset table selected
by done, the actions fetched a group ahead into registers and stored to
a shared ring of two groups), equals the
plain versions bit for bit in both action sources and with episodes of
one step, of a few steps and of the default length.  The
reset table's first steps equal ``core.env.step`` from the start state
and JAX's ``_env_step_math``: kinematics, events and rewards exactly,
observations at the JAX tests' tolerance (``tests/test_fused_rollout.py``:
rtol 1e-6, atol 1e-3; XLA's and PyTorch's ``sin`` may differ by an ulp).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merging_gym_tpu.ops import fused_rollout as JFR
from merging_gym_tpu_torch.core import constants as C
from merging_gym_tpu_torch.core import env as E
from merging_gym_tpu_torch.core.control import action_to_acc
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.core.geometry import true_div
from merging_gym_tpu_torch.ops import fused_rollout as FR
from merging_gym_tpu_torch.ops import philox
from tests.torch_threads import one_torch_thread  # noqa: F401

SMS = 132
EDGE_ENVS = (1, 31, 33, 300, 4095, 4096, 4097)
SRC = os.path.join(os.path.dirname(FR.kernels.__file__), "csrc",
                   "env_rollout.cu")


def test_c_constants_equal_the_python_geometry():
    with open(SRC) as f:
        src = f.read()
    lanes = re.search(r"constexpr int kLanes = (\d+);", src)
    threads = re.search(r"constexpr int kThreads = (\d+);", src)
    ahead = re.search(r"constexpr int kAhead = (\d+);", src)
    assert int(lanes.group(1)) == FR.ROLLOUT_LANES == 4
    assert int(threads.group(1)) == FR.ROLLOUT_THREADS == 128
    assert int(ahead.group(1)) == FR.ROLLOUT_AHEAD == 8
    # The entry points take the geometry and refuse any other.
    assert src.count("if (!geometry_ok(lanes, threads, blocks, N))") == 2


@pytest.mark.parametrize("num_envs", EDGE_ENVS)
def test_geometry_covers_every_env_once(num_envs):
    """Thread i of block b serves env b * 32 + i // 4 as lane i % 4 (the
    kernel's ``n`` and ``l``); every env has each lane once, the rest of
    the last block is the masked tail."""
    g = FR.rollout_geometry(num_envs)
    assert (g.lanes, g.threads) == (FR.ROLLOUT_LANES, FR.ROLLOUT_THREADS)
    per_block = g.threads // g.lanes
    tid = np.arange(g.blocks * g.threads)
    n = tid // g.threads * per_block + tid % g.threads // g.lanes
    lane = tid % g.threads % g.lanes
    live = n < num_envs
    pairs = n[live] * g.lanes + lane[live]
    assert np.array_equal(np.sort(pairs), np.arange(num_envs * g.lanes))
    assert 0 <= g.blocks * per_block - num_envs < per_block  # the tail
    assert (~live).sum() == (g.blocks * per_block - num_envs) * g.lanes


def test_geometry_fills_the_card_at_4096_envs():
    g = FR.rollout_geometry(4096)
    assert g.blocks == 128 >= 128 and g.blocks <= SMS
    warps = g.blocks * g.threads // 32
    assert warps == 512 <= 4 * SMS  # at most one warp a scheduler
    assert FR.rollout_geometry(4097).blocks == 129


def _div_rn(x, d, r):
    """env_rollout.cu:div_rn on float32 ``x``: q0 = RN(x * r), rem =
    RN(x - q0 * d) and RN(q0 + rem * r), each fma rounded once.  float64
    holds x * r, x - q0 * d and rem * r exactly; the last sum, rounded in
    float64 first, lies too far from any float32 midpoint to round
    otherwise."""
    x64 = x.astype(np.float64)
    q0 = (x64 * r).astype(np.float32).astype(np.float64)
    rem = (x64 - q0 * d).astype(np.float32).astype(np.float64)
    return (q0 + rem * r).astype(np.float32)


@pytest.mark.parametrize("d,inv,lo", [(3.0, 0x3EAAAAAB, 1.0),
                                      (30000.0, 0x380BCF65, 512.0)])
def test_branch_free_division_equals_ieee_division(d, inv, lo):
    """div_rn by 3 (acc_of) and by 30,000 (lon2coord): RN(1 / d) is the
    constant in the source, and the quotient equals IEEE division for
    every float32 of a whole binade (2^23 values, acc_of's or lon2coord's
    range), zero, and a million others of either sign from 1e-6 to 1e6."""
    r = np.array([inv], np.uint32).view(np.float32)[0]
    assert r == np.float32(1.0 / d)
    with open(SRC) as f:
        assert re.search(rf"constexpr float kInv\w+ = {float(r)!r}f;",
                         f.read())
    bits = np.arange(2 ** 23, dtype=np.uint32) + np.float32(lo).view(
        np.uint32)
    rng = np.random.default_rng(0)
    others = (np.exp(rng.uniform(np.log(1e-6), np.log(1e6), 1_000_000))
              * rng.choice([-1.0, 1.0], 1_000_000)).astype(np.float32)
    for x in (bits.view(np.float32), others, np.zeros(1, np.float32)):
        want = x / np.float32(d)
        np.testing.assert_array_equal(_div_rn(x, d, np.float64(r)), want)


# ---------------------------------------------------------------------------
# The kernel's step, transcribed lane by lane
# ---------------------------------------------------------------------------

def _action_index(a):
    """env_rollout.cu:action_index."""
    return torch.where(a < 0, 0, torch.where(a > C.NUM_ACTIONS - 1,
                                             C.NUM_ACTIONS, a + 1))


def _advance(vel, pos, a):
    """env_rollout.cu:advance, in core.env.step's ops."""
    target = 10.0 * a.clamp(0, C.NUM_ACTIONS - 1).to(vel.dtype)
    acc = torch.where(a < 0, vel.new_zeros(()), action_to_acc(vel, target))
    v = torch.clamp_min(vel + acc * C.DT, 0.0)
    return v, pos + v * C.DT


def _reset_table():
    """The block's shared table: kinematics of the first step from the
    start by action index (6 entries)."""
    a = torch.arange(C.NUM_ACTIONS + 1) - 1
    start = torch.full((C.NUM_ACTIONS + 1,), 1.0)
    return _advance(start * C.START_VEL, start * C.START_POINT, a)


def _fetch_step(s, T, N, actions, key):
    """env_rollout.cu:fetch_step: the packed action indices of step s (rows
    past T read row T - 1), [N]."""
    if actions is None:
        w = philox.draw(s, N, philox.STREAM_ACTIONS, key, torch.device("cpu"))
        return (w[0] % (C.NUM_ACTIONS + 1)
                | (w[1] % (C.NUM_ACTIONS + 1)) << 8)
    row = actions[min(s, T - 1)].long()
    return _action_index(row[0]) | _action_index(row[1]) << 8


def _round_away(v):
    """env_rollout.cu:round_away: round_half_away but for a zero's sign."""
    return torch.copysign(torch.floor(torch.abs(v) + 0.5), v)


def _swap(own, lane):
    """K1's shuffles in env_rollout.cu: lane (v, c) holds coordinate c of
    vehicle v, [N, 4]; returns (x1, y1, x2, y2) as every lane selects them
    from its own and its partners' values (partner l ^ m read as
    [:, lane ^ m])."""
    v, c = lane & 1, lane >> 1
    o1, o2, o3 = (own[:, lane ^ m] for m in (1, 2, 3))
    mx, ox = torch.where(c == 0, own, o2), torch.where(c == 0, o1, o3)
    my, oy = torch.where(c == 0, o2, own), torch.where(c == 0, o3, o1)
    return (torch.where(v == 0, mx, ox), torch.where(v == 0, my, oy),
            torch.where(v == 0, ox, mx), torch.where(v == 0, oy, my))


def _lane_split_rollout(T, N, actions=None, seed=None, ep=EnvParams(),
                        ahead=FR.ROLLOUT_AHEAD):
    """K1's and K2's outputs as the kernel computes them, every per-lane
    value a [N, lanes] tensor; asserts that the lanes of an env agree."""
    key = philox.seed_key(seed) if actions is None else None
    lanes = FR.ROLLOUT_LANES  # lane (v, c): a vehicle and a coordinate
    lane = torch.arange(lanes)
    v, c = lane & 1, lane >> 1
    tab_vel, tab_pos = _reset_table()
    zero = torch.zeros((), dtype=torch.float32)

    def table(idx):
        return tab_vel[idx], tab_pos[idx]

    words = {k: [] for k in ("obs", "rewards", "done", "winner",
                             "collision")}
    sums = [torch.zeros(N, lanes) for _ in range(2)]
    counts = [torch.zeros(N, lanes, dtype=torch.int32) for _ in range(4)]

    # The shared ring of two groups of steps and each lane's pending group:
    # lane l fetches steps s0 + l + lanes * j of a group.
    ring = torch.zeros(2 * ahead, N, dtype=torch.int64)
    fetched = [ln + lanes * j for ln in range(lanes)
               for j in range(ahead // lanes)]
    pend = {}
    for m in fetched:
        ring[m] = _fetch_step(m, T, N, actions, key)
        ring[ahead + m] = _fetch_step(ahead + m, T, N, actions, key)
        pend[m] = _fetch_step(2 * ahead + m, T, N, actions, key)
    a0 = ring[0][:, None].expand(N, lanes)
    (v1, q1), (v2, q2) = table(a0 & 0xFF), table(a0 >> 8)
    tc = torch.ones(N, lanes, dtype=torch.int32)
    wprev = torch.zeros(N, lanes, dtype=torch.int32)
    for t in range(T):
        an = ring[(t + 1) % (2 * ahead)][:, None].expand(N, lanes)
        n1 = _advance(v1, q1, (an & 0xFF) - 1)
        n2 = _advance(v2, q2, (an >> 8) - 1)
        r1, r2 = table(an & 0xFF), table(an >> 8)

        done = tc >= ep.max_steps
        pen1 = -ep.time_penalty - ep.vel_penalty * torch.abs(v1 - C.V_REF)
        pen2 = -ep.time_penalty - ep.vel_penalty * torch.abs(v2 - C.V_REF)
        w0 = wprev
        c1 = q1 > C.END_POINT
        rw1 = torch.where(c1, torch.where(
            w0 == 0, pen1 + ep.r_first,
            torch.where(w0 == 1, zero, pen1 + ep.r_second)), pen1)
        done = done | (c1 & (w0 == 2))
        w1 = torch.where(c1 & (w0 == 0), 1, w0)
        c2 = q2 >= C.END_POINT
        rw2 = torch.where(c2, torch.where(
            w1 == 0, pen2 + ep.r_first,
            torch.where(w1 == 2, zero, pen2 + ep.r_second)), pen2)
        done = done | (c2 & (w1 == 1))
        winner = torch.where(c2 & (w1 == 0), 2, w1).to(torch.int32)

        pown = torch.where(v == 0, q1, q2)
        angle = C.ANGLE0 - true_div(pown, C.R)
        s = torch.sin(torch.where(c == 0, angle, 0.5 * angle))
        vs = 2.0 * C.R * s * s
        mine = torch.where(c == 0, C.R * s, torch.where(
            v == 0, C.W / 2 + vs, C.W / 2 - vs))
        r = _round_away(mine)
        o1, o2, o3 = (r[:, lane ^ m] for m in (1, 2, 3))
        da, db = torch.abs(r - o1), torch.abs(o2 - o3)
        col = torch.where(c == 0,
                          (da <= C.VEHICLE_H) & (db <= C.VEHICLE_W),
                          (db <= C.VEHICLE_H) & (da <= C.VEHICLE_W))
        # K1's observation: the unrounded coordinates, swapped.
        x1, y1, x2, y2 = _swap(mine, lane)
        done = done | col
        penalty = torch.where(col, torch.full((), ep.r_collision), zero)
        rw1, rw2 = rw1 + penalty, rw2 + penalty

        step_words = [x2 - x1, y2 - y1, v2 - v1, C.END_POINT - q1, v1,
                      x1 - x2, y1 - y2, v1 - v2, C.END_POINT - q2, v2,
                      rw1, rw2, done, winner, col]
        for w in step_words:  # every lane holds every word
            assert torch.equal(w, w[:, :1].expand_as(w))
        # Word w is stored by lane w % lanes.
        own = [w[:, i % lanes] for i, w in enumerate(step_words)]
        words["obs"].append(torch.stack(own[:10]))
        words["rewards"].append(torch.stack(own[10:12]))
        for name, w in zip(("done", "winner", "collision"), own[12:]):
            words[name].append(w)
        sums = [sums[0] + rw1, sums[1] + rw2]
        for i, x in enumerate((done, col, done & (winner == 1) & ~col,
                               done & (winner == 2) & ~col)):
            counts[i] = counts[i] + x.to(torch.int32)

        v1, q1 = (torch.where(done, r1[0], n1[0]),
                  torch.where(done, r1[1], n1[1]))
        v2, q2 = (torch.where(done, r2[0], n2[0]),
                  torch.where(done, r2[1], n2[1]))
        tc = torch.where(done, 1, tc + 1)
        wprev = torch.where(done, 0, winner)
        if t % ahead == ahead - 1:
            # Group t // ahead is read: group + 2 takes its slots, group + 3
            # is fetched.
            s0 = t + 1 + ahead
            for m in fetched:
                ring[(s0 + m) % (2 * ahead)] = pend[m]
                pend[m] = _fetch_step(s0 + ahead + m, T, N, actions, key)
    traj = {k: torch.stack(w) for k, w in words.items()}
    traj["winner"] = traj["winner"].to(torch.int32)
    cnt = {"reward_sum": torch.stack([s[:, i % lanes]
                                      for i, s in enumerate(sums)]),
           **{k: x[:, (i + 2) % lanes] for i, (k, x) in enumerate(zip(
               ("episodes", "collisions", "wins1", "wins2"), counts))}}
    return traj, cnt


def _case_actions(T, N, seed):
    rng = np.random.default_rng(seed)
    # Out-of-range actions too: clamped to 4, or no acceleration below 0.
    return torch.as_tensor(rng.integers(-3, C.NUM_ACTIONS + 2, (T, 2, N)),
                           dtype=torch.int32)


# (T, N, max_steps): T of 1, of one and two fetch groups, not a multiple
# of the fetch depth, and longer than an episode; one env and a few
# hundred; episodes of one step (every step resets), of 2 and 3 steps
# (every env resets often), of 40, and the default timeout (collisions
# and wins end them).
CASES = [(1, 5, None), (37, 33, 3), (61, 31, 40), (150, 64, None),
         (8, 1, 1), (16, 300, 2), (23, 7, 3), (256, 9, None)]


@pytest.mark.parametrize("mode", ["actions", "seed"])
@pytest.mark.parametrize("T,N,max_steps", CASES)
def test_lane_split_step_equals_the_plain_versions(T, N, max_steps, mode):
    ep = EnvParams(**({} if max_steps is None else {"max_steps": max_steps}))
    kw = ({"actions": _case_actions(T, N, T + N)} if mode == "actions"
          else {"seed": 5 + T})
    traj, cnt = _lane_split_rollout(T, N, ep=ep, **kw)
    want = FR.fused_rollout_plain(T, N, env_params=ep, device="cpu", **kw)
    want_cnt = FR.fused_rollout_counters_plain(T, N, env_params=ep,
                                               device="cpu", **kw)
    for k in ("obs", "rewards", "winner"):
        assert torch.equal(traj[k], want[k]), k
    for k in ("done", "collision"):
        assert torch.equal(traj[k], want[k]), k
    for k in want_cnt:
        assert torch.equal(cnt[k], want_cnt[k]), k
    if T > 30:
        assert want["done"].any()
    if max_steps is not None and max_steps <= 3:
        assert int(want_cnt["episodes"].sum()) >= N * (T // max_steps)


def test_reset_table_equals_env_step_and_jax_from_the_start():
    """The 36 joint first steps of an episode (and clamped actions out of
    range) from the table's kinematics and the kernel's events, against
    core.env.step and JAX's _env_step_math from the start state."""
    acts = np.array([(a1, a2) for a1 in range(-1, C.NUM_ACTIONS)
                     for a2 in range(-1, C.NUM_ACTIONS)]
                    + [(7, -3), (-2, 9), (5, 5)], np.int32)
    n = len(acts)
    a = torch.as_tensor(acts)
    tab_vel, tab_pos = _reset_table()
    i1, i2 = _action_index(a[:, 0]), _action_index(a[:, 1])
    # 36 distinct joint outcomes, 6 per vehicle.
    assert len({(int(x), int(y)) for x, y in zip(i1, i2)}) == 36
    vel = torch.stack([tab_vel[i1], tab_vel[i2]], dim=-1)
    pos = torch.stack([tab_pos[i1], tab_pos[i2]], dim=-1)
    # From the table's kinematics, one lane-split step's events (the
    # transcription above, at T = 1 with these actions).
    traj, _ = _lane_split_rollout(1, n, actions=a.T[None].contiguous())
    st, ts = E.step(EnvParams(), E.reset(EnvParams(), None, n,
                                         device="cpu"), a)
    assert torch.equal(vel, st.vel) and torch.equal(pos, st.pos)
    assert torch.equal(traj["obs"][0].T, ts.obs)
    assert torch.equal(traj["rewards"][0].T, ts.rewards)
    for k in ("done", "winner", "collision"):
        assert torch.equal(traj[k][0], getattr(ts, k)), k

    ep = EnvParams()
    j = JFR._env_step_math(
        jnp.full((2, n), C.START_POINT, jnp.float32),
        jnp.full((2, n), C.START_VEL, jnp.float32),
        jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32),
        jnp.zeros(n, bool), jnp.asarray(acts.T), FR.rewards_cfg(ep),
        ep.max_steps)
    jpos, jvel, jw, jt, jdone, jcol, jrew, jobs, _ = (np.asarray(x)
                                                      for x in j)
    np.testing.assert_array_equal(pos.numpy().T, jpos)
    np.testing.assert_array_equal(vel.numpy().T, jvel)
    np.testing.assert_array_equal(traj["done"][0].numpy(), jdone)
    np.testing.assert_array_equal(traj["collision"][0].numpy(), jcol)
    np.testing.assert_array_equal(traj["winner"][0].numpy(), jw)
    assert (jt == 1).all()
    np.testing.assert_allclose(traj["rewards"][0].numpy(), jrew, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(traj["obs"][0].numpy(), jobs, rtol=1e-6,
                               atol=1e-3)
