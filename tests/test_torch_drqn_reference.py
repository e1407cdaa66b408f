"""The DRQN cell's plain reference (``perfbench/reference/drqn.py``), on
the CPU at a small size.

(a) The port's ``fused_drqn_init`` and ``fused_drqn_chunk`` (the plain
version of K9 on the CPU) and the reference agree field by field,
exactly, through the ring's warm-up and learning chunks with episodes
ending inside the windows: L0, self-play, a frozen opponent, random
starts.

(b) The reference's hand-written BPTT (``_grads_plain``) against
``torch.autograd`` through a plain unroll of the same net over
``torch.nn.LSTMCell`` in float64: an independent check of the reference
itself.  Tolerances: the reference sums in f32, so its gradient and loss
differ from the f64 unroll by f32 round-off over a 17-step recurrence and
a sum of B * L rows: at most 6.4e-7 of a leaf's largest entry, 5e-8 of
the loss, on the two seeds.  1e-5 leaves room for that and lies under
what bf16 operands cost (loss 4.7e-4, gradient 3.2e-2 at the least; the
last case shows them failing it).

(c) The reference imports nothing of JAX, ``merging_gym_tpu`` or
``merging_gym_tpu_torch``.
"""

import pathlib
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from merging_gym_tpu_torch.agents.drqn import DRQNConfig
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.nn.lstm import drqn_init
from merging_gym_tpu_torch.ops import fused_drqn as FD
from perfbench.paths.fused_drqn import bf16_forwards
from perfbench.reference import drqn as ref
from perfbench.reference.env import EnvParams as RefEnvParams
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 128
R = 2
SEED = 2 ** 31 + 4099
TOL = 1e-5   # see the module docstring

# (opponent, env overrides): episodes capped at 12 steps, so windows hold
# episode ends (the first-done mask) and resets; one case draws random
# starts from Philox.
CASES = {
    "l0": ("L0", dict(max_steps=12)),
    "selfplay": ("selfplay", dict(max_steps=12)),
    "frozen": ("frozen", dict(max_steps=12)),
    "l0_random_start": ("L0", dict(max_steps=12, random_start=True)),
}
INT_KEYS = ("R", "n", "B", "L", "warm", "learns", "steps", "env_steps",
            "ring_hbm")
FLOAT_KEYS = ("episodes", "collisions", "wins", "sum_ep_reward", "last_loss")
TENSOR_KEYS = ("p", "tp", "m", "v", "opp", "env", "win", "ring")


def assert_same_carry(port, refc):
    for k in TENSOR_KEYS:
        assert torch.equal(port[k], refc[k]), k
    for k in INT_KEYS:
        assert int(port[k]) == int(refc[k]), k
    for k in FLOAT_KEYS:
        assert float(port[k]) == float(refc[k]), k


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_plain_chunks_equal_the_reference(case):
    opponent, env_kw = CASES[case]
    # Target syncs every 5 learns, so the learning chunks hold some.
    cfg = DRQNConfig(memory_capacity=R * N, opponent=opponent, target_sync=5)
    rcfg = SimpleNamespace(**{k: getattr(cfg, k) for k in (
        "lr", "gamma", "epsilon", "target_sync", "seq_len", "burn_in",
        "opponent", "memory_capacity")})
    ep, rep = EnvParams(**env_kw), RefEnvParams(**env_kw)
    opp = None
    if opponent == "frozen":
        g = torch.Generator().manual_seed(77)
        opp = drqn_init(g, 10, 5, device=CPU)
    port = FD.fused_drqn_init(SEED, cfg, ep, N, opp, device=CPU)
    refc = ref.fused_drqn_init(SEED, rcfg, rep, N, opp, device=CPU)
    assert_same_carry(port, refc)
    # The warm-up to one step short of a full ring, a chunk across the
    # gate (mid-window), then a learning chunk across a flush.
    for steps in (R * 16 - 3, 5, 14):
        seed = SEED + port["steps"]
        port = FD.fused_drqn_chunk(cfg, ep, port, steps, seed)
        refc = ref.fused_drqn_chunk_plain(rcfg, rep, refc, steps, seed)
        assert_same_carry(port, refc)
    # Every step from the gate at global step R * 16 - 1 learns.
    assert port["learns"] == port["steps"] - (R * 16 - 1)
    assert port["episodes"] > 0


def windows(B=8, L=16, seed=3):
    """Random windows, rows-first, with an episode end in some."""
    g = torch.Generator().manual_seed(seed)
    done = torch.zeros(B, L)
    done[1, 9] = done[3, 2] = done[5, 15] = 1.0
    return {"obs": torch.randn(B, L + 1, 10, generator=g),
            "action": torch.randint(0, 5, (B, L), generator=g).float(),
            "reward": torch.randn(B, L, generator=g), "done": done}


def random_flat(seed, scale=0.3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(ref.P, generator=g) * scale


def autograd_grads(p, tp, batch, gamma, burn_in):
    """Loss and gradient (flat layout) by ``torch.autograd`` in float64
    through ``torch.nn.LSTMCell`` and dense layers."""
    f64 = torch.float64

    def net(flat, grad):
        v = [x.to(f64).clone().requires_grad_(grad) for x in ref.views(flat)]
        cell = torch.nn.LSTMCell(16, 16).to(f64)
        with torch.no_grad():
            cell.weight_ih.copy_(v[4].T)
            cell.bias_ih.copy_(v[5])
            cell.weight_hh.copy_(v[6].T)
            cell.bias_hh.copy_(v[7])
        cell.requires_grad_(grad)
        return v, cell

    def unroll(v, cell, X):
        h = c = torch.zeros(X.shape[0], 16, dtype=f64)
        qs = []
        for t in range(X.shape[1]):
            x2 = torch.relu(X[:, t] @ v[0] + v[1]) @ v[2] + v[3]
            h, c = cell(x2, (h, c))
            qs.append(torch.relu(h @ v[8] + v[9]) @ v[10] + v[11])
        return torch.stack(qs, dim=1)

    X = batch["obs"].to(f64)
    act = batch["action"].long()
    rew, done = batch["reward"].to(f64), batch["done"].to(f64)
    L = act.shape[1]
    ve, ce = net(p, True)
    vt, ct = net(tp, False)
    q = unroll(ve, ce, X)
    with torch.no_grad():
        qt = unroll(vt, ct, X)
        a_star = q[:, 1:].argmax(-1, keepdim=True)
        target = rew + gamma * qt[:, 1:].gather(-1, a_star)[..., 0] * (
            1.0 - done)
        ended = torch.cumsum(done, dim=1) - done > 0
        mask = ((torch.arange(L) >= burn_in)[None] & ~ended).to(f64)
    diff = q[:, :L].gather(-1, act[..., None])[..., 0] - target
    loss = (mask * diff * diff).sum() / mask.sum().clamp_min(1.0)
    loss.backward()
    leaves = [x.grad for x in ve]
    leaves[4:8] = [ce.weight_ih.grad.T, ce.bias_ih.grad, ce.weight_hh.grad.T,
                   ce.bias_hh.grad]
    flat = torch.cat([x.reshape(-1) for x in leaves])
    return float(loss.detach()), flat


def worst_gap(g_ref, g_auto):
    """max over leaves of max |ref - autograd| over the leaf's largest
    autograd entry."""
    out = 0.0
    for a, b in zip(ref.views(g_ref), ref.views(g_auto)):
        scale = float(b.abs().max())
        if scale > 0:
            out = max(out, float((a.double() - b).abs().max()) / scale)
    return out


@pytest.mark.parametrize("seed", [11, 12])
def test_bptt_gradient_matches_autograd(seed):
    batch = windows(seed=seed)
    p, tp = random_flat(seed), random_flat(seed + 100)
    grad, loss, msum = ref._grads_plain(p, tp, batch, gamma=0.9, burn_in=4,
                                        windows=4)
    a_loss, a_grad = autograd_grads(p, tp, batch, 0.9, 4)
    # 12 steps past burn-in a window; ends at t 9, 2 and 15 leave 6, 0, 12.
    assert float(msum) == 8 * 12 - 6 - 12
    assert abs(float(loss) - a_loss) <= TOL * abs(a_loss)
    assert worst_gap(grad, a_grad) <= TOL
    v = ref.views(grad)
    assert torch.equal(v[5], v[7])   # b_ih and b_hh: the same gradient
    # Every leaf moves: the unroll is not saturated at these weights.
    assert all(float(x.abs().max()) > 0 for x in v)


def test_bf16_operands_fail_the_autograd_tolerances():
    batch = windows(seed=11)
    p, tp = random_flat(11), random_flat(111)
    a_loss, a_grad = autograd_grads(p, tp, batch, 0.9, 4)
    with bf16_forwards():
        grad, loss, _ = ref._grads_plain(p, tp, batch, gamma=0.9,
                                         burn_in=4, windows=4)
    assert (abs(float(loss) - a_loss) > TOL * abs(a_loss)
            and worst_gap(grad, a_grad) > TOL)


def test_reference_imports_neither_jax_nor_either_package():
    code = ("import sys, perfbench.reference.drqn, "
            "perfbench.reference.counts_drqn; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'merging_gym_tpu', "
            "'merging_gym_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
