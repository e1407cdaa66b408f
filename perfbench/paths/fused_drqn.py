"""K9, the fused recurrent DQN (DRQN) trainer (``ops.fused_drqn``), as
``cli.py train --algo drqn --fused-kernel`` drives it: ``fused_drqn_init``,
then back-to-back ``fused_drqn_chunk`` calls, each followed by the
read-back of the carry's counters.  Set-up and the comparison with the
reference are those of ``perfbench/training.py``; the reference is the
frozen plain K9 in ``reference/drqn.py``.

The ring fills after R * L - 1 steps, so the set-up's one-step calls run
that long before the first learns.

At the reference's own init (fc1 and fc2 with U(0, 1) weights) the LSTM's
gates saturate: 8 of the 12 leaves (fc1, fc2, the LSTM's four) get an
exactly zero gradient, so ``perfbench/training.py``'s numbers see the
heads and the loss alone.  The cell therefore adds a second comparison at the same sizes,
through the same ``fused_drqn_chunk``: from the program's state after chunk
A with both nets' leaves centred and scaled by ``SHRINK`` (unsaturated
gates: every leaf carries gradient) and Adam's moments at zero,
``first_learns`` one-step calls, then a chunk of ``shrunk_steps`` steps.
Compared, as above but from that start:

``shrunk_loss_gap``
    the largest relative gap of the loss of each of the first learns;
``shrunk_grad1_gap``
    the first learn's gradient (``m / (1 - beta1)``, the moments starting
    at zero), by the worst of all twelve leaves;
``shrunk_change_gap``
    the parameters' change over the first learns and the chunk, by the
    worst leaf.

The DRQN trainer has no lower-precision path of its own, so
``control="bfloat16"`` puts the reference in the program's place with the
operands of every dense layer and of both gate products rounded to bf16
(sums in f32): the control that the comparison must fail.
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import torch

from perfbench import compare
from perfbench.reference import counts_drqn
from perfbench.reference import drqn as ref
from perfbench.reference.env import EnvParams as RefEnvParams
from perfbench.training import TrainCell, host, to_device

# Qualified: ``grad_kernel`` alone is also a part of K5's kernel names.
LEARNER_KERNELS = ("drqn::in_kernel", "drqn::rec_kernel", "drqn::grad_kernel")

# The scale of the second comparison's nets (chip_smoke.py:shrink_drqn's).
SHRINK = 0.05


def shrunk(carry) -> dict:
    """A copy of a host carry whose nets ``p`` and ``tp`` have each of
    their twelve leaves centred and scaled by ``SHRINK``, with Adam's
    moments at zero."""
    out = dict(carry)
    for k in ("p", "tp"):
        out[k] = carry[k].clone()
        for x in ref.views(out[k]):
            x.sub_(x.mean()).mul_(SHRINK)
    for k in ("m", "v"):
        out[k] = torch.zeros_like(carry[k])
    return out


@contextlib.contextmanager
def bf16_forwards():
    """Within the block the reference's forward products take bf16
    operands."""
    acc = ref._acc

    def acc_bf16(x, w):
        return acc(x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float())
    ref._acc = acc_bf16
    try:
        yield
    finally:
        ref._acc = acc


class Cell(TrainCell):
    reference_module = ref
    learner_kernels = LEARNER_KERNELS

    @property
    def L(self) -> int:
        return int(self.traffic["seq_len"])

    def hyper(self) -> dict:
        c = self.config
        return dict(lr=c["lr"], gamma=c["gamma"], epsilon=c["epsilon"],
                    target_sync=c["target_sync"], obs_dim=c["obs_dim"],
                    num_actions=c["num_actions"], seq_len=self.L,
                    burn_in=int(self.traffic["burn_in"]),
                    opponent=self.traffic["opponent"],
                    memory_capacity=self.R * self.n)

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        last = self.last
        self.start = shrunk(self.before_b)
        self.shrunk = self._shrunk_steps()
        self.last = last   # the notes report the timed path's last chunk

    def _first_steps(self, carry) -> dict:
        self.max_first_calls = self.R * self.L + self.k + 8
        return super()._first_steps(carry)

    def _shrunk_steps(self) -> dict:
        """The second comparison's calls from ``self.start`` with the
        current chunk function: ``_first_steps``' record, and the params
        after the chunk that follows."""
        run = self._first_steps(to_device(self.start, self.device))
        carry = self._chunk(run.pop("carry"),
                            int(self.traffic["shrunk_steps"]))
        run["after"] = host(carry["p"])
        return run

    def check(self) -> dict:
        numbers = super().check()
        _, chunk = self.reference()
        fn, self._chunk_fn = self._chunk_fn, chunk
        try:
            want = self._shrunk_steps()
        finally:
            self._chunk_fn = fn
        got = self.shrunk
        g_p, g_r = ([x / (1.0 - self.ADAM_B1) for x in self.leaves(r["m1"])]
                    for r in (got, want))
        numbers.update(
            shrunk_loss_gap=max(compare.rel_gap(a, r) for a, r in
                                zip(got["losses"], want["losses"])),
            shrunk_grad1_gap=compare.worst_leaf(g_p, g_r),
            shrunk_change_gap=compare.worst_leaf(
                self.delta(got["after"], got["p0"]),
                self.delta(want["after"], want["p0"]), compare.moving(g_r)))
        return numbers

    def port(self, control):
        if control == "bfloat16":
            init, chunk = self.reference()

            def chunk_bf16(c, steps, seed):
                with bf16_forwards():
                    return chunk(c, steps, seed)
            return init, chunk_bf16
        from merging_gym_tpu_torch.agents.drqn import DRQNConfig
        from merging_gym_tpu_torch.core.env import EnvParams
        from merging_gym_tpu_torch.ops import fused_drqn as FD

        cfg, ep = DRQNConfig(**self.hyper()), EnvParams()
        return (lambda seed: FD.fused_drqn_init(
                    seed, cfg, ep, self.n, learn_batch=self.B,
                    device=self.device),
                lambda c, steps, seed: FD.fused_drqn_chunk(
                    cfg, ep, c, steps, seed))

    def reference(self):
        cfg, ep = SimpleNamespace(**self.hyper()), RefEnvParams()
        return (lambda seed: ref.fused_drqn_init(
                    seed, cfg, ep, self.n, learn_batch=self.B,
                    device=self.device),
                lambda c, steps, seed: ref.fused_drqn_chunk_plain(
                    cfg, ep, c, steps, seed))

    def leaves(self, flat) -> list:
        return ref.views(flat)

    # Counts for the metric readers (reference/counts_drqn.py).

    def seats(self) -> int:
        return 2 if self.traffic["opponent"] == "selfplay" else 1

    def model_flops_per_call(self) -> float:
        """The recurrent act forward of every env-step and one learn per
        step: every step of a warm chunk learns."""
        return self.T * (self.n * self.seats() * counts_drqn.forward_flops()
                         + counts_drqn.learn_flops(self.B, self.L))

    def learn_bound_s(self) -> float:
        return counts_drqn.learn_bound_ms(self.B, self.L) / 1e3
