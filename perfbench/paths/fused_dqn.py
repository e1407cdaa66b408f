"""K5, the fused Double-DQN trainer (``ops.fused_trainer``), as
``cli.py train --algo dqn --fused-kernel`` drives it: ``fused_dqn_init``,
then back-to-back ``fused_dqn_chunk`` calls, each followed by the
read-back of the carry's counters.  Set-up and the comparison with the
reference are those of ``perfbench/training.py``; the reference is the
frozen plain K5 in ``reference/dqn.py``.

``control="bfloat16"`` runs the program's own lower-precision path
(``compute_dtype="bfloat16"``: forwards and backward operands in bf16):
the control that the comparison must fail.
"""

from __future__ import annotations

from types import SimpleNamespace

from perfbench.reference import counts
from perfbench.reference import dqn as ref
from perfbench.reference.env import EnvParams as RefEnvParams
from perfbench.training import TrainCell

LEARNER_KERNELS = ("learn_fwd_kernel", "learn_grad_kernel")


class Cell(TrainCell):
    def hyper(self, control) -> dict:
        c = self.config
        return dict(lr=c["lr"], gamma=c["gamma"], epsilon=c["epsilon"],
                    target_sync=c["target_sync"], hidden=tuple(c["hidden"]),
                    obs_dim=c["obs_dim"], num_actions=c["num_actions"],
                    opponent=self.traffic["opponent"],
                    memory_capacity=self.R * self.n,
                    compute_dtype=control or c["dtype"])

    reference_module = ref

    def port(self, control):
        from merging_gym_tpu_torch.agents.dqn import DQNConfig
        from merging_gym_tpu_torch.core.env import EnvParams
        from merging_gym_tpu_torch.ops import fused_trainer as FT

        cfg, ep = DQNConfig(**self.hyper(control)), EnvParams()
        return (lambda seed: FT.fused_dqn_init(
                    seed, cfg, ep, self.n, learn_batch=self.B,
                    device=self.device),
                lambda c, steps, seed: FT.fused_dqn_chunk(
                    cfg, ep, c, steps, seed))

    def reference(self):
        cfg = SimpleNamespace(**self.hyper(None), mask_terminal=False)
        ep = RefEnvParams()
        return (lambda seed: ref.fused_dqn_init(
                    seed, cfg, ep, self.n, learn_batch=self.B,
                    device=self.device),
                lambda c, steps, seed: ref.fused_dqn_chunk_plain(
                    cfg, ep, c, steps, seed))

    def leaves(self, p) -> list:
        return list(p)

    # Counts for the metric readers (reference/counts.py).

    @property
    def dims(self) -> tuple:
        c = self.config
        return (c["obs_dim"], *c["hidden"], c["num_actions"])

    def seats(self) -> int:
        return 2 if self.traffic["opponent"] == "selfplay" else 1

    def model_flops_per_call(self) -> float:
        """Act forwards of every env-step and the learner's forward and
        backward per sampled lane: every step of a warm chunk learns."""
        return self.T * (self.n * self.seats() * counts.mlp_flops(*self.dims)
                         + self.B * counts.learn_flops(*self.dims))

    def learn_bound_s(self) -> float:
        P = counts.qnet_params(self.dims)
        flops = self.B * counts.learn_flops(*self.dims) + P * counts.ADAM_FLOPS
        return counts.bound(self.B * 24 * 4 + 28 * P, flops)[0] / 1e3

    learner_kernels = LEARNER_KERNELS
