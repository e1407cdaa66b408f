"""K8, the fused Rainbow trainer (``ops.fused_rainbow``), as ``cli.py
train --algo rainbow --fused-kernel`` drives it: ``fused_rainbow_init``,
then back-to-back ``fused_rainbow_chunk`` calls, each followed by the
read-back of the carry's counters.  Set-up and the comparison with the
reference are those of ``perfbench/training.py``; the reference is the
frozen plain K8 in ``reference/rainbow.py``.

The Rainbow trainer has no lower-precision path of its own, so
``control="bfloat16"`` puts the reference in the program's place with
every dense layer's operands rounded to bf16 (sums in f32): the control
that the comparison must fail.
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import torch

from perfbench.reference import counts
from perfbench.reference import rainbow as ref
from perfbench.reference.env import EnvParams as RefEnvParams
from perfbench.training import TrainCell

LEARNER_KERNELS = ("learn_fwd_kernel", "learn_grad_kernel")


@contextlib.contextmanager
def bf16_forwards():
    """Within the block the reference's dense layers take bf16 operands."""
    dense = ref._dense

    def dense_bf16(x, w, b, relu):
        return dense(x.to(torch.bfloat16).float(),
                     w.to(torch.bfloat16).float(), b, relu)
    ref._dense = dense_bf16
    try:
        yield
    finally:
        ref._dense = dense


class Cell(TrainCell):
    reference_module = ref
    learner_kernels = LEARNER_KERNELS

    def hyper(self) -> dict:
        c = self.config
        return dict(lr=c["lr"], gamma=c["gamma"], epsilon=c["epsilon"],
                    obs_scale=c["obs_scale"], n_step=c["n_step"],
                    per=c["per"], per_alpha=c["per_alpha"],
                    per_beta=c["per_beta"], batch_size=c["batch_size"],
                    target_sync_episodes=c["target_sync_episodes"],
                    opponent_roll=c["opponent_roll"],
                    faithful_c51=c["faithful_c51"], num_atoms=c["num_atoms"],
                    num_actions=c["num_actions"], obs_dim=c["obs_dim"],
                    opponent=self.traffic["opponent"],
                    memory_capacity=self.R * self.n)

    def port(self, control):
        if control == "bfloat16":
            init, chunk = self.reference()

            def chunk_bf16(c, steps, seed):
                with bf16_forwards():
                    return chunk(c, steps, seed)
            return init, chunk_bf16
        from merging_gym_tpu_torch.agents.rainbow import RainbowConfig
        from merging_gym_tpu_torch.core.env import EnvParams
        from merging_gym_tpu_torch.ops import fused_rainbow as FRB

        cfg, ep = RainbowConfig(**self.hyper()), EnvParams()
        return (lambda seed: FRB.fused_rainbow_init(
                    seed, cfg, ep, self.n, learn_batch=self.B,
                    device=self.device),
                lambda c, steps, seed: FRB.fused_rainbow_chunk(
                    cfg, ep, c, steps, seed))

    def reference(self):
        cfg, ep = SimpleNamespace(**self.hyper()), RefEnvParams()
        return (lambda seed: ref.fused_rainbow_init(
                    seed, cfg, ep, self.n, learn_batch=self.B,
                    device=self.device),
                lambda c, steps, seed: ref.fused_rainbow_chunk_plain(
                    cfg, ep, c, steps, seed))

    def leaves(self, flat) -> list:
        return [x for layer in ref.flat_to_params(flat).values()
                for x in layer.values()]

    # Counts for the metric readers (reference/counts.py).

    def seats(self) -> int:
        return 2 if self.traffic["opponent"] == "selfplay" else 1

    def model_flops_per_call(self) -> float:
        """Act forwards of every env-step and the learner per sampled
        lane: every step of a warm chunk learns."""
        return self.T * (self.n * self.seats() * counts.rb_forward_flops()
                         + self.B * counts.rb_learn_flops())

    def learn_bound_s(self) -> float:
        flops = (self.B * counts.rb_learn_flops()
                 + counts.RB_PARAMS * counts.ADAM_FLOPS + counts.RB_ELEMS)
        return counts.bound(self.B * 24 * 4 + 28 * counts.RB_PARAMS,
                            flops)[0] / 1e3
