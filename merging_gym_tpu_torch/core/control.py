"""Longitudinal control law: the closed form of the reference's per-step QP.

Counterpart of ``merging_gym_tpu/core/control.py:action_to_acc``.  The
reference's 10-variable equality-constrained QP has the constant sequence
``u_i = (vt - v0) / t`` as its exact minimiser, so the applied action is
``(target_velocity - v) / prediction_t``.
"""

from merging_gym_tpu_torch.core import constants as C
from merging_gym_tpu_torch.core.geometry import true_div


def action_to_acc(vel, target_vel):
    """Closed-form acceleration for a target-velocity action (true division,
    as the kernels compute it)."""
    return true_div(target_vel - vel, C.PREDICTION_T)
