"""Longitudinal control law: the closed form of the reference's per-step QP.

Counterpart of ``merging_gym_tpu/core/control.py``.  The reference solves
a 10-variable equality-constrained QP with quadprog on every env step
(scripts/helper.py:152-191):

    min_u  sum_i (u_{i+1} - u_i)^2 + 0.01 ||u||^2
    s.t.   dt * sum_i u_i = vt - v0

Its exact minimiser is the constant sequence ``u_i = (vt - v0) / t``, so
the applied action is ``(target_velocity - v) / prediction_t``
(:func:`action_to_acc`).  :func:`eq_qp` is a dense equality-constrained QP
solver (the KKT system through ``torch.linalg.solve``) kept as the
fidelity reference: :func:`mpc_1d_qp` builds the reference QP and the
tests hold it to the analytic law at f64 round-off.  Both are
differentiable through autograd.
"""

import torch

from merging_gym_tpu_torch.core import constants as C
from merging_gym_tpu_torch.core.geometry import true_div
from merging_gym_tpu_torch.device import resolve_device, tensor_device


def action_to_acc(vel, target_vel):
    """Closed-form acceleration for a target-velocity action (true division,
    as the kernels compute it)."""
    return true_div(target_vel - vel, C.PREDICTION_T)


def eq_qp(P, q, A, b):
    """Solve  min 1/2 u'Pu + q'u  s.t.  Au = b  via the KKT system.

    Dense and differentiable; runs on ``P``'s device and in its dtype (an
    array that is not a tensor goes to ``cuda``, as every entry point's
    default).  ``A`` may be 1-D (a single constraint row) or 2-D.  Returns
    the primal solution ``u``.
    """
    dev = tensor_device(P)
    P = torch.as_tensor(P, device=dev)
    q, A, b = (torch.as_tensor(v, dtype=P.dtype, device=dev)
               for v in (q, A, b))
    A = torch.atleast_2d(A)
    b = torch.atleast_1d(b)
    n, m = P.shape[0], A.shape[0]
    kkt = torch.cat([torch.cat([P, A.T], 1),
                     torch.cat([A, P.new_zeros((m, m))], 1)], 0)
    rhs = torch.cat([-q, b])
    return torch.linalg.solve(kkt, rhs)[:n]


def mpc_1d_qp(v0, vt, t=C.PREDICTION_T, horizon=10, device=None):
    """Numerically solve the reference MPC QP (helper.py:152-191) in f64 on
    ``device`` (default ``cuda``).

    Builds the same smoothness-plus-ridge objective and the same
    terminal-velocity equality row, then solves the KKT system.  Returns
    the full control sequence ``u``; ``u[0]`` is the applied acceleration.
    Exists for parity testing against :func:`action_to_acc`.
    """
    dev, dtype = resolve_device(device), torch.float64
    dt = t / horizon
    eye = torch.eye(horizon, dtype=dtype, device=dev)
    d = eye[:-1] - eye[1:]
    P = d.T @ d + 0.01 * eye
    q = torch.zeros(horizon, dtype=dtype, device=dev)
    A = torch.full((1, horizon), dt, dtype=dtype, device=dev)
    b = torch.atleast_1d(torch.as_tensor(vt - v0, dtype=dtype, device=dev))
    return eq_qp(P, q, A, b)
