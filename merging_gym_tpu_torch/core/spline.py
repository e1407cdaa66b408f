"""Polynomial x/y trajectory spline fit via equality-constrained QP.

Counterpart of ``merging_gym_tpu/core/spline.py`` and of the reference's
``spline5`` planner (scripts/helper.py:10-150): fit cubic polynomials
x(t), y(t) (order 3 despite the "5" in the name) to waypoint sequences by
least squares with a 0.01 ridge, under equality constraints pinning the
initial position, optionally the initial velocity, and optionally the
initial yaw (tan(yaw) * vx - vy = 0).  Only the reference's ``__main__``
demo exercises it (helper.py:205-217); no env or agent calls it.  The QP
is an explicit KKT solve (``core.control.eq_qp``), so autograd flows
through the waypoints.
"""

from __future__ import annotations

import math

import torch

from merging_gym_tpu_torch.core.control import eq_qp
from merging_gym_tpu_torch.device import tensor_device

ORDER = 3  # helper.py:19


def fit(xs, ys, ts=None, vx=None, vy=None, yaw=None, device=None):
    """Fit the spline; returns the (2*(ORDER+1),) coefficient vector
    [x-coeffs, y-coeffs] in normalised time t/T (helper.py:25-104).

    Runs on ``xs``'s device if it is a tensor, else on ``device`` (default
    ``cuda``); in f64 where ``xs`` is f64, else in f32 (so Python lists fit
    in f32, as in the JAX package without x64).
    """
    dev = tensor_device(xs, device)
    xs = torch.as_tensor(xs, device=dev)
    dtype = torch.float64 if xs.dtype == torch.float64 else torch.float32
    xs = xs.to(dtype)
    ys = torch.as_tensor(ys, device=dev).to(dtype)
    n = xs.shape[0]
    ts = (torch.arange(n, dtype=dtype, device=dev) if ts is None
          else torch.as_tensor(ts, device=dev).to(dtype))
    tau = ts / torch.max(ts)

    ncoef = ORDER + 1
    powers = tau[:, None] ** torch.arange(ncoef, dtype=dtype, device=dev)
    p = torch.block_diag(powers, powers)
    q_target = torch.cat([xs, ys])

    eye = torch.eye(2 * ncoef, dtype=dtype, device=dev)
    P = p.T @ p + 0.01 * eye                                   # helper.py:73
    q = -(q_target @ p)

    def scalar(v):
        return torch.as_tensor(v, device=dev).to(dtype)

    # Equality rows (helper.py:78-98): initial x, initial y, then
    # optionally vx, vy, yaw.
    rows = [eye[0], eye[ncoef]]
    rhs = [xs[0], ys[0]]
    if vx is not None and vy is not None:
        rows += [eye[1], eye[1 + ncoef]]
        rhs += [scalar(vx), scalar(vy)]
    if yaw is not None:
        rows.append(math.tan(yaw) * eye[1] - eye[1 + ncoef])
        rhs.append(scalar(0.0))
    return eq_qp(P, q, torch.stack(rows), torch.stack(rhs))


def evaluate(coeffs, t):
    """Position and velocity at normalised time t in [0, 1]
    (helper.py:108-129).  Outside [0, 1] everything is 0, matching the
    reference's guard."""
    ncoef = ORDER + 1
    t = torch.as_tensor(t, dtype=coeffs.dtype, device=coeffs.device)
    k = torch.arange(ncoef, dtype=coeffs.dtype, device=coeffs.device)
    powers = t[..., None] ** k
    dpowers = k * torch.where(k > 0, t[..., None] ** torch.clamp_min(k - 1, 0),
                              0.0)
    cx, cy = coeffs[:ncoef], coeffs[ncoef:]
    inside = (t >= 0) & (t <= 1)
    zero = coeffs.new_zeros(())
    x = torch.where(inside, powers @ cx, zero)
    y = torch.where(inside, powers @ cy, zero)
    dx = torch.where(inside, dpowers @ cx, zero)
    dy = torch.where(inside, dpowers @ cy, zero)
    return x, y, dx, dy
