"""Lane geometry and collision predicate on batched tensors.

Counterpart of ``merging_gym_tpu/core/geometry.py``.  Both vehicles have
yaw 0, so the reference's polygon test reduces to an axis-aligned box
overlap on centres rounded half away from zero (pygame's ``Rect``), with
touching counted as overlap (shapely's ``intersects``).

Divisions by a constant go through a 0-d tensor on the operand's device:
PyTorch's CUDA division by a Python scalar multiplies by the reciprocal,
which is one ulp off the true quotient for a third of inputs; the CUDA
kernels (``kernels/csrc/env_math.cuh``) divide exactly, and the plain
versions must agree with them bit for bit.
"""

import torch

from merging_gym_tpu_torch.core import constants as C


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded once, on the CPU and on the card alike."""
    return x / x.new_full((), c)


def lon2coord(lon: torch.Tensor, side: float):
    """Longitudinal arc position -> (x, y) screen coordinates.

    ``side`` is +1 for player 1 (right arc) and -1 for player 2 (mirrored
    left arc).  Uses the versine form ``R - R*cos(a) == 2*R*sin(a/2)**2``
    (``merging_gym_tpu/core/geometry.py:24-40``), which keeps f32 free of
    the cancellation of the direct form.
    """
    angle = C.ANGLE0 - true_div(lon, C.R)
    x = C.R * torch.sin(angle)
    half = 0.5 * angle
    versine = 2.0 * C.R * torch.sin(half) * torch.sin(half)
    y = C.W / 2 + side * versine
    return x, y


def round_half_away(v: torch.Tensor) -> torch.Tensor:
    """Round half away from zero, as pygame's ``Rect`` centre does.

    ``torch.round`` rounds half to even, so it is not used here.
    """
    return torch.sign(v) * torch.floor(torch.abs(v) + 0.5)


def is_collided(x1, y1, x2, y2) -> torch.Tensor:
    """Touch-inclusive overlap of the 4 (lateral) x 8 (longitudinal)
    vehicle boxes centred at the rounded coordinates."""
    cx1, cy1 = round_half_away(x1), round_half_away(y1)
    cx2, cy2 = round_half_away(x2), round_half_away(y2)
    lon_hit = torch.abs(cx1 - cx2) <= C.VEHICLE_H
    lat_hit = torch.abs(cy1 - cy2) <= C.VEHICLE_W
    return lon_hit & lat_hit
