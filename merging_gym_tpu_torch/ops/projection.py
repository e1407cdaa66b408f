"""C51 categorical Bellman projection, the scatter form.

Counterpart of ``merging_gym_tpu/ops/projection.py`` and of the reference
``projection_distribution`` (scripts/ranbowdqn.py:554-582): the torch
``index_add_`` scatter over ``(batch, atoms)``.

Faithfulness note: the reference projects ``p_i * z_i`` -- the
support-weighted distribution it built for action selection -- instead
of the plain probabilities ``p_i`` of textbook C51, so its target sums to
E[Z], not 1; and where Tz lands exactly on an atom (floor == ceil) both
interpolation weights are 0 and that mass is lost.
``weight_by_support=True`` (default) reproduces both; ``False`` gives the
textbook projection, which conserves the mass on an exact atom hit.
"""

from __future__ import annotations

import torch


def categorical_projection(next_probs: torch.Tensor, rewards: torch.Tensor,
                           dones: torch.Tensor, support: torch.Tensor,
                           gamma: float = 0.99,
                           weight_by_support: bool = True) -> torch.Tensor:
    """Project the target distribution onto the fixed support.

    ``next_probs`` f[B, atoms]: the target net's softmax for the selected
    greedy action; ``rewards`` f[B]; ``dones`` f/bool[B]; ``support``
    f[atoms]; ``gamma`` 0.99, hard-coded in the reference
    (ranbowdqn.py:569).  Returns f[B, atoms].
    """
    num_atoms = support.shape[0]
    vmin, vmax = support[0], support[-1]
    delta_z = (vmax - vmin) / (num_atoms - 1)
    mass = next_probs * support if weight_by_support else next_probs
    dones = dones.to(next_probs.dtype)
    tz = rewards[:, None] + (1.0 - dones[:, None]) * gamma * support
    tz = torch.clamp(tz, vmin, vmax)
    b = (tz - vmin) / delta_z
    lo, hi = torch.floor(b), torch.ceil(b)
    lo_w, hi_w = hi - b, b - lo
    if not weight_by_support:
        lo_w = lo_w + (lo == hi).to(mass.dtype)
    proj = torch.zeros_like(mass)
    proj.scatter_add_(1, lo.to(torch.int64), mass * lo_w)
    proj.scatter_add_(1, hi.to(torch.int64), mass * hi_w)
    return proj
