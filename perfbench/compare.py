"""The numbers that decide ``correct``, worked out from the program's
outputs and the reference's.

Training is judged by the worst leaf: per parameter leaf, the gap between
the norm of the program's tensor and the norm of the reference's, over the
larger of the reference leaf's norm and the median leaf's norm (a leaf
whose gradient is all but zero would otherwise read any round-off as a
large share).  Leaves whose reference gradient is under a thousandth of the
median leaf's move under Adam by round-off alone and are left out of a
change, by that rule and not by name.
"""

from __future__ import annotations

import statistics

import torch

QUIET = 1e-3   # a leaf's gradient under this share of the median leaf's


def norms(leaves) -> list:
    return [float(torch.linalg.vector_norm(x.double().cpu())) for x in leaves]


def moving(ref_grad_leaves) -> list:
    """Per leaf: does the reference's gradient move it (see QUIET)?"""
    g = norms(ref_grad_leaves)
    med = statistics.median(g)
    return [x >= QUIET * med for x in g]


def worst_leaf(prog_leaves, ref_leaves, keep=None) -> float:
    """max over kept leaves of | |p| - |r| | / max(|r|, median |r|)."""
    p, r = norms(prog_leaves), norms(ref_leaves)
    keep = keep or [True] * len(r)
    med = statistics.median([x for x, k in zip(r, keep) if k])
    return max(abs(a - b) / max(b, med, 1e-30)
               for a, b, k in zip(p, r, keep) if k)


def rel_gap(prog: float, ref: float) -> float:
    return abs(prog - ref) / max(abs(ref), 1e-30)
