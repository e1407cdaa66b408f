"""Faults planted underneath the timed path: what the comparison must
catch.  Each is planted, for the length of a ``with`` block, in a module
that holds the plain arithmetic of a trainer: the port's own plain version
(``ops.fused_trainer``, ``ops.fused_rainbow``, which the CPU runs) in the
checks' tests, or the frozen reference (``reference/dqn.py``,
``reference/rainbow.py``) put in the program's place for a reading on the
card.

``half_batch``
    the learner sees the first half of its sampled lanes and takes its
    mean over them;
``altered_action``
    the action of env 0 is altered where the actor produces it (K5: the
    pick; K8: the E[Z] scores it is picked from).
"""

from __future__ import annotations

import contextlib

KINDS = ("half_batch", "altered_action")


def _half_last(x):
    return x[..., : x.shape[-1] // 2]


def _half_first(x):
    return x[: x.shape[0] // 2]


@contextlib.contextmanager
def planted(kind: str, module):
    """Within the block, ``module`` computes with the fault ``kind``."""
    saved = {}

    def patch(name, fn):
        saved[name] = getattr(module, name)
        setattr(module, name, fn)

    k5 = not hasattr(module, "rb_q")   # K8 picks from E[Z] scores
    if kind == "half_batch" and k5:
        learn_math = module.learn_math
        patch("learn_math", lambda p, tp, m, v, batch, t, **kw: learn_math(
            p, tp, m, v, {k: _half_last(x) for k, x in batch.items()}, t,
            **kw))
    elif kind == "half_batch":
        grads = module._grads_plain
        patch("_grads_plain", lambda p, tp, wp, wt, batch, weights, **kw:
              grads(p, tp, wp, wt, {k: _half_first(x) for k, x in
                                    batch.items()},
                    None if weights is None else _half_first(weights), **kw))
    elif kind == "altered_action" and k5:
        select = module.select

        def altered(q, *args):
            a = select(q, *args).clone()
            a[0] = (a[0] + 1) % q.shape[-1]
            return a
        patch("select", altered)
    elif kind == "altered_action":
        rb_q = module.rb_q

        def raised(dist):
            q = rb_q(dist).clone()
            q[0, (int(q[0].argmax()) + 1) % q.shape[-1]] += 100.0
            return q
        patch("rb_q", raised)
    else:
        raise ValueError(f"unknown fault {kind!r} (one of {KINDS})")
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)
