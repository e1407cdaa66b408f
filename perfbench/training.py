"""What the fused trainers' cells (``paths/fused_dqn.py``,
``paths/fused_rainbow.py``) share: the set-up that drives the program from
the seed through its first steps, the window's call, and the comparison
with the plain reference.

Set-up builds one carry and hands that same carry to the window:

1. ``*_init`` from the seed;
2. one-step calls of the window's own chunk function, through the ring's
   warm-up and ``first_learns`` learning steps (each learns on rows of
   its own: a fresh (round, lane-window) draw of a ring that every step
   rewrites);
3. chunk A of ``chunk_steps`` steps, the window's call and feed;
4. chunk B, the same.

Every call is followed by the read-back that ``cli.py:cmd_train`` makes
after each chunk (its ``_fused_scalars``).  The seed of a call is the run
seed plus the carry's step count, as ``cmd_train`` passes it.

The reference then (after the window, with the program's state freed)
follows steps 1-2 from the seed, and chunk B from the program's state
after chunk A: chunk B is where episodes first end, the auto-resets run
and the target syncs; following it from the seed would take the
reference through chunk A as well.  Compared:

``loss_gap``
    the largest relative gap of the loss of each of the first learns;
``grad1_gap``
    the first gradient as Adam receives it, ``m / (1 - beta1)`` after one
    learn, by the worst leaf;
``change3_gap``
    the parameters' change over the first learns, by the worst leaf;
``chunk_change_gap``
    the parameters' change over chunk B, by the worst leaf;
``chunk_episode_gap``
    the episodes, collisions and wins that chunk B finished: the summed
    absolute gaps over the reference's episodes.
"""

from __future__ import annotations

import torch

from perfbench import compare, faults


def host(x):
    """A CPU copy of a tensor, a tuple of tensors or a carry dict."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, tuple):
        return tuple(host(t) for t in x)
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    return x


def to_device(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        return tuple(to_device(t, device) for t in x)
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    return x


def scalars(c) -> dict:
    """What ``cmd_train`` reads back after every chunk (the carry's host
    counters; the chunk itself has synchronised to make them)."""
    eps = max(c["episodes"], 1.0)
    return {"env_steps": c["env_steps"], "episodes": c["episodes"],
            "collision_rate": c["collisions"] / eps,
            "win_rate": c["wins"] / eps,
            "reward": c["sum_ep_reward"] / eps,
            "loss": c["last_loss"], "learns": c["learns"]}


EVENTS = ("episodes", "collisions", "wins")


class TrainCell:
    """A fused trainer's cell.  Subclasses give ``port(control)`` and
    ``reference()`` (each ``(init(seed), chunk(carry, steps, seed))``),
    ``reference_module``, ``leaves(flat_or_tuple)``, ``ADAM_B1`` and the
    counts.

    ``control``: None (the port), ``"bfloat16"`` (the lower-precision
    control, see the subclass), or ``"fault:<kind>"``: the reference put in
    the program's place with a fault of ``faults.py`` planted in it
    (``"fault:unchanged"``: a chunk that returns its carry unchanged)."""

    ADAM_B1 = 0.9   # both trainers' Adam (torch's default)

    def __init__(self, config, traffic, seed, device, control=None):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.control = seed, device, control
        self.n = int(traffic["num_envs"])
        self.B = int(traffic["learn_batch"])
        self.R = int(traffic["ring_rounds"])
        self.T = int(traffic["chunk_steps"])
        self.k = int(traffic["first_learns"])
        init, self._chunk_fn = self.program(control)
        self.max_first_calls = self.R + self.k + 8
        carry = init(seed)
        self.first = self._first_steps(carry)
        carry = self.first.pop("carry")
        carry = self._chunk(carry, self.T)                 # chunk A
        self.before_b = host(carry)
        carry = self._chunk(carry, self.T)                 # chunk B
        self.after_b = host({k: carry[k] for k in ("p", *EVENTS)})
        self.carry = carry

    def _chunk(self, carry, steps):
        carry = self._chunk_fn(carry, steps, self.seed + carry["steps"])
        self.last = scalars(carry)
        return carry

    def _first_steps(self, carry) -> dict:
        """One-step calls until ``k`` learns: the losses, Adam's first
        moment after the first learn, the params before and after."""
        p0, losses, m1 = host(carry["p"]), [], None
        for _ in range(self.max_first_calls):
            if len(losses) == self.k:
                break
            learned = carry["learns"]
            carry = self._chunk(carry, 1)
            if carry["learns"] > learned:
                losses.append(carry["last_loss"])
                if m1 is None:
                    m1 = host(carry["m"])
        losses += [float("nan")] * (self.k - len(losses))  # never learned
        return {"p0": p0, "losses": losses,
                "m1": host(carry["m"]) if m1 is None else m1,
                "pk": host(carry["p"]), "carry": carry}

    def program(self, control):
        if not (control or "").startswith("fault:"):
            return self.port(control)
        kind = control[len("fault:"):]
        init, chunk = self.reference()
        if kind == "unchanged":
            return init, lambda c, steps, seed: c

        def faulty(c, steps, seed):
            with faults.planted(kind, self.reference_module):
                return chunk(c, steps, seed)
        return init, faulty

    def call(self) -> int:
        self.carry = self._chunk(self.carry, self.T)
        return self.T * self.n

    def release(self):
        self.carry = None

    def check(self) -> dict:
        init, chunk = self.reference()
        fn, self._chunk_fn = self._chunk_fn, chunk
        try:
            ref = self._first_steps(init(self.seed))
            ref.pop("carry")
            b = self._chunk(to_device(self.before_b, self.device), self.T)
        finally:
            self._chunk_fn = fn
        prog = self.first
        lv = self.leaves
        g_p = [x / (1.0 - self.ADAM_B1) for x in lv(prog["m1"])]
        g_r = [x / (1.0 - self.ADAM_B1) for x in lv(ref["m1"])]
        keep = compare.moving(g_r)
        a_p = self.before_b["p"]
        rb = host(b["p"])
        events = sum(abs((self.after_b[k] - self.before_b[k])
                         - (b[k] - self.before_b[k])) for k in EVENTS)
        return {
            "loss_gap": max(compare.rel_gap(a, r) for a, r in
                            zip(prog["losses"], ref["losses"])),
            "grad1_gap": compare.worst_leaf(g_p, g_r),
            "change3_gap": compare.worst_leaf(
                self.delta(prog["pk"], prog["p0"]),
                self.delta(ref["pk"], ref["p0"]), keep),
            "chunk_change_gap": compare.worst_leaf(
                self.delta(self.after_b["p"], a_p), self.delta(rb, a_p),
                keep),
            "chunk_episode_gap": events / max(
                b["episodes"] - self.before_b["episodes"], 1.0),
        }

    def delta(self, after, before) -> list:
        return [a - b for a, b in zip(self.leaves(after), self.leaves(before))]

    def notes(self, run) -> dict:
        """Printed on standard error: what the set-up's chunks finished."""
        return {"first_losses": self.first["losses"],
                "chunk_b_episodes": self.after_b["episodes"]
                - self.before_b["episodes"], "last_chunk": self.last}
