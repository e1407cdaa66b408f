"""Operation and byte counts of K9, the fused DRQN trainer, counted from
shapes: the yardstick of the DRQN cell's roofline and ``mfu`` metrics.

The net (``reference/drqn.py``): fc1 10 -> 200 (ReLU), fc2 200 -> 16, an
LSTM cell 16 -> 16 (64 gate columns, gate order i, f, g, o), fc3 16 -> 16
(ReLU), fc4 16 -> 5; 7,949 f32 parameters.  A learn takes B windows of L
steps and one bootstrap observation.

Counted per learn, whatever the data: both nets' fc1, fc2 and LSTM cells
over all L + 1 steps of every window, from zero state; both nets' heads
(fc3, fc4) over all L + 1 steps; the mask and the TD math per step; the
eval net's backward through all L steps (the heads for the taken action,
the cell, the input side) with every gradient product; Adam over every
parameter.  Bytes per learn: the B windows read from the ring (all 16
rows of each of the L + 1 slots) and 28 B a parameter (p, target, m, v
read; p, m, v written).

``chip_smoke.py:drqn_learn_flops`` counts differently: only the valid
steps of the windows actually sampled (past burn-in, up to the first
done; a window without one adds no backward), the first step's cell
without its w_hh product and forget gate, the heads only where the loss
reads them.  Its count moves with where the episodes in the sampled
windows end; this one reads the same work on any data and any program,
and is the larger of the two by the steps that function leaves out.
"""

from __future__ import annotations

from perfbench.reference import counts

IN_DIM, H1, HID, A = 10, 200, 16, 5
G = 4 * HID            # gate columns
P = 7949               # parameters (fc1 2,200, fc2 3,216, LSTM 2,176, fc3
#                        272, fc4 85)
SLOT = 16              # f32 rows a window slot holds in the ring
ENV_ROWS = 11 + 4 * HID  # 75 env rows a lane (the h and c of both seats)

FC12 = (2 * IN_DIM * H1 + H1 + H1) + (2 * H1 * HID + HID)
CELL = 2 * (HID * G + HID * G) + 3 * G + HID * (3 * 4 + 2 + 3 + 1)
HEADS = (2 * HID * HID + HID + HID) + (2 * HID * A + A)


def forward_flops() -> int:
    """One row of the recurrent forward (the act kernel): fc1 and fc2
    (multiply-adds, bias adds, fc1's ReLU), both gate products and their
    three adds, per unit three sigmoids (4 each: negate, exp, add, divide),
    two tanh, the cell (3) and h (1), fc3 with its ReLU and fc4, and the
    argmax."""
    return FC12 + CELL + HEADS + A


def learn_flops(B: int, L: int) -> int:
    """One learn of B windows of L steps, Adam left out (see the module's
    docstring).  Per window: both nets' forward over L + 1 steps; the mask
    (3 a step) and the TD math (13 a step: the argmax 5, the target 4, the
    diff, the scale, the square and the loss sum); per step t < L the head
    backward for the taken action (fc4's row 2 x 16 + 1, dz3 with its mask
    32, dh through w3 2 x 16 x 16, the w3 and b3 gradients 2 x 16 x 16 +
    16, w4's and b4's at the action 2 x 16 + 1), the cell backward (22 a
    unit), dh through w_hh and dx2 through w_ih (2 x 64 x 16 each), dz1
    through w2 with its mask (2 x 16 x 200 + 200), and the gradient
    products of fc1, fc2, w_ih, b_ih and w_hh (b_hh's equals b_ih's)."""
    fwd = 2 * (L + 1) * (FC12 + CELL + HEADS)
    td = (3 + 13) * L
    head_back = (2 * HID + 1) + 2 * HID + 2 * HID * HID + (
        2 * HID * HID + HID) + (2 * HID + 1)
    grads = (2 * IN_DIM * H1 + H1) + (2 * H1 * HID + HID) + (
        2 * HID * G + G) + 2 * HID * G
    cell_back = (HID * 22 + 2 * G * HID + 2 * G * HID
                 + (2 * HID * H1 + H1) + grads)
    return B * (fwd + td + L * (head_back + cell_back)) + 3


def learn_bytes(B: int, L: int) -> int:
    """One learn: the B windows read from the ring, and 28 B a
    parameter."""
    return B * (L + 1) * SLOT * 4 + 28 * P


def learn_bound_ms(B: int, L: int) -> float:
    """The least time of one learn with Adam at the card's peaks (ms)."""
    return counts.bound(learn_bytes(B, L),
                        learn_flops(B, L) + P * counts.ADAM_FLOPS)[0]


def step_flops(n_envs: int, B: int, L: int, seats: int = 1) -> int:
    """One warm K9 step: the recurrent forward of every seat that plays a
    net, the env step and the observation per env, one learn, Adam."""
    return (n_envs * (seats * forward_flops() + counts.ENV_STEP_FLOPS
                      + counts.OBS_FLOPS)
            + learn_flops(B, L) + P * counts.ADAM_FLOPS)


def step_bytes(n_envs: int, B: int, L: int) -> float:
    """One warm K9 step: env rows read and written, the metrics, the
    window slot written, the flush (a window read and a ring round
    written) once every L steps, the learn's bytes."""
    wf = (L + 1) * SLOT
    return (n_envs * (2 * ENV_ROWS + 2 * 4 + SLOT) * 4
            + n_envs * 2 * wf * 4 / L + learn_bytes(B, L))


def step_bound_ms(n_envs: int, B: int, L: int, seats: int = 1) -> tuple:
    """``(ms, "bytes" or "operations")`` of one warm K9 step."""
    return counts.bound(step_bytes(n_envs, B, L),
                        step_flops(n_envs, B, L, seats))
