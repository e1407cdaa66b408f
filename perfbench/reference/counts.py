"""Operation and byte counts of the port's kernels, and the H100's peaks.

Frozen copy of ``chip_smoke.py``'s counts at commit 79f5ae92604b (what each
function needs, counted from shapes, not what a kernel happens to do),
with the whole-step counts of K5 and K8 that ``chip_smoke.py`` forms
inline.  A later change to the program cannot move these numbers: they
are the yardstick of every roofline and ``mfu`` metric.
"""

# Published H100 SXM peaks at the full 700 W (NVIDIA H100 datasheet).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12   # f32 outside the tensor cores

# f32 operations of one env step (kernels/csrc/env_math.cuh), each sinf,
# floorf, compare and select counted as one operation, integer and Philox
# work not counted, so the bound is a lower bound: acceleration 6, velocity
# 6, position 4, penalty 8, crossing tests and bonuses 4, two lon2coord 22,
# four roundings 24, collision test 6, collision penalty 2.
ENV_STEP_FLOPS = 82
OBS_FLOPS = 8          # the 8 differences of the observation


def mlp_flops(d_in, h1, h2, a):
    """One row of the Q-net: multiply-adds, bias adds, ReLUs, argmax."""
    return 2 * (d_in * h1 + h1 * h2 + h2 * a) + (h1 + h2 + a) + (h1 + h2) + a


def learn_flops(d_in, h1, h2, a):
    """One sampled lane of K5's learner, at what the function needs: the
    online forward on x' in full (its argmax picks the action); the target
    forward on x' and the online one on x with the last layer at one
    action only (the argmax's, the taken one's); the TD math (mask,
    target, diff, dq, diff^2 and its sum); the backward with dq one-hot:
    dz2 = w2[:, a_i] dq (h2 products and the ReLU mask), dz1 = (w1 dz2)
    relu'; and the gradient products (2 per weight, 1 per bias; w2 and b2
    at the taken action's column only)."""
    hidden = 2 * (d_in * h1 + h1 * h2) + 2 * (h1 + h2)
    one_action = hidden + 2 * h2 + 1
    backward = 2 * h2 + (2 * h1 * h2 + h1) + (
        2 * (d_in * h1 + h1 * h2 + h2) + h1 + h2 + 1)
    return mlp_flops(d_in, h1, h2, a) + 2 * one_action + 8 + backward


ADAM_FLOPS = 14        # per parameter: two moments, bias-corrected update

# The Rainbow net of K8: trunk 10 -> 32 -> 64, noisy value 64 -> 64 -> 51,
# noisy advantage 64 -> 64 -> 5 x 51 (ranbowdqn.py:498-548).
RB_LAYERS = ((10, 32), (32, 64), (64, 64), (64, 51), (64, 64), (64, 255))
RB_MACS = sum(i * o for i, o in RB_LAYERS)              # 30,144
RB_OUTS = sum(o for _, o in RB_LAYERS)                  # 530
RB_ELEMS = 28210       # noisy elements of one net (w and b)
RB_PARAMS = 58884


def rb_trunk_flops():
    """The part of one row of the noisy dueling C51 forward that every
    use needs: multiply-adds, bias adds, ReLUs and the dueling mean (5 adds,
    1 multiply per atom)."""
    return 2 * RB_MACS + RB_OUTS + (32 + 64 + 64 + 64) + 6 * 51


def rb_forward_flops():
    """One row of the acting or target forward (kernels/csrc/
    rainbow_trainer.cu:rb_act_kernel): the trunk and streams, then for all
    five actions the dueling combine (2 per atom), the softmax (max,
    subtract, exp, sum, divide) and E[Z] (2 per atom)."""
    return rb_trunk_flops() + (2 + 5 + 2) * 5 * 51


def rb_learn_flops():
    """One sampled lane of K8's learner, at what the function needs: the
    1-step reconstruction; the target forward; the projection in scatter
    form (15 per atom: Tz, clamp, b, floor, ceil, the faithful mask, the
    support-weighted mass, two weights and two scatter adds); the online
    forward with the combine and softmax of the sampled action only and no
    E[Z]; the clamp, CE and its gradient; the dueling backward; the backward
    through the four noisy layers and the trunk; and the gradient products."""
    atoms, a = 51, 5
    online = rb_trunk_flops() + (2 + 5) * atoms
    back = (2 * 64 * atoms + 64 + 2 * 64 * a * atoms + 64 + 2 * 2 * 64 * 64
            + 64 + 2 * 32 * 64 + 32)
    return (25 + rb_forward_flops() + online + 15 * atoms
            + 12 * atoms + 3 * atoms + 2 * a * atoms + back
            + 2 * RB_MACS + RB_OUTS)


def bound(bytes_, flops):
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")




def dqn_step_flops(n_envs, batch, dims=(10, 200, 100, 5)):
    """One warm K5 step against L0: a forward, the env step and the
    observation per env, the learner per sampled lane, Adam per
    parameter."""
    P = qnet_params(dims)
    return (n_envs * (mlp_flops(*dims) + ENV_STEP_FLOPS + OBS_FLOPS)
            + batch * learn_flops(*dims) + P * ADAM_FLOPS)


def dqn_step_bytes(n_envs, batch, dims=(10, 200, 100, 5)):
    """One warm K5 step: env rows read and written, the ring slab, the
    learner's batch, and 28 B a parameter (p, target, m, v and the
    gradient)."""
    return (n_envs * (2 * 11 + 24 + 2 * 4) * 4 + batch * 24 * 4
            + 28 * qnet_params(dims))


def qnet_params(dims=(10, 200, 100, 5)):
    d_in, h1, h2, a = dims
    return d_in * h1 + h1 + h1 * h2 + h2 + h2 * a + a


def rainbow_step_flops(n_envs, batch):
    """One warm K8 step against L0 (1-step, uniform replay): a forward,
    the env step and the observation per env, the learner per sampled
    lane, Adam per parameter, the sigma products and both nets' effective
    weights."""
    return (n_envs * (rb_forward_flops() + ENV_STEP_FLOPS + OBS_FLOPS)
            + batch * rb_learn_flops() + RB_PARAMS * ADAM_FLOPS
            + RB_ELEMS + 2 * 2 * RB_ELEMS)


def rainbow_step_bytes(n_envs, batch, env_rows=14, num_f=24):
    return (n_envs * (2 * env_rows + num_f) * 4 + batch * num_f * 4
            + 28 * RB_PARAMS + 6 * 4 * 2 * RB_ELEMS)


def policy_flops(n_envs, steps, two_nets=True, dims=(10, 200, 100, 5)):
    """K6 over ``steps`` x ``n_envs``: one or two forwards, the env step
    and the observation per env-step."""
    nets = 2 if two_nets else 1
    return n_envs * steps * (nets * mlp_flops(*dims) + ENV_STEP_FLOPS
                             + OBS_FLOPS)


def policy_bytes(n_envs, steps):
    """K6's events written once: actions 2 x 4 B, rewards 2 x 4 B, done,
    winner and collision 3 x 4 B per env-step."""
    return n_envs * steps * (8 + 8 + 12)
