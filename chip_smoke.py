#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one NVIDIA H100 and hold every kernel
against its plain PyTorch version.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each of which raises (non-zero exit) on failure:
  1. print the card (nvidia-smi) and build the CUDA kernels from
     ``merging_gym_tpu_torch/kernels/csrc`` (one nvcc per source, in parallel);
  2. run each kernel and its plain version on the same inputs on the card,
     at the main path's shapes, and compare at the JAX tests' tolerances
     (K1 and K2 bit for bit at the edges of their geometry, in both action
     sources and with 3-step episodes: ``check_k1_k2``; K6 bit for bit at
     each of its geometry choices: ``k6_cases``; K8's ``rb_post`` and
     ``rb_per_pick`` also alone, in every mode and layout:
     ``check_rb_post_pick``);
  3. the main paths, each with every launch count set to 0 just before
     it and read just after.  ``bench`` through the port's CLI: env-steps/s
     of K2 at 4,096 envs, six launches of 1,048,576 steps.  Evaluation: K1
     (``fused_rollout``, 512 steps at 4,096 envs), then ``eval
     --fused`` of model_zoo/L2 vs L1 at 4,096 envs x 2,600 steps (K6) and
     plain ``eval`` at 256 envs (K3 per step), through the port's CLI.
     Training, through the CLI at its defaults (1,024 envs, 200-step
     chunks): ``train --algo dqn --fused-kernel`` (K5), ``levelk --algo dqn
     --fused-kernel --levels 2``, ``eval --fused`` of the trained L2 vs L1
     (K6), and the step-loop ``train --algo dqn --opponent selfplay`` (K4
     for both seats, twice per step).  h-DQN training, through the CLI at
     its defaults: ``train --algo hdqn --fused-kernel`` (K7), ``levelk
     --algo hdqn --fused-kernel --levels 2``, the step-loop ``train --algo
     hdqn --opponent selfplay`` (K4 five times per step), and ``evaluate``
     of ``hdqn_policy`` L2 vs L1 on the trained nets (K3).  Rainbow
     training, through the CLI at its defaults: ``train --algo rainbow
     --fused-kernel`` (K8), the same with ``--per --n-step 3 --obs-scale
     0.01``, the step-loop ``train --algo rainbow --opponent selfplay``, and
     ``evaluate`` of ``rainbow_policy`` (model_zoo/RB_L0_FUSED and the
     trained net) against L0.  DRQN training, through the CLI at its
     defaults: ``train --algo drqn --fused-kernel`` (K9), the same against
     the trained net as a frozen opponent, the step-loop ``train --algo drqn
     --opponent selfplay``, and ``evaluate_drqn`` of the trained net against
     L0.  Resume (``resume_path``): for K5, K7, K8 (1-step and PER 3-step)
     and K9 at the CLI's defaults and the four step loops in self-play
     (20-step chunks; h-DQN's also with a goal ring of 2,048), run A (2
     chunks, a checkpoint after each), B (1
     chunk resumed from A) and C (3 chunks uninterrupted; twice for the
     step loops), B held against C bit for bit where two uninterrupted
     runs agree bit for bit; then ``eval --fused`` of model_zoo/L2 written
     as a reference ``.pth`` run directory, exactly equal to the same on
     its ``params.npz`` (``pth_path``).  Spmd (``parallel/``): under NCCL
     at one rank, the local-SGD chunks of K5, K7, K8 (uniform and PER
     3-step) and K9 (200 steps, random mode) and the (1, 1) DQN, Rainbow
     and DRQN step loops bit for bit against the single-chip trainers
     (``spmd_world_of_one``); then two gloo ranks spawned on the one card
     at 1,024 envs each: the chunks of K5, K7, K8 (PER 3-step) and K9
     (greedy, each rank's own streams) with each rank's lanes (and K8's
     noise) equal to its solo run and the averaged sets equal to the mean
     of the two solo runs, bit for bit, K8's running max priority the
     larger of the two, and a (1, 2) tensor-parallel DQN step loop whose
     replicated tensors agree and whose gradients equal the single-device
     ones at rtol 1e-5 (``spmd_world_of_two``); then the port's dryrun
     (``python -m merging_gym_tpu_torch.parallel.dryrun``) at two
     processes on the card (``dryrun_on_card``).  M16 (the ``m16`` line):
     ``play``'s learned opponents (model_zoo/L2 as a reference DQN run
     directory, HD_L1 as an h-DQN one, RB_L0 as a Rainbow ``eval.pth``,
     loaded on the card by ``ui.human.load_opponent``) through two full
     oracle episodes each, every K3 output of them (B = 1; 10->5, 10->3,
     11->5) bit for bit against the plain version, the median host time of
     a synchronised ``act`` (``play_opponents``); ``NativeMergeEnv`` at
     1,024 envs against a Phi-greedy L2 on the card (K3 at B 1,024) for
     500 steps, and the native core against the oracle bit for bit on one
     episode (``native_with_card_opponent``); ``mpc_1d_qp`` / ``eq_qp`` in
     f64 on the card (``control_on_card``); ``dump_batch_trajectories`` of
     a rollout on the card (``dump_on_card``); ``utils.debug.checked`` on
     CUDA tensors and a ``utils.profiling.trace`` naming K3's kernel
     (``utilities_on_card``, run after the path's counts are read: its
     launches stand under ``utils`` and not in K3's count); headless
     ``run_session``, ``GymnasiumMergeEnv`` and ``NativeVectorEnv`` with
     card opponents where pygame and gymnasium are installed
     (``ui_layers``); then K3 at
     B = 1 beside its bound and the ``addmm`` chain (``k3_b1_times``);
  4. greedy ``evaluate`` (K3) must equal greedy ``evaluate_fused`` (K6);
  5. time every kernel with CUDA events beside its plain version (K1 and
     K2 in both action sources and K2's 65,536-step launch:
     ``rollout_times``; and at each threads a block, a build for each:
     ``rollout_sweep``, the ``k1_k2`` line), the
     least time the card could take (``bound_ms``) and, for K3 and K4, the
     three ``torch.addmm`` + ReLU library calls (K4: and ``argmax``), also
     at each main-path batch (256, 1,024, 4,096; one call and the device
     time alone), and K3's device time at every rows-per-block choice;
     K8 and K9 per step and per 200-step chunk; one warm step of K5, K7,
     K8 and K9 split by kernel (device time of each launch, launches per
     step, one learn beside its bound, K5's and K7's act kernel beside its
     bound and the ``addmm`` chains of its forwards: the ``trainer_split``
     line), one learn of K5, K8 and K9 at each choice of their geometry,
     and one act launch of K5 and K7 at each envs a block and micro-tile
     (``act_geometry_sweep``, on the same line); K6 at
     every envs a block and micro-tile (``k6_geometry_sweep``) and ``eval
     --fused`` split by phase (``eval_fused_split``); K8's PER 3-step
     learning step split by kernel, ``rb_post`` and ``rb_per_pick`` beside
     their bounds, an empty kernel and the library's versions, and both
     alone by mode, batch and layout (``k8_post_pick_sweep``).
Prints one JSON line of per-kernel results, then, last,
``{"ok": true, "device": {...}}``.  Without CUDA it exits non-zero.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
ZOO_L1 = os.path.join(REPO, "model_zoo", "L1", "params.npz")
ZOO_L2 = os.path.join(REPO, "model_zoo", "L2", "params.npz")
ZOO_RB = os.path.join(REPO, "model_zoo", "RB_L0_FUSED", "params.npz")

N_ENVS = 4096          # bench.py's headline env count
T_ROLLOUT = 512        # K1/K2 check and timing length
T_COUNTERS_LONG = 65536  # K2 launch long enough to amortise launch cost
T_POLICY = 768         # K6 check and timing length: Phi-greedy L2 vs L1
                       # episodes last ~500 steps (the plain version is slow)
T_EVAL = 2600          # evaluate_fused's default length
B_MLP = 4096
B_RAGGED = 1001
B_TAIL = 1025          # one row past a K3/K4 block boundary
# K3 and K4 batches of the main paths: 256 (eval, evaluate(hdqn_policy)),
# 1,024 (the CLI's default eval, the step-loop actors) and 4,096
QNET_BATCHES = (256, 1024, 4096)
N_TRAIN = 1024         # the training CLI's default env count
N_TRAIN_WIDE = 4096
N_ENVS_HDQN = 256      # envs of the evaluate(hdqn_policy) main path
T_CHUNK = 200          # the training CLI's default chunk length
T_PLAIN = 6            # K5 plain-version timing length (steps)
T_PLAIN_K7 = 4         # K7 plain-version timing length (steps)
T_PLAIN_K8 = 4         # K8 plain-version timing length (steps)
T_PLAIN_K9 = 2         # K9 plain-version timing length (steps)
BIG = "1000000000"     # --episodes that never stops a run early

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

K5_COUNTS = ("dqn_act_env_store", "dqn_learn_fwd", "dqn_learn_grad")
K7_COUNTS = ("hdqn_act_env_store", "hdqn_learn_fwd_lower",
             "hdqn_learn_grad_lower", "hdqn_learn_fwd_upper",
             "hdqn_learn_grad_upper")
K8_COUNTS = ("rainbow_act", "rainbow_per_pick", "rainbow_learn_fwd",
             "rainbow_learn_grad", "rainbow_post")
K9_COUNTS = ("drqn_act", "drqn_learn_in", "drqn_learn_rec",
             "drqn_learn_grad")

# The resume phase: (label, train flags, scalar that counts learning).  The
# fused trainers at the CLI's defaults, the step loops in self-play with
# 20-step chunks.
RESUME_FUSED = (
    ("K5", ["--algo", "dqn", "--fused-kernel"], "learns"),
    ("K7", ["--algo", "hdqn", "--fused-kernel"], "lower_learns"),
    ("K8", ["--algo", "rainbow", "--fused-kernel"], "learns"),
    ("K8 PER 3-step", ["--algo", "rainbow", "--fused-kernel", "--per",
                       "--n-step", "3", "--obs-scale", "0.01"], "learns"),
    ("K9", ["--algo", "drqn", "--fused-kernel"], "learns"))
RESUME_LOOPS = tuple(
    (f"{algo} step loop{label}", ["--algo", algo, "--opponent", "selfplay",
                                  "--chunk-steps", "20", *extra], learned)
    for algo, label, extra, learned in (
        ("dqn", "", [], "learns"), ("hdqn", "", [], "loss"),
        # No slot of the goal ring written twice in a step: bit for bit.
        ("hdqn", ", goal memory 2048", ["--goal-memory-capacity", "2048"],
         "loss"),
        ("rainbow", "", [], "learns"), ("drqn", "", [], "learns")))
RESUME_ROW_KEYS = ("env_steps", "episodes", "collision_rate", "win_rate")
# A step loop whose two uninterrupted runs differ is held, B against C and
# C against C, to this largest |difference| of a parameter.  At the CLI's
# defaults the h-DQN step loop's goal ring (200 slots) takes up to 1,024
# options a step, so a step writes some slots several times, and on the
# card which write lands is not fixed (PERF.md §6 has the measured
# differences); over 3 chunks of 20 steps, ~58 lower learns at lr 0.01 can
# move a weight by ~0.6.
LOOP_RUN_TO_RUN_ATOL = 0.25

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


# The DRQN of K9 (nn/lstm.py): fc1 10 -> 200 (ReLU), fc2 200 -> 16, an LSTM
# 16 -> 16 (64 gate columns), fc3 16 -> 16 (ReLU), fc4 16 -> 5.
DRQN_P = 7949


def drqn_forward_flops():
    """One row of the recurrent forward (kernels/csrc/drqn_trainer.cu:
    act_kernel): multiply-adds, bias adds and ReLUs of fc1 and fc2, both gate
    products and their three bias / sum adds, per unit three sigmoids (4
    each: negate, exp, add, divide), two tanh, the cell (3) and h (1), fc3
    and fc4, and the argmax."""
    gates = 2 * (16 * 64 + 16 * 64) + 3 * 64
    tail = 16 * (3 * 4 + 2 + 3 + 1)
    return (2 * 10 * 200 + 400 + 2 * 200 * 16 + 16 + gates + tail
            + 2 * 16 * 16 + 32 + 2 * 16 * 5 + 5 + 5)


def drqn_valid(done, burn_in):
    """Per window (``done``: [..., L] done flags) the last valid step and
    the number of valid steps: past burn-in, up to the first done."""
    import numpy as np
    d = np.asarray(done) > 0
    L = d.shape[-1]
    first = np.where(d.any(axis=-1), d.argmax(axis=-1), L)
    last = np.minimum(first, L - 1)
    return last, np.maximum(last - burn_in + 1, 0)


def drqn_learn_flops(done, burn_in):
    """K9's learner on one batch of sampled windows, at what the function
    needs on this data.  ``done``: the windows' done flags, [windows, L].

    A step t is valid past burn-in up to the window's first done; only
    valid steps reach the loss, and a window without one adds nothing to
    the gradient.  For every window: its mask (3 per step: 1 - ended, the
    max, the count).  For a window whose last valid step is ``last``: both
    nets' fc1, fc2 and LSTM cells over t = 0 .. last + 1 (at t = 0, from
    zero state, no w_hh product and no forget gate); the eval net's fc3 at
    burn-in .. last + 1 and its fc4 there for all actions, but at burn-in
    for the taken action only; the target net's fc3 at burn-in + 1 ..
    last + 1 and its fc4 for the argmax action only; the TD math per valid
    step (argmax 5, target 4, diff, 2 / msum scale, square, loss sum); per
    valid step the head backward for the taken action only (dz3 with its
    ReLU mask, dh through w3) and the w3, b3, w4 and b4 gradients of that
    action; per step t <= last the cell backward (22 per unit; 17 at t = 0,
    where c_{-1} = 0), dh through w_hh (t >= 1), dx2 through w_ih, dz1
    through w2 with its mask, and the fc1, fc2, w_ih and b_ih gradients,
    the w_hh gradient at t >= 1 (b_hh's equals b_ih's).  Gradient products
    count 2 (multiply, add into the batch sum).  fc1's recomputation in
    the kernel is not counted."""
    import numpy as np
    L = np.shape(done)[-1]
    last, nv = drqn_valid(done, burn_in)
    fc12 = (2 * 10 * 200 + 200 + 200) + (2 * 200 * 16 + 16)
    cell = 2 * (16 * 64 + 16 * 64) + 3 * 64 + 16 * (3 * 4 + 2 + 3 + 1)
    cell0 = 2 * 16 * 48 + 2 * 48 + 16 * (2 * 4 + 2 + 1 + 1)
    fc3, fc4 = 2 * 16 * 16 + 16 + 16, 2 * 16 + 1   # fc4: per action
    fwd = 2 * ((last + 2) * fc12 + cell0 + (last + 1) * cell)
    heads = (nv + 1) * fc3 + fc4 + nv * 5 * fc4 + nv * (fc3 + fc4)
    head_back = (16 + 16) + 2 * 16 * 16 + 2 * 16 + 1 + 2 * 16 * 16 + 16
    grads = 2 * 10 * 200 + 200 + 2 * 200 * 16 + 16
    back_t = (16 * 22 + 2 * 64 * 16 + 2 * 64 * 16 + 2 * 16 * 200 + 200
              + grads + 2 * 16 * 64 + 64 + 2 * 16 * 64)
    back_0 = (16 * 17 + 2 * 48 * 16 + 2 * 16 * 200 + 200 + grads
              + 2 * 16 * 48 + 48)
    back = nv * head_back + 16 * (nv - 1) + back_0 + last * back_t
    per = np.where(nv > 0, fwd + heads + 13 * nv + back, 0) + 3 * L
    return int(per.sum()) + 3   # and once: max(msum, 1), 2 / msum, / msum


def bound(bytes_, flops):
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(torch, fn, reps, warmup=1):
    """Median over ``reps`` of one call, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(torch, fn, n=20, reps=10):
    """Device time of one call: ``n`` calls captured in a CUDA graph, the
    graph replayed ``reps`` times, median per call (no host time)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_ms(torch, graph.replay, reps) / n


class Checks:
    """Collects max |kernel - plain| per kernel and fails on disagreement."""

    def __init__(self, torch):
        self.torch = torch
        self.err = {}

    def close(self, kernel, what, got, want, rtol, atol):
        t = self.torch
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        err = diff.max().item() if diff.numel() else 0.0
        self.err[kernel] = max(self.err.get(kernel, 0.0), err)
        if not t.isfinite(got).all():
            raise AssertionError(f"{kernel} {what}: non-finite output")
        if not (diff <= atol + rtol * want.abs()).all():
            raise AssertionError(f"{kernel} {what}: max |diff| {err} above "
                                 f"rtol {rtol} atol {atol}")

    def equal(self, kernel, what, got, want):
        self.close(kernel, what, got, want, 0.0, 0.0)

    def events(self, kernel, what, got, want, keys, float_keys):
        for k in keys:
            self.equal(kernel, f"{what} {k}", got[k], want[k])
        for k, (rtol, atol) in float_keys.items():
            self.close(kernel, f"{what} {k}", got[k], want[k], rtol, atol)


def race_rows(torch, lon2coord, rows, n, dev, seed):
    """Env rows ``rows`` (pos 2, vel 2, xy 4, ...) with mid-race starts, so
    that a short run crosses wins, collisions and resets
    (tests/test_fused_trainer_e2e.py:57-75)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pos = torch.tensor(rng.uniform(870.0, 948.0, (2, n)),
                       dtype=torch.float32, device=dev)
    vel = torch.tensor(rng.uniform(5.0, 40.0, (2, n)), dtype=torch.float32,
                       device=dev)
    rows = rows.clone()
    rows[0:2], rows[2:4] = pos, vel
    rows[4:6] = torch.stack(lon2coord(pos[0], 1.0))
    rows[6:8] = torch.stack(lon2coord(pos[1], -1.0))
    return rows


def race_carry(torch, FT, lon2coord, cfg, ep, n, dev, seed=0, **kw):
    """A K5 carry with small centred weights (a decisive argmax) and
    mid-race starts."""
    carry = FT.fused_dqn_init(seed, cfg, ep, n, device=dev, **kw)
    for k in ("p", "tp"):
        carry[k] = tuple((a - a.mean()) * 0.05 for a in carry[k])
    if cfg.opponent != "frozen":
        carry["opp"] = carry["p"]
    carry["env"] = race_rows(torch, lon2coord, carry["env"], n, dev,
                             seed + 100)
    return carry


def compare_k5(checks, torch, what, got, want):
    """The tolerances of tests/test_fused_trainer_e2e.py:_check: events,
    learns and counters exact; env and ring to 1e-4; params, target and
    Adam moments to rtol 2e-3, atol 2e-4; the loss to rtol 1e-3."""
    checks.equal("K5", f"{what} winner/t", got["env"][8:10],
                  want["env"][8:10])
    checks.close("K5", f"{what} env", got["env"], want["env"], 0.0, 1e-4)
    checks.close("K5", f"{what} ring", got["ring"], want["ring"], 1e-4, 1e-4)
    for k in ("p", "tp", "m", "v"):
        for i, (a, b) in enumerate(zip(got[k], want[k])):
            checks.close("K5", f"{what} {k}[{i}]", a, b, 2e-3, 2e-4)
    for k in ("learns", "steps", "episodes", "collisions", "wins"):
        if got[k] != want[k]:
            raise AssertionError(f"K5 {what} {k}: {got[k]} != {want[k]}")
    for k, rtol, atol in (("sum_ep_reward", 1e-4, 1e-3),
                          ("last_loss", 1e-3, 1e-6)):
        checks.close("K5", f"{what} {k}", torch.tensor(got[k]),
                     torch.tensor(want[k]), rtol, atol)
    if not (got["learns"] > 0 and got["episodes"] > 0):
        raise AssertionError(f"K5 {what}: nothing learned or finished")


def check_k5(checks, torch, FT, D, EnvParams, lon2coord, qnet_init, dev):
    """K5 against its plain version at 1,024 envs, R = 4; returns the
    first case, run once more for the determinism check."""
    n = N_TRAIN
    sp = D.DQNConfig(lr=1e-3, target_sync=7, memory_capacity=4 * n,
                     opponent="selfplay")
    ep60 = EnvParams(max_steps=60)
    frozen = dict(opp_params=qnet_init(
        torch.Generator(device=dev).manual_seed(8), 10, 5))
    # (cfg, env, init kwargs, chunk lengths, greedy, race start).  The
    # 2-step first chunks stop short of the R-1 = 3 step warm-up, so the
    # global-step learn gate is held across launches.  learn_rounds = 4
    # needs learn_batch % 512 == 0 (the JAX validation, kept).
    cases = {
        "greedy selfplay, cold + warm": (sp, ep60, {}, (2, 30), True, True),
        "greedy L0, learn_batch 512 in 4 windows": (
            sp.replace(opponent="L0", target_sync=5), ep60,
            dict(learn_batch=512, learn_rounds=4), (30,), True, True),
        "greedy selfplay bf16": (sp.replace(compute_dtype="bfloat16"), ep60,
                                 {}, (2, 20), True, True),
        "greedy frozen opponent": (sp.replace(opponent="frozen"), ep60,
                                   frozen, (2, 20), True, True),
        "phi-greedy random_start": (sp, EnvParams(random_start=True,
                                                  max_steps=30), {}, (32,),
                                    False, False),
    }
    for what, (cfg, ep, kw, chunks, greedy, race) in cases.items():
        c0 = (race_carry(torch, FT, lon2coord, cfg, ep, n, dev, **kw) if race
              else FT.fused_dqn_init(0, cfg, ep, n, device=dev, **kw))
        got = want = c0
        for seed, T in enumerate(chunks):
            got = FT.fused_dqn_chunk(cfg, ep, got, T, seed, greedy=greedy)
            want = FT.fused_dqn_chunk_plain(cfg, ep, want, T, seed,
                                            greedy=greedy)
        compare_k5(checks, torch, what, got, want)
        print(f"K5 {what}: {got['learns']} learns, {int(got['episodes'])} "
              f"episodes, {int(got['wins'])} wins, "
              f"{int(got['collisions'])} collisions agree", flush=True)
        if what.startswith("greedy selfplay, cold"):
            first = (cfg, ep, c0, chunks, got)
    cfg, ep, c0, chunks, got = first
    again = c0
    for seed, T in enumerate(chunks):
        again = FT.fused_dqn_chunk(cfg, ep, again, T, seed, greedy=True)
    same = all(torch.equal(got[k], again[k]) for k in ("env", "ring")) and all(
        torch.equal(a, b) for k in ("p", "tp", "m", "v")
        for a, b in zip(got[k], again[k]))
    if not same or got["last_loss"] != again["last_loss"]:
        raise AssertionError("K5 run twice on the same inputs differs")
    print("K5: two runs on the same inputs give the same bits", flush=True)


def hdqn_race_carry(torch, FH, lon2coord, cfg, ep, n, dev, seed=0, **kw):
    """A K7 carry with small centred weights and mid-race starts (the
    ``_mk`` of tests/test_fused_hdqn_e2e.py:59-75)."""
    carry = FH.fused_hdqn_init(seed, cfg, ep, n, device=dev, **kw)
    for k in ("u_p", "u_tp", "l_p", "l_tp"):
        carry[k] = tuple((a - a.mean()) * 0.05 for a in carry[k])
    if cfg.opponent != "frozen":
        carry["opp_u"], carry["opp_l"] = carry["u_p"], carry["l_p"]
    carry["state"] = race_rows(torch, lon2coord, carry["state"], n, dev,
                               seed + 200)
    return carry


def compare_k7(checks, torch, FH, what, got, want):
    """The tolerances of tests/test_fused_hdqn_e2e.py:225-254: winner, t,
    goals, option flags, the upper learn counter (row 15), lo_learns and
    the metrics exact; state and rings to 1e-4; the eight learner sets to
    rtol 2e-3, atol 2e-4; the loss to rtol 1e-3."""
    for row in (8, 9, 11, 12, 14):
        checks.equal("K7", f"{what} state row {row}", got["state"][row],
                     want["state"][row])
    g_up, w_up = FH.upper_learns(got["state"]), FH.upper_learns(want["state"])
    if g_up != w_up:
        raise AssertionError(f"K7 {what} upper learns: {g_up} != {w_up}")
    checks.close("K7", f"{what} state", got["state"][:15], want["state"][:15],
                 0.0, 1e-4)
    for k in ("lo_ring", "up_ring"):
        checks.close("K7", f"{what} {k}", got[k], want[k], 1e-4, 1e-4)
    for k in FH.SETS[:8]:
        for i, (a, b) in enumerate(zip(got[k], want[k])):
            checks.close("K7", f"{what} {k}[{i}]", a, b, 2e-3, 2e-4)
    for k in ("lo_learns", "steps", "episodes", "collisions", "wins"):
        if got[k] != want[k]:
            raise AssertionError(f"K7 {what} {k}: {got[k]} != {want[k]}")
    for k, rtol, atol in (("sum_ep_reward", 1e-4, 1e-3),
                          ("last_loss", 1e-3, 1e-6)):
        checks.close("K7", f"{what} {k}", torch.tensor(got[k]),
                     torch.tensor(want[k]), rtol, atol)
    if not (got["lo_learns"] > 0 and g_up > 0 and got["episodes"] > 0):
        raise AssertionError(f"K7 {what}: a learner never fired or no "
                             "episode ended")
    return g_up


def check_k7(checks, torch, FH, H, EnvParams, lon2coord, qnet_init, dev):
    """K7 against its plain version at 1,024 envs, R_lo = 4, R_up = 2,
    B = 1,024 (the CLI defaults); every case from race starts but the
    Phi-greedy one; then the first case run again for the same bits."""
    n = N_TRAIN
    l0 = H.HDQNConfig(lr=1e-3, target_sync=7, memory_capacity=4 * n,
                      goal_memory_capacity=2 * n, opponent="L0")
    ep60 = EnvParams(max_steps=60)
    g = torch.Generator(device=dev).manual_seed(9)
    frozen = dict(opp_upper=qnet_init(g, 10, 3), opp_lower=qnet_init(g, 11, 5))
    # (cfg, env, init kwargs, chunk lengths, greedy, race start).  The
    # 1-step first chunk stops short of both rings' warm-up.
    cases = {
        "greedy L0, cold + warm": (l0, ep60, {}, (1, 30), True, True),
        "greedy selfplay": (l0.replace(opponent="selfplay"), ep60, {},
                            (2, 20), True, True),
        "greedy frozen opponent": (l0.replace(opponent="frozen"), ep60,
                                   frozen, (20,), True, True),
        "greedy L0, learn_batch 512": (l0, ep60, dict(learn_batch=512),
                                       (20,), True, True),
        "greedy selfplay bf16": (l0.replace(opponent="selfplay",
                                            compute_dtype="bfloat16"),
                                 ep60, {}, (2, 20), True, True),
        "phi-greedy selfplay random_start": (
            l0.replace(opponent="selfplay"),
            EnvParams(random_start=True, max_steps=30), {}, (32,), False,
            False),
    }
    for what, (cfg, ep, kw, chunks, greedy, race) in cases.items():
        c0 = (hdqn_race_carry(torch, FH, lon2coord, cfg, ep, n, dev, **kw)
              if race else FH.fused_hdqn_init(0, cfg, ep, n, device=dev,
                                              **kw))
        got = want = c0
        for seed, T in enumerate(chunks):
            got = FH.fused_hdqn_chunk(cfg, ep, got, T, seed, greedy=greedy)
            want = FH.fused_hdqn_chunk_plain(cfg, ep, want, T, seed,
                                             greedy=greedy)
        up = compare_k7(checks, torch, FH, what, got, want)
        print(f"K7 {what}: {got['lo_learns']} lower and {up} upper learns, "
              f"{int(got['episodes'])} episodes, {int(got['wins'])} wins, "
              f"{int(got['collisions'])} collisions agree", flush=True)
        if what.startswith("greedy L0, cold"):
            first = (cfg, ep, c0, chunks, got)
    cfg, ep, c0, chunks, got = first
    again = c0
    for seed, T in enumerate(chunks):
        again = FH.fused_hdqn_chunk(cfg, ep, again, T, seed, greedy=True)
    same = all(torch.equal(got[k], again[k])
               for k in ("state", "lo_ring", "up_ring")) and all(
        torch.equal(a, b) for k in FH.SETS[:8]
        for a, b in zip(got[k], again[k]))
    if not same or got["last_loss"] != again["last_loss"]:
        raise AssertionError("K7 run twice on the same inputs differs")
    print("K7: two runs on the same inputs give the same bits", flush=True)


def check_k8(checks, torch, FRB, RB, EnvParams, lon2coord, p_l1, dev):
    """K8 against its plain version at 1,024 envs, bit for bit: every
    field of the carry and every counter (one case with 24 envs a block of
    the act kernel, whose last block holds 16: 1,024 is a multiple of
    every power-of-two block); then the first case run again for the same
    bits."""
    n = N_TRAIN
    sp = RB.RainbowConfig(lr=1e-3, gamma=0.9, target_sync_episodes=20,
                          memory_capacity=8 * n, obs_scale=0.01)
    ep60 = EnvParams(max_steps=60)
    # (cfg, env, init kwargs, chunk lengths, greedy, race start[, envs a
    # block of the act kernel]).  The 1-step first chunk stops short of the
    # n_step = 1 warm-up.
    cases = {
        "greedy selfplay, cold + warm": (sp, ep60, {}, (1, 30), True, True),
        "greedy L0": (sp.replace(opponent="L0"), ep60, {}, (20,), True, True),
        "greedy frozen L1": (sp.replace(opponent="frozen"), ep60,
                             dict(opp_params=p_l1), (20,), True, True),
        "greedy L0, learn_batch 512": (sp.replace(opponent="L0"), ep60,
                                       dict(learn_batch=512), (20,), True,
                                       True),
        "greedy PER": (sp.replace(per=True), ep60, {}, (20,), True, True),
        "greedy 3-step": (sp.replace(n_step=3), ep60, {}, (20,), True, True),
        "greedy PER 3-step": (sp.replace(per=True, n_step=3), ep60, {},
                              (3, 20), True, True),
        "phi-greedy PER 3-step, noise redrawn": (
            sp.replace(per=True, n_step=3, epsilon=0.7), ep60, {}, (3, 20),
            False, True),
        "phi-greedy noise random_start": (
            sp.replace(epsilon=0.7), EnvParams(random_start=True,
                                               max_steps=20), {}, (24,),
            False, False),
        "greedy selfplay, 24 envs a block": (sp, ep60, {}, (20,), True,
                                             True, 24),
    }
    for what, (cfg, ep, kw, chunks, greedy, race, *rows) in cases.items():
        c0 = FRB.fused_rainbow_init(0, cfg, ep, n, device=dev, **kw)
        if race:
            c0["env"] = race_rows(torch, lon2coord, c0["env"], n, dev, 300)
        act_geom = None
        if rows:
            act_geom = FRB.act_tiling(rows[0], 2)
            if n % act_geom.rows == 0:
                raise AssertionError("K8: the last block is not partial")
        got = want = c0
        for seed, T in enumerate(chunks):
            got = FRB.fused_rainbow_chunk(cfg, ep, got, T, seed,
                                          greedy=greedy, act_geom=act_geom)
            want = FRB.fused_rainbow_chunk_plain(cfg, ep, want, T, seed,
                                                 greedy=greedy)
        for k in ("p", "tp", "m", "v", "eps", "teps", "env", "ring"):
            checks.equal("K8", f"{what} {k}", got[k], want[k])
        for k in ("learns", "steps", "episodes", "collisions", "wins",
                  "sum_ep_reward", "last_loss"):
            if got[k] != want[k]:
                raise AssertionError(f"K8 {what} {k}: {got[k]} != {want[k]}")
        if not (got["learns"] > 0 and got["episodes"] > 0):
            raise AssertionError(f"K8 {what}: nothing learned or finished")
        if not greedy and torch.equal(got["eps"], c0["eps"]):
            raise AssertionError(f"K8 {what}: the noise was never redrawn")
        synced = int(got["env"][11, 0])
        print(f"K8 {what}: {got['learns']} learns, {int(got['episodes'])} "
              f"episodes, {int(got['wins'])} wins, {int(got['collisions'])} "
              f"collisions, {synced} target syncs: bit-equal", flush=True)
        if what.startswith("greedy selfplay, cold"):
            if synced < 1:
                raise AssertionError("K8: the episodic target sync never "
                                     "fired")
            first = (cfg, ep, c0, chunks, got)
    cfg, ep, c0, chunks, got = first
    again = c0
    for seed, T in enumerate(chunks):
        again = FRB.fused_rainbow_chunk(cfg, ep, again, T, seed, greedy=True)
    if not all(torch.equal(got[k], again[k]) for k in (
            "p", "tp", "m", "v", "eps", "teps", "env", "ring")) or \
            got["last_loss"] != again["last_loss"]:
        raise AssertionError("K8 run twice on the same inputs differs")
    print("K8: two runs on the same inputs give the same bits", flush=True)


def shrink_drqn(FD, flat):
    """Each of the twelve arrays centred and scaled by 0.05: a decisive
    argmax (tests/test_fused_drqn_e2e.py:_shrink)."""
    return FD.drqn_params_to_t({
        layer: {k: (x - x.mean()) * 0.05 for k, x in p.items()}
        for layer, p in FD.t_to_drqn_params(flat).items()})


def check_k9(checks, torch, FD, DR, EnvParams, lon2coord, drqn_init, dev):
    """K9 against its plain version at 1,024 envs, L 16, R 4, burn-in 4,
    bit for bit: every field of the carry and every counter.  A cold
    self-play case of 72 steps in two launches split in the middle of a
    window runs through the 63-step warm-up into 9 learns (target sync 5:
    two syncs); the other cases start, on both sides, from the warm carry
    the kernel reached there (one with 24 envs a block of the act kernel,
    whose last block holds 16); then the first case run again for the same
    bits."""
    import numpy as np
    n = N_TRAIN
    cfg = DR.DRQNConfig(lr=1e-3, target_sync=5, memory_capacity=4 * n,
                        opponent="selfplay")
    ep60 = EnvParams(max_steps=60)
    c0 = FD.fused_drqn_init(0, cfg, ep60, n, device=dev)
    c0["p"], c0["tp"] = shrink_drqn(FD, c0["p"]), shrink_drqn(FD, c0["tp"])
    c0["opp"] = c0["p"]
    c0["env"] = race_rows(torch, lon2coord, c0["env"], n, dev, 400)
    c0["win"][0:10] = FD._obs_rows(c0["env"][0:8])
    frozen = FD.drqn_params_to_t(drqn_init(
        torch.Generator(device=dev).manual_seed(9), 10, 5, device=dev), dev)

    def half_lanes(c):
        return {**c, "B": n // 2}

    def with_opp(c):
        return {**c, "opp": shrink_drqn(FD, frozen)}

    # (cfg, env, carry maker, chunk lengths, greedy, expected learns[, envs
    # a block of the act kernel]).
    cases = {
        "greedy selfplay, cold: 40 + 32 steps": (cfg, ep60, None, (40, 32),
                                                 True, 9),
        "greedy L0, warm": (cfg.replace(opponent="L0"), ep60, dict, (24,),
                            True, 24),
        "greedy frozen DRQN, warm": (cfg.replace(opponent="frozen"), ep60,
                                     with_opp, (24,), True, 24),
        "greedy selfplay, learn_batch 512, warm": (cfg, ep60, half_lanes,
                                                   (24,), True, 24),
        "phi-greedy random_start, warm": (
            cfg, EnvParams(random_start=True, max_steps=30), dict, (24,),
            False, 24),
        "greedy frozen DRQN, warm, 24 envs a block": (
            cfg.replace(opponent="frozen"), ep60, with_opp, (24,), True, 24,
            24),
    }
    warm = None
    for what, (c, ep, make, chunks, greedy, learns, *rows) in cases.items():
        start = c0 if make is None else make(warm)
        act_geom = None
        if rows:
            act_geom = FD.act_tiling(rows[0], *FD.act_seats(c.opponent))
            if n % act_geom.rows == 0:
                raise AssertionError("K9: the last block is not partial")
        got = want = start
        for seed, T in enumerate(chunks):
            kw = {}
            if start["B"] < n:  # both lane windows drawn
                kw = dict(cols=np.arange(T) % 2)
            got = FD.fused_drqn_chunk(c, ep, got, T, seed, greedy=greedy,
                                      act_geom=act_geom, **kw)
            want = FD.fused_drqn_chunk_plain(c, ep, want, T, seed,
                                             greedy=greedy, **kw)
        for k in ("p", "tp", "m", "v", "env", "win", "ring"):
            checks.equal("K9", f"{what} {k}", got[k], want[k])
        for k in ("learns", "steps", "episodes", "collisions", "wins",
                  "sum_ep_reward", "last_loss"):
            if got[k] != want[k]:
                raise AssertionError(f"K9 {what} {k}: {got[k]} != {want[k]}")
        new = got["learns"] - start["learns"]
        syncs = sum(1 for k in range(start["learns"], got["learns"])
                    if k % c.target_sync == 0)
        if new != learns or got["episodes"] == start["episodes"]:
            raise AssertionError(f"K9 {what}: {new} learns, episodes "
                                 f"{got['episodes']}")
        print(f"K9 {what}: {new} learns ({syncs} target syncs), "
              f"{int(got['episodes'] - start['episodes'])} episodes, "
              f"{int(got['wins'] - start['wins'])} wins: bit-equal",
              flush=True)
        if make is None:
            if syncs < 2:
                raise AssertionError("K9: fewer than two target syncs")
            warm, first = got, (c, ep, chunks, got)
    c, ep, chunks, got = first
    again = c0
    for seed, T in enumerate(chunks):
        again = FD.fused_drqn_chunk(c, ep, again, T, seed, greedy=True)
    if not all(torch.equal(got[k], again[k]) for k in (
            "p", "tp", "m", "v", "env", "win", "ring")) or \
            got["last_loss"] != again["last_loss"]:
        raise AssertionError("K9 run twice on the same inputs differs")
    print("K9: two runs on the same inputs give the same bits", flush=True)


def drqn_path(cli, tmp, evaluate_drqn, EnvParams, load_params_npz,
              drqn_params_from_numpy, torch, dev):
    """The DRQN training path through the port's CLI, then
    ``evaluate_drqn`` of the trained net against L0; returns the run
    directories and the result."""
    fused, frozen, loop = (os.path.join(tmp, d) for d in
                           ("drqn_fused", "drqn_frozen", "drqn_loop"))
    cli.main(["train", "--algo", "drqn", "--fused-kernel", "--max-chunks",
              "5", "--episodes", BIG, "--out", fused])
    cli.main(["train", "--algo", "drqn", "--fused-kernel", "--opponent",
              os.path.join(fused, "params.npz"), "--max-chunks", "1",
              "--episodes", BIG, "--out", frozen])
    cli.main(["train", "--algo", "drqn", "--opponent", "selfplay",
              "--max-chunks", "2", "--episodes", BIG, "--out", loop])
    # Phi(0.7)-greedy against L0, 512 steps x 2 at 256 envs; a 400-step cap
    # makes every env finish at least two episodes.
    res = evaluate_drqn(
        drqn_params_from_numpy(load_params_npz(
            os.path.join(fused, "params.npz")), dev),
        env_params=EnvParams(max_steps=400),
        generator=torch.Generator(device=dev).manual_seed(0),
        num_envs=N_ENVS_HDQN, min_episodes=512, chunk_steps=512,
        max_chunks=2)
    runs = {"drqn train --fused-kernel": (fused, 5, "learns"),
            "drqn train --fused-kernel vs frozen DRQN": (frozen, 1,
                                                         "learns"),
            "drqn train (step loop)": (loop, 2, "learns")}
    return runs, res


def flat_params(load_params_npz, run):
    """A run's ``params.npz`` as ``{"layer.key": array}``."""
    def walk(tree, prefix):
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}{k}.")
            else:
                yield prefix + k, v
    return dict(walk(load_params_npz(os.path.join(run, "params.npz")), ""))


def params_err(np, load_params_npz, a, b):
    """Largest |difference| between two runs' parameters."""
    pa, pb = (flat_params(load_params_npz, r) for r in (a, b))
    if sorted(pa) != sorted(pb):
        raise AssertionError(f"{a} and {b} hold other params")
    return max(float(np.abs(pa[k].astype(np.float64) - pb[k]).max())
               for k in pa)


def last_row(run):
    with open(os.path.join(run, "scalars.jsonl")) as f:
        return [json.loads(ln) for ln in f][-1]


def resume_path(cli, np, tmp, load_params_npz, CheckpointManager, torch):
    """The ``resume`` phase through the CLI: for each trainer run A
    (``--max-chunks 2 --checkpoint-every 1``), B (``--max-chunks 1
    --resume A``) and C (``--max-chunks 3``, uninterrupted; twice for the
    step loops).  B must equal C bit for bit where two uninterrupted runs
    do; a step loop whose two runs differ is held, B against C as C
    against C, to ``LOOP_RUN_TO_RUN_ATOL``.  Returns each trainer's wall
    times, checkpoint sizes and differences."""
    out = {}

    def run(label, flags, name, *extra):
        path = os.path.join(tmp, "resume", label.replace(" ", "_"), name)
        t = time.perf_counter()
        cli.main(["train", *flags, "--episodes", BIG, "--out", path, *extra])
        torch.cuda.synchronize()
        return path, time.perf_counter() - t

    for label, flags, learned in RESUME_FUSED + RESUME_LOOPS:
        loop = "--fused-kernel" not in flags
        a, a_s = run(label, flags, "A", "--max-chunks", "2",
                     "--checkpoint-every", "1")
        b, b_s = run(label, flags, "B", "--max-chunks", "1", "--resume", a)
        c, c_s = run(label, flags, "C", "--max-chunks", "3")
        ckpt = CheckpointManager(os.path.join(a, "ckpt"))
        if ckpt.all_steps() != [0, 1, 2]:
            raise AssertionError(f"{label}: A kept steps {ckpt.all_steps()}")
        rec = {"wall_s": {"A": a_s, "B": b_s, "C": c_s},
               "ckpt_bytes": os.path.getsize(ckpt.step_path(2)),
               "max_abs_err": params_err(np, load_params_npz, b, c)}
        keys = RESUME_ROW_KEYS + (learned,)
        rb, rc = last_row(b), last_row(c)
        if loop:
            c2, rec["wall_s"]["C2"] = run(label, flags, "C2", "--max-chunks",
                                          "3")
            rec["run_to_run_err"] = params_err(np, load_params_npz, c, c2)
            rc2 = last_row(c2)
            rec["run_to_run_rows_equal"] = all(rc[k] == rc2[k] for k in keys)
        if rc["env_steps"] != rb["env_steps"] or rc[learned] <= 0:
            raise AssertionError(f"{label}: B {rb}, C {rc}")
        if not loop or rec["run_to_run_err"] == 0.0:
            # Bit for bit: params and the last scalars row.
            if rec["max_abs_err"] != 0.0 or any(rb[k] != rc[k] for k in keys):
                raise AssertionError(f"{label}: resumed run differs from the "
                                     f"uninterrupted one: {rec}, B {rb}, "
                                     f"C {rc}")
        elif max(rec["max_abs_err"],
                 rec["run_to_run_err"]) > LOOP_RUN_TO_RUN_ATOL:
            raise AssertionError(f"{label}: {rec}")
        out[label] = rec
    return out


def pth_path(cli, tmp, load_params_npz, qnet_params_from_numpy,
             qnet_to_state_dict, torch):
    """``eval --fused`` of model_zoo/L2 written as a reference ``.pth`` run
    directory must equal the same command on L2's ``params.npz``."""
    ref = os.path.join(tmp, "ref_l2")
    os.makedirs(ref)
    sd = qnet_to_state_dict(qnet_params_from_numpy(load_params_npz(ZOO_L2),
                                                   "cpu"))
    for name in ("eval.pth", "target.pth"):
        torch.save(sd, os.path.join(ref, name))
    args = ["eval", "--fused", "--p2", ZOO_L1]
    got = cli.main([*args, "--p1", ref])
    want = cli.main([*args, "--p1", ZOO_L2])
    if got != want:
        raise AssertionError(f"eval --fused of a .pth run dir: {got} != "
                             f"{want}")
    return got


# ---------------------------------------------------------------------------
# The spmd phase: parallel/ on the card
# ---------------------------------------------------------------------------

SPMD_T = 200           # steps of a local-SGD chunk (the CLI's chunk length)
SPMD_LOOP_T = 20       # steps of a step-loop chunk
SPMD_RANKS = 2         # the gloo world on one card
SPMD_TIMEOUT_S = 600   # for every rank's answer
TP_GRAD_RTOL = 1e-5    # tensor-parallel against single-device gradients
SPMD_ROUNDS = 5        # rounds of the one-rank chunk readings


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def counted(kernels, fn):
    """``fn()`` and the launches it made."""
    before = dict(kernels.launch_counts)
    out = fn()
    return out, {k: kernels.launch_counts[k] - before[k] for k in before}


def add_counts(total, part):
    for k, v in part.items():
        total[k] = total.get(k, 0) + v
    return total


def event_call(torch, fn):
    """``(fn(), ms)``: one call between two CUDA events (a gloo collective
    on CUDA tensors holds the stream while the host reduces, so its time
    is in the span)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def host_call(torch, fn):
    """``(fn(), ms, host ms)``: one call between two CUDA events, and the
    host's time from the call to its return (to issue its work, and to
    wait where it reads a result back)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    out = fn()
    host = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end), host


def interleaved_ms(torch, kernels, spmd_fn, single_fn, rounds=SPMD_ROUNDS):
    """Medians of ``spmd_fn``'s and ``single_fn``'s times (CUDA events)
    over ``rounds`` rounds of spmd, single, single, spmd after one call
    of each, and the launches of the spmd calls."""
    single_fn()
    launches = counted(kernels, spmd_fn)[1]
    a, b = [], []
    for _ in range(rounds):
        for fn, times in ((spmd_fn, a), (single_fn, b), (single_fn, b),
                          (spmd_fn, a)):
            (_, ms), lc = counted(kernels, lambda: event_call(torch, fn))
            times.append(ms)
            if fn is spmd_fn:
                add_counts(launches, lc)
    return statistics.median(a), statistics.median(b), launches


def local_sgd_split(torch, state_fn, reduce_fn, fold_fn, finish_fn,
                    reps=SPMD_ROUNDS):
    """Medians over ``reps`` of the parts of a local-SGD chunk, each
    between its own events: the kernels' chunk (``chunk_state``; ms and
    the host's ms to issue it), the average of its sets with the metric
    and loss read-backs (``_reduce_chunk``), the fold into the carry, and
    the single-chip chunk's own fold (``_finish``) on the same state."""
    parts = {k: [] for k in ("state_ms", "state_host_ms", "reduce_ms",
                             "fold_ms", "single_chip_fold_ms")}
    for _ in range(reps + 1):
        st, ms, host = host_call(torch, state_fn)
        red, rms, _ = host_call(torch, lambda: reduce_fn(st))
        fms = host_call(torch, lambda: fold_fn(st, red))[1]
        sms = host_call(torch, lambda: finish_fn(st))[1]
        for k, v in zip(parts, (ms, host, rms, fms, sms)):
            parts[k].append(v)
    return {k: statistics.median(v[1:]) for k, v in parts.items()}


def tree_equal(torch, a, b, path="carry"):
    """Raise unless two ``state_tree``s agree bit for bit."""
    if isinstance(a, torch.Tensor):
        if not (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b)):
            raise AssertionError(f"{path} differs")
    elif isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"{path}: keys {sorted(a)} != {sorted(b)}")
        for k in a:
            tree_equal(torch, a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        if len(a) != len(b):
            raise AssertionError(f"{path}: lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            tree_equal(torch, x, y, f"{path}[{i}]")
    elif a != b:
        raise AssertionError(f"{path}: {a} != {b}")


def local_sgd_carry(c):
    """A local-SGD carry without its two lane counts, as a single-chip
    carry."""
    return {k: v for k, v in c.items() if k not in ("n_local", "n_global")}


def spmd_world_of_one(torch, kernels, dev):
    """A world of one rank under NCCL on ``dev``: the local-SGD chunks of
    K5, K7, K8 (uniform and PER 3-step) and K9 (random mode, 200 steps,
    1,024 envs) and the (1, 1) DQN, Rainbow and DRQN step loops (20 steps)
    against the single-chip trainers, bit for bit.  Returns the readings
    and the spmd calls' launches."""
    import torch.distributed as dist

    from merging_gym_tpu_torch.agents import dqn as D
    from merging_gym_tpu_torch.agents import drqn as DR
    from merging_gym_tpu_torch.agents import hdqn as H
    from merging_gym_tpu_torch.agents import rainbow as RB
    from merging_gym_tpu_torch.core.env import EnvParams
    from merging_gym_tpu_torch.io.checkpoint import state_tree
    from merging_gym_tpu_torch.ops import fused_drqn as FD
    from merging_gym_tpu_torch.ops import fused_hdqn as FH
    from merging_gym_tpu_torch.ops import fused_rainbow as FRB
    from merging_gym_tpu_torch.ops import fused_trainer as FT
    from merging_gym_tpu_torch.parallel import mesh as M
    from merging_gym_tpu_torch.parallel import multihost, spmd

    multihost.initialize(f"localhost:{free_port()}", 1, 0, device=dev)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"world of one runs {dist.get_backend()}")
        mesh = M.make_mesh(1, 1)
        group = mesh.get_group("data")
        n, launches, out = N_TRAIN, {}, {"backend": "nccl", "ranks": 1}
        ep = EnvParams(random_start=True, max_steps=60)

        cfg = D.DQNConfig(memory_capacity=4 * n, opponent="selfplay")
        c0 = spmd.spmd_fused_dqn_init(0, cfg, ep, n, mesh, device=dev)

        def k5():
            return spmd.spmd_fused_dqn_chunk(mesh, cfg, ep, c0, SPMD_T, 5)
        got, l5 = counted(kernels, k5)
        s0 = FT.fused_dqn_init(0, cfg, ep, n, device=dev)
        want = FT.fused_dqn_chunk(cfg, ep, s0, SPMD_T, 5)
        tree_equal(torch, state_tree(local_sgd_carry(got)), state_tree(want),
                   "K5 world of one")
        if not (want["learns"] > 0 and want["episodes"] > 0):
            raise AssertionError("K5 world of one: nothing learned")
        # Warm chunks of local SGD and of the single chip, interleaved,
        # and the parts of each.
        names5 = ("p", "tp", "m", "v")
        dims5 = FT._dims(c0["p"])
        out["k5_chunk_ms"], out["k5_single_chip_chunk_ms"], l5t = \
            interleaved_ms(torch, kernels, k5, lambda: FT.fused_dqn_chunk(
                cfg, ep, s0, SPMD_T, 5))

        def fold5(st, red):
            sets, met, loss = red
            o = {k: FT._transposed(a, dims5) for k, a in zip(names5, sets)}
            o["env"], o["ring"] = st["env"], st["ring"]
            return FT.apply_chunk(c0, o, SPMD_T, met, loss)
        out["k5_split"] = local_sgd_split(
            torch, lambda: FT.chunk_state(cfg, ep, c0, SPMD_T, 5),
            lambda st: spmd._reduce_chunk(st, names5, mesh), fold5,
            lambda st: FT._finish(s0, st, dims5, SPMD_T))
        sets5 = [FT._flat(c0[k]) for k in names5]
        out["k5_average_ms"] = cuda_ms(torch, lambda: M.pmean(sets5, group),
                                       20)
        out["k5_average_floats"] = sum(t.numel() for t in sets5)
        add_counts(launches, l5)
        add_counts(launches, l5t)

        hcfg = H.HDQNConfig(memory_capacity=4 * n, goal_memory_capacity=2 * n,
                            opponent="selfplay")
        h0 = spmd.spmd_fused_hdqn_init(0, hcfg, ep, n, mesh, device=dev)

        def k7():
            return spmd.spmd_fused_hdqn_chunk(mesh, hcfg, ep, h0, SPMD_T, 6)
        got, l7 = counted(kernels, k7)
        s0 = FH.fused_hdqn_init(0, hcfg, ep, n, device=dev)
        want = FH.fused_hdqn_chunk(hcfg, ep, s0, SPMD_T, 6)
        tree_equal(torch, state_tree(local_sgd_carry(got)), state_tree(want),
                   "K7 world of one")
        if not (want["lo_learns"] > 0 and want["episodes"] > 0):
            raise AssertionError("K7 world of one: nothing learned")
        names7 = FH.SETS[:8]
        du, dl = FT._dims(h0["u_p"]), FT._dims(h0["l_p"])
        out["k7_chunk_ms"], out["k7_single_chip_chunk_ms"], l7t = \
            interleaved_ms(torch, kernels, k7, lambda: FH.fused_hdqn_chunk(
                hcfg, ep, s0, SPMD_T, 6))

        def fold7(st, red):
            sets, met, loss = red
            groups = [FT._transposed(a, du if k.startswith("u_") else dl)
                      for k, a in zip(names7, sets)]
            return FH.apply_hdqn_chunk(h0, groups, st["state"],
                                       st["lo_ring"], st["up_ring"], SPMD_T,
                                       met, loss)
        out["k7_split"] = local_sgd_split(
            torch, lambda: FH.chunk_state(hcfg, ep, h0, SPMD_T, 6),
            lambda st: spmd._reduce_chunk(st, names7, mesh), fold7,
            lambda st: FH._finish(s0, st, SPMD_T))
        sets7 = [FT._flat(h0[k]) for k in names7]
        out["k7_average_ms"] = cuda_ms(torch, lambda: M.pmean(sets7, group),
                                       20)
        out["k7_average_floats"] = sum(t.numel() for t in sets7)
        add_counts(launches, l7)
        add_counts(launches, l7t)

        # K8 (uniform 1-step, PER 3-step) and K9 at the CLI's rings.
        for key, rcfg, seed in (
                ("k8", RB.RainbowConfig(memory_capacity=8 * n,
                                        opponent="selfplay"), 11),
                ("k8_per", RB.RainbowConfig(memory_capacity=8 * n, per=True,
                                            n_step=3, obs_scale=0.01,
                                            opponent="selfplay"), 12)):
            r0 = spmd.spmd_fused_rainbow_init(0, rcfg, ep, n, mesh,
                                              device=dev)
            s0 = FRB.fused_rainbow_init(0, rcfg, ep, n, device=dev)

            def k8(rcfg=rcfg, r0=r0, seed=seed):
                return spmd.spmd_fused_rainbow_chunk(mesh, rcfg, ep, r0,
                                                     SPMD_T, seed)

            def k8_single(rcfg=rcfg, s0=s0, seed=seed):
                return FRB.fused_rainbow_chunk(rcfg, ep, s0, SPMD_T, seed)
            got, l8 = counted(kernels, k8)
            want = k8_single()
            tree_equal(torch, state_tree(local_sgd_carry(got)),
                       state_tree(want), f"K8 {key} world of one")
            if not (want["learns"] > 0 and want["episodes"] > 0):
                raise AssertionError(f"K8 {key} world of one: nothing "
                                     "learned")
            out[f"{key}_chunk_ms"], out[f"{key}_single_chip_chunk_ms"], \
                l8t = interleaved_ms(torch, kernels, k8, k8_single)

            def reduce8(st, rcfg=rcfg):
                if rcfg.per:
                    st["env"][13] = M.pmax(st["env"][13], group)
                return spmd._reduce_chunk(st, names5, mesh)

            def fold8(st, red, rcfg=rcfg, r0=r0):
                sets, met, loss = red
                o = {k: st[k] for k in ("eps", "teps", "env", "ring")}
                o.update(zip(names5, sets))
                return FRB.apply_rainbow_chunk(r0, o, SPMD_T, met, loss,
                                               nwarm=rcfg.n_step)
            out[f"{key}_split"] = local_sgd_split(
                torch, lambda rcfg=rcfg, r0=r0, seed=seed: FRB.chunk_state(
                    rcfg, ep, r0, SPMD_T, seed)[0], reduce8, fold8,
                lambda st, rcfg=rcfg, s0=s0: FRB._finish(
                    s0, st, SPMD_T, rcfg.n_step, True))
            add_counts(launches, l8)
            add_counts(launches, l8t)
        sets8 = [r0[k] for k in names5]
        out["k8_average_ms"] = cuda_ms(torch, lambda: M.pmean(sets8, group),
                                       20)
        out["k8_average_floats"] = sum(t.numel() for t in sets8)

        dcfg = DR.DRQNConfig(memory_capacity=4 * n)
        d0 = spmd.spmd_fused_drqn_init(0, dcfg, ep, n, mesh, device=dev)
        s0 = FD.fused_drqn_init(0, dcfg, ep, n, device=dev)

        def k9():
            return spmd.spmd_fused_drqn_chunk(mesh, dcfg, ep, d0, SPMD_T, 13)

        def k9_single():
            return FD.fused_drqn_chunk(dcfg, ep, s0, SPMD_T, 13)
        got, l9 = counted(kernels, k9)
        want = k9_single()
        tree_equal(torch, state_tree(local_sgd_carry(got)), state_tree(want),
                   "K9 world of one")
        if not (want["learns"] > 0 and want["episodes"] > 0):
            raise AssertionError("K9 world of one: nothing learned")
        out["k9_chunk_ms"], out["k9_single_chip_chunk_ms"], l9t = \
            interleaved_ms(torch, kernels, k9, k9_single)

        def fold9(st, red):
            sets, met, loss = red
            o = {k: st[k] for k in ("env", "win", "ring")}
            o.update(zip(names5, sets))
            return FD.apply_drqn_chunk(d0, o, SPMD_T, met, loss)
        out["k9_split"] = local_sgd_split(
            torch, lambda: FD.chunk_state(dcfg, ep, d0, SPMD_T, 13),
            lambda st: spmd._reduce_chunk(st, names5, mesh), fold9,
            lambda st: FD._finish(s0, st, SPMD_T))
        sets9 = [d0[k] for k in names5]
        out["k9_average_ms"] = cuda_ms(torch, lambda: M.pmean(sets9, group),
                                       20)
        out["k9_average_floats"] = sum(t.numel() for t in sets9)
        add_counts(launches, l9)
        add_counts(launches, l9t)

        # The (1, 1) Rainbow and DRQN step loops (random starts: a
        # noisy-greedy self-play clones every env from equal starts).
        rand_ep = EnvParams(random_start=True)
        for key, cfg_, init, chunk, tinit, tchunk in (
                ("rainbow", RB.RainbowConfig(opponent="selfplay"),
                 spmd.spmd_rainbow_init, spmd.spmd_rainbow_chunk,
                 RB.rainbow_train_init, RB.rainbow_train_chunk),
                ("drqn", DR.DRQNConfig(memory_capacity=2 * n,
                                       opponent="selfplay"),
                 spmd.spmd_drqn_init, spmd.spmd_drqn_chunk,
                 DR.drqn_train_init, DR.drqn_train_chunk)):
            c1 = init(3, cfg_.replace(pmean_axis="data"), rand_ep, n, mesh,
                      device=dev)
            (got, ms), ll = counted(kernels, lambda: event_call(
                torch, lambda: chunk(mesh, cfg_.replace(pmean_axis="data"),
                                     rand_ep, c1, SPMD_LOOP_T)))
            out[f"{key}_loop_step_ms"] = ms / SPMD_LOOP_T
            t0 = tinit(3, cfg_, rand_ep, n, device=dev)
            want, ms = event_call(torch, lambda: tchunk(cfg_, rand_ep, t0,
                                                        SPMD_LOOP_T))
            out[f"{key}_single_loop_step_ms"] = ms / SPMD_LOOP_T
            tree_equal(torch, state_tree(got), state_tree(want),
                       f"{key} step loop world of one")
            learned = (want.opt_state.count if key == "rainbow"
                       else want.learn_counter)
            if int(learned) == 0:
                raise AssertionError(f"{key} step loop world of one: no "
                                     "learn")
            add_counts(launches, ll)

        lcfg, lep = D.DQNConfig(opponent="selfplay"), EnvParams()

        c1 = spmd.spmd_train_init(3, lcfg, lep, n, mesh, device=dev)
        (got, ms), ll = counted(kernels, lambda: event_call(
            torch, lambda: spmd.spmd_train_chunk(mesh, lcfg, lep, c1,
                                                 SPMD_LOOP_T)))
        out["loop_step_ms"] = ms / SPMD_LOOP_T
        want = D.train_chunk(lcfg, lep, D.train_init(3, lcfg, lep, n,
                                                     device=dev), SPMD_LOOP_T)
        tree_equal(torch, state_tree(got), state_tree(want),
                   "step loop world of one")
        if int(want.dqn.learn_counter) == 0:
            raise AssertionError("step loop world of one: no learn")
        add_counts(launches, ll)
        out["bit_for_bit"] = ["K5 chunk", "K7 chunk", "K8 chunk",
                              "K8 PER 3-step chunk", "K9 chunk",
                              "Rainbow step loop (1, 1)",
                              "DRQN step loop (1, 1)",
                              "DQN step loop (1, 1)"]
        return out, launches
    finally:
        dist.destroy_process_group()


def spmd_rank(rank, world, addr, results):
    """One rank of the gloo world on ``cuda:0`` (spawned by
    :func:`spmd_world_of_two`); puts ``(rank, error, result)``."""
    try:
        results.put((rank, None, _spmd_rank(rank, world, addr)))
    except Exception:
        import traceback
        results.put((rank, traceback.format_exc(), None))


def _spmd_rank(rank, world, addr):
    import datetime

    import torch

    from merging_gym_tpu_torch import kernels
    from merging_gym_tpu_torch.agents import dqn as D
    from merging_gym_tpu_torch.agents import drqn as DR
    from merging_gym_tpu_torch.agents import hdqn as H
    from merging_gym_tpu_torch.agents import rainbow as RB
    from merging_gym_tpu_torch.core.env import EnvParams
    from merging_gym_tpu_torch.core.geometry import lon2coord
    from merging_gym_tpu_torch.ops import fused_drqn as FD
    from merging_gym_tpu_torch.ops import fused_hdqn as FH
    from merging_gym_tpu_torch.ops import fused_rainbow as FRB
    from merging_gym_tpu_torch.ops import fused_trainer as FT
    from merging_gym_tpu_torch.ops import replay as rp
    from merging_gym_tpu_torch.parallel import mesh as M
    from merging_gym_tpu_torch.parallel import multihost, spmd

    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    # Both ranks on this host: gloo's pairs over the loopback interface.
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dev = multihost.initialize(addr, world, rank, device="cuda:0",
                               backend="gloo",
                               timeout=datetime.timedelta(seconds=300))
    n = world * N_TRAIN
    out, launches = {"rank": rank}, {}

    def host(x):
        return [t.detach().cpu().numpy() for t in x]

    try:
        mesh = M.make_mesh(world, 1)
        group = mesh.get_group("data")
        ep = EnvParams(max_steps=60)
        g = torch.Generator().manual_seed(1000 + rank)

        # K5: greedy from race starts, this rank's own explicit streams.
        cfg = D.DQNConfig(lr=1e-3, target_sync=7, memory_capacity=4 * n,
                          opponent="selfplay")
        c0 = spmd.spmd_fused_dqn_init(0, cfg, ep, n, mesh, device=dev)
        for k in ("p", "tp"):
            c0[k] = tuple((a - a.mean()) * 0.05 for a in c0[k])
        c0["opp"] = c0["p"]
        c0["env"] = race_rows(torch, lon2coord, c0["env"], N_TRAIN, dev,
                              100 + rank)
        rounds = torch.randint(0, c0["R"], (SPMD_T,), generator=g)
        cols = torch.zeros(SPMD_T, dtype=torch.int32)
        def k5():
            return spmd.spmd_fused_dqn_chunk(mesh, cfg, ep, c0, SPMD_T, 9,
                                             greedy=True, rounds=rounds,
                                             cols=cols)

        def k5_solo():
            return FT.fused_dqn_chunk(cfg, ep, c0, SPMD_T,
                                      spmd.data_seed(9, rank), greedy=True,
                                      rounds=rounds, cols=cols)
        (got, out["k5_first_chunk_ms"]), l5 = counted(
            kernels, lambda: event_call(torch, k5))
        solo = k5_solo()
        # Warm readings; both ranks run each at once, sharing the card.
        (_, out["k5_chunk_ms"]), l5w = counted(
            kernels, lambda: event_call(torch, k5))
        dist.barrier()
        out["k5_solo_chunk_ms"] = event_call(torch, k5_solo)[1]
        add_counts(launches, l5w)
        sets = [FT._flat(got[k]) for k in ("p", "tp", "m", "v")]
        out["k5"] = {
            "sets": host(sets),
            "solo_sets": host(FT._flat(solo[k]) for k in ("p", "tp", "m",
                                                          "v")),
            "lanes_equal_solo": all(torch.equal(got[k], solo[k])
                                    for k in ("env", "ring")),
            "counts": {k: got[k] for k in ("learns", "episodes", "wins",
                                           "collisions", "env_steps")},
            "solo_counts": {k: solo[k] for k in ("learns", "episodes",
                                                 "wins", "collisions")}}
        out["k5_average_ms"] = cuda_ms(torch, lambda: M.pmean(sets, group),
                                       20)
        add_counts(launches, l5)

        # K7 likewise.
        hcfg = H.HDQNConfig(lr=1e-3, target_sync=7, memory_capacity=4 * n,
                            goal_memory_capacity=2 * n, opponent="L0")
        h0 = spmd.spmd_fused_hdqn_init(0, hcfg, ep, n, mesh, device=dev)
        for k in ("u_p", "u_tp", "l_p", "l_tp"):
            h0[k] = tuple((a - a.mean()) * 0.05 for a in h0[k])
        h0["opp_u"], h0["opp_l"] = h0["u_p"], h0["l_p"]
        h0["state"] = race_rows(torch, lon2coord, h0["state"], N_TRAIN, dev,
                                200 + rank)
        lo_r = torch.randint(0, h0["R_lo"], (SPMD_T,), generator=g)
        up_r = torch.randint(0, h0["R_up"], (SPMD_T,), generator=g)
        def k7():
            return spmd.spmd_fused_hdqn_chunk(mesh, hcfg, ep, h0, SPMD_T, 10,
                                              greedy=True, lo_rounds=lo_r,
                                              up_rounds=up_r)

        def k7_solo():
            return FH.fused_hdqn_chunk(hcfg, ep, h0, SPMD_T,
                                       spmd.data_seed(10, rank), greedy=True,
                                       lo_rounds=lo_r, up_rounds=up_r)
        (got, out["k7_first_chunk_ms"]), l7 = counted(
            kernels, lambda: event_call(torch, k7))
        solo = k7_solo()
        (_, out["k7_chunk_ms"]), l7w = counted(
            kernels, lambda: event_call(torch, k7))
        dist.barrier()
        out["k7_solo_chunk_ms"] = event_call(torch, k7_solo)[1]
        add_counts(launches, l7w)
        sets = [FT._flat(got[k]) for k in FH.SETS[:8]]
        out["k7"] = {
            "sets": host(sets),
            "solo_sets": host(FT._flat(solo[k]) for k in FH.SETS[:8]),
            "lanes_equal_solo": all(torch.equal(got[k], solo[k])
                                    for k in ("state", "lo_ring", "up_ring")),
            "counts": {k: got[k] for k in ("lo_learns", "episodes", "wins",
                                           "collisions", "env_steps")},
            "solo_counts": {k: solo[k] for k in ("lo_learns", "episodes",
                                                 "wins", "collisions")}}
        out["k7_average_ms"] = cuda_ms(torch, lambda: M.pmean(sets, group),
                                       20)
        add_counts(launches, l7)

        # K8, PER 3-step (its running max priority shared), and K9; each
        # rank keeps its own noise (K8) and draws its own streams.
        rcfg = RB.RainbowConfig(lr=1e-3, target_sync_episodes=7,
                                memory_capacity=8 * n, per=True, n_step=3,
                                obs_scale=0.01, opponent="selfplay")
        r0 = spmd.spmd_fused_rainbow_init(0, rcfg, ep, n, mesh, device=dev)
        r0["env"] = race_rows(torch, lon2coord, r0["env"], N_TRAIN, dev,
                              300 + rank)
        dcfg = DR.DRQNConfig(lr=1e-3, target_sync=7, memory_capacity=4 * n,
                             opponent="selfplay")
        d0 = spmd.spmd_fused_drqn_init(0, dcfg, ep, n, mesh, device=dev)
        d0["p"], d0["tp"] = shrink_drqn(FD, d0["p"]), shrink_drqn(FD,
                                                                  d0["tp"])
        d0["opp"] = d0["p"]
        d0["env"] = race_rows(torch, lon2coord, d0["env"], N_TRAIN, dev,
                              400 + rank)
        d0["win"] = d0["win"].clone()
        d0["win"][0:10] = FD._obs_rows(d0["env"][0:8])
        streams8 = dict(rounds=FRB.draw_start_rounds(r0, SPMD_T, g,
                                                     rcfg.n_step),
                        cols=torch.zeros(SPMD_T, dtype=torch.int32),
                        us=torch.rand(SPMD_T, generator=g))
        streams9 = dict(rounds=torch.randint(0, d0["R"], (SPMD_T,),
                                             generator=g),
                        cols=torch.zeros(SPMD_T, dtype=torch.int32))
        cases = {
            "k8": (lambda: spmd.spmd_fused_rainbow_chunk(
                       mesh, rcfg, ep, r0, SPMD_T, 11, greedy=True,
                       **streams8),
                   lambda: FRB.fused_rainbow_chunk(
                       rcfg, ep, r0, SPMD_T, spmd.data_seed(11, rank),
                       greedy=True, **streams8),
                   ("eps", "teps", "ring", "env13")),
            "k9": (lambda: spmd.spmd_fused_drqn_chunk(
                       mesh, dcfg, ep, d0, SPMD_T, 12, greedy=True,
                       **streams9),
                   lambda: FD.fused_drqn_chunk(
                       dcfg, ep, d0, SPMD_T, spmd.data_seed(12, rank),
                       greedy=True, **streams9),
                   ("env", "win", "ring"))}
        for key, (fn, solo_fn, lanes) in cases.items():
            (got, out[f"{key}_first_chunk_ms"]), lk = counted(
                kernels, lambda: event_call(torch, fn))
            solo = solo_fn()
            (_, out[f"{key}_chunk_ms"]), lkw = counted(
                kernels, lambda: event_call(torch, fn))
            dist.barrier()
            out[f"{key}_solo_chunk_ms"] = event_call(torch, solo_fn)[1]
            add_counts(launches, lk)
            add_counts(launches, lkw)
            sets = [got[k] for k in ("p", "tp", "m", "v")]

            def part(c, k):   # K8's rows 0-12 are rank-local, 13 shared
                return c["env"][:13] if k == "env13" else c[k]
            out[key] = {
                "sets": host(sets),
                "solo_sets": host(solo[k] for k in ("p", "tp", "m", "v")),
                "lanes_equal_solo": all(torch.equal(part(got, k),
                                                    part(solo, k))
                                        for k in lanes),
                "row13": (host([got["env"][13], solo["env"][13]])
                          if key == "k8" else None),
                "noise": host([got["eps"]]) if key == "k8" else None,
                "counts": {k: got[k] for k in ("learns", "episodes", "wins",
                                               "collisions", "env_steps")},
                "solo_counts": {k: solo[k] for k in ("learns", "episodes",
                                                     "wins", "collisions")}}
            out[f"{key}_average_ms"] = cuda_ms(
                torch, lambda: M.pmean(sets, group), 20)

        # The (1, world) tensor-parallel DQN step loop.
        tmesh = M.make_mesh(1, world)
        mg = tmesh.get_group("model")
        lcfg, lep = D.DQNConfig(opponent="selfplay"), EnvParams()
        c = spmd.spmd_train_init(3, lcfg, lep, N_TRAIN, tmesh, device=dev)
        for chunk in ("tp_first_step_ms", "tp_step_ms"):
            (c, ms), lt = counted(kernels, lambda: event_call(
                torch, lambda: spmd.spmd_train_chunk(tmesh, lcfg, lep, c,
                                                     SPMD_LOOP_T)))
            out[chunk] = ms / SPMD_LOOP_T
            add_counts(launches, lt)
        if int(c.dqn.learn_counter) == 0:
            raise AssertionError("tensor-parallel loop: no learn")
        rep = [c.dqn.params["fc1"]["b"], c.dqn.params["fc2"]["w"],
               c.dqn.params["fc2"]["b"], c.dqn.opt_state.mu["fc2"]["w"],
               c.dqn.opt_state.nu["fc2"]["w"], c.obs, c.replay.cursor]
        out["tp_replicated"] = host(rep)

        # Its gradients against the single-device ones, on the full nets
        # assembled by one sum of zero-padded shards over the model group.
        m = M.axis_index(tmesh, "model")

        def full(shard, like):
            k = shard["fc0"]["w"].shape[1]
            cut = slice(m * k, (m + 1) * k)
            z = {layer: {k2: torch.zeros_like(v) for k2, v in p.items()}
                 for layer, p in like.items()}
            z["fc0"]["w"][:, cut] = shard["fc0"]["w"]
            z["fc0"]["b"][cut] = shard["fc0"]["b"]
            z["fc1"]["w"][cut] = shard["fc1"]["w"]
            parts = M.psum([z["fc0"]["w"], z["fc0"]["b"], z["fc1"]["w"]], mg)
            return {"fc0": {"w": parts[0], "b": parts[1]},
                    "fc1": {"w": parts[2], "b": shard["fc1"]["b"]},
                    "fc2": dict(shard["fc2"])}
        like = D.dqn_init(torch.Generator(device=dev).manual_seed(0), lcfg,
                          dev).params
        p_full = full(c.dqn.params, like)
        t_full = full(c.dqn.target_params, like)
        batch = rp.gather(c.replay, torch.arange(lcfg.batch_size,
                                                 device=dev))

        def grads(params, loss_fn):
            with torch.enable_grad():
                p = D._tree_map(lambda a: a.detach().requires_grad_(True),
                                params)
                loss = loss_fn(p)
                it = iter(torch.autograd.grad(loss, D._leaves(p)))
            return D._tree_map(lambda _: next(it), p), loss
        t_shard = spmd.qnet_shard(t_full, m, world)
        g_tp, loss_tp = grads(c.dqn.params, lambda p: spmd._td_loss_tp(
            p, t_shard, batch, lcfg, mg))
        g_one, loss_one = grads(p_full, lambda p: D.td_loss(
            p, t_full, batch, lcfg))
        g_one = spmd.qnet_shard(g_one, m, world)
        errs = {}
        for layer in g_tp:
            for k in g_tp[layer]:
                a, b = g_tp[layer][k], g_one[layer][k]
                scale = float(b.abs().max())
                err = float((a - b).abs().max())
                errs[f"{layer}.{k}"] = err / max(scale, 1e-30)
                if not bool(((a - b).abs() <= TP_GRAD_RTOL * (
                        b.abs() + scale)).all()):
                    raise AssertionError(
                        f"tensor-parallel gradient {layer}.{k}: max |diff| "
                        f"{err} at scale {scale}")
        out["tp_grad_rel_err"] = errs
        out["tp_loss"] = [float(loss_tp.detach()),
                          float(loss_one.detach())]
        out["launches"] = launches
        return out
    finally:
        dist.destroy_process_group()


def spmd_world_of_two(torch, np):
    """Spawn ``SPMD_RANKS`` gloo ranks on ``cuda:0`` (kernels already
    built), hold their local-SGD chunks against the mean of their solo
    runs bit for bit and their replicas against each other; returns the
    ranks' readings and their summed launches."""
    import torch.multiprocessing as tmp

    ctx = tmp.get_context("spawn")
    results = ctx.Queue()
    addr = f"localhost:{free_port()}"
    procs = [ctx.Process(target=spmd_rank,
                         args=(r, SPMD_RANKS, addr, results))
             for r in range(SPMD_RANKS)]
    for p in procs:
        p.start()
    try:
        res, errors = [None] * SPMD_RANKS, []
        for _ in range(SPMD_RANKS):
            rank, err, out = results.get(timeout=SPMD_TIMEOUT_S)
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
            res[rank] = out
        if errors:
            raise AssertionError("spmd world of two failed:\n"
                                 + "\n".join(errors))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise AssertionError(f"spmd ranks exited with {bad}")

    for key, learn_key in (("k5", "learns"), ("k7", "lo_learns"),
                           ("k8", "learns"), ("k9", "learns")):
        a, b = (r[key] for r in res)
        for i, (x, y, sa, sb) in enumerate(zip(a["sets"], b["sets"],
                                               a["solo_sets"],
                                               b["solo_sets"])):
            if not np.array_equal(x, y):
                raise AssertionError(f"{key} set {i}: replicas differ")
            mean = (sa + sb) / np.float32(2.0)
            if not np.array_equal(x, mean):
                raise AssertionError(
                    f"{key} set {i}: not the mean of the solo runs, max "
                    f"|diff| {float(np.abs(x - mean).max())}")
        for r in res:
            c, sc = r[key]["counts"], [x[key]["solo_counts"] for x in res]
            if not r[key]["lanes_equal_solo"]:
                raise AssertionError(f"{key} rank {r['rank']}: lanes differ "
                                     "from its solo run")
            if c[learn_key] != sc[0][learn_key] or any(
                    c[k] != sc[0][k] + sc[1][k]
                    for k in ("episodes", "wins", "collisions")):
                raise AssertionError(f"{key}: counts {c} vs solos {sc}")
            if c["env_steps"] != SPMD_T * SPMD_RANKS * N_TRAIN:
                raise AssertionError(f"{key}: env_steps {c['env_steps']}")
            if not (c[learn_key] > 0 and c["episodes"] > 0):
                raise AssertionError(f"{key}: nothing learned or finished")
    # K8's running max priority is the larger of the two solo maxima, and
    # its noise is each rank's own.
    maxp = np.maximum(res[0]["k8"]["row13"][1], res[1]["k8"]["row13"][1])
    for r in res:
        if not np.array_equal(r["k8"]["row13"][0], maxp):
            raise AssertionError(f"K8 rank {r['rank']}: row 13 is not the "
                                 "ranks' maximum")
    if not maxp.min() > 1.0:
        raise AssertionError("K8: the running max priority never moved")
    if np.array_equal(res[0]["k8"]["noise"][0], res[1]["k8"]["noise"][0]):
        raise AssertionError("K8: both ranks hold the same noise")
    for i, (x, y) in enumerate(zip(res[0]["tp_replicated"],
                                   res[1]["tp_replicated"])):
        if not np.array_equal(x, y):
            raise AssertionError(f"tensor-parallel replica {i} differs")
    launches = {}
    for r in res:
        add_counts(launches, r.pop("launches"))
        for key in ("k5", "k7", "k8", "k9"):
            r[key] = {"counts": r[key]["counts"]}
        r.pop("tp_replicated")
    return res, launches


DRYRUN_TAGS = ("OK", "FUSED OK", "RAINBOW OK", "HDQN OK", "DRQN OK",
               "CKPT OK")


def dryrun_on_card(np):
    """``python -m merging_gym_tpu_torch.parallel.dryrun`` at
    ``SPMD_RANKS`` processes on this card (gloo: more ranks than cards;
    kernels already built): every tag on every rank with equal
    checksums.  Returns each rank's lines and the summed launches."""
    procs, outs = [], []
    port = free_port()
    with tempfile.TemporaryDirectory() as ckpt:
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        for r in range(SPMD_RANKS):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "merging_gym_tpu_torch.parallel.dryrun",
                 str(r), str(SPMD_RANKS), str(port), "--ckpt-dir", ckpt],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        try:
            for p in procs:
                outs.append(p.communicate(timeout=SPMD_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise AssertionError(f"dryrun ranks failed {bad}:\n"
                             + "\n".join(o[-3000:] for o in outs))
    lines, launches = {}, {}
    for r, out in enumerate(outs):
        for ln in out.splitlines():
            if ln.startswith(f"PROC{r} LAUNCHES "):
                add_counts(launches, json.loads(ln.split(" ", 2)[2]))
            elif ln.startswith(f"PROC{r} "):
                lines.setdefault(r, []).append(ln)
    for tag in DRYRUN_TAGS:
        got = [ln for r in range(SPMD_RANKS) for ln in lines.get(r, [])
               if ln.startswith(f"PROC{r} {tag} env_steps=")]
        if len(got) != SPMD_RANKS or len({ln.split(" ", 1)[1]
                                          for ln in got}) != 1:
            raise AssertionError(f"dryrun {tag}: {got}")
    return lines, launches


def rainbow_path(cli, tmp, evaluate, rainbow_policy, l0_policy, EnvParams,
                 load_params_npz, rainbow_params_from_numpy, torch, dev):
    """The Rainbow training path through the port's CLI, then ``evaluate``
    of ``rainbow_policy`` against L0 for the zoo's fused-trained net and
    the trained one; returns the run directories and the two results."""
    fused, per, loop = (os.path.join(tmp, d) for d in
                        ("rb_fused", "rb_per", "rb_loop"))
    cli.main(["train", "--algo", "rainbow", "--fused-kernel", "--max-chunks",
              "5", "--episodes", BIG, "--out", fused])
    cli.main(["train", "--algo", "rainbow", "--fused-kernel", "--per",
              "--n-step", "3", "--obs-scale", "0.01", "--max-chunks", "2",
              "--episodes", BIG, "--out", per])
    cli.main(["train", "--algo", "rainbow", "--opponent", "selfplay",
              "--max-chunks", "2", "--episodes", BIG, "--out", loop])

    def match(path, scale):
        pol = rainbow_policy(rainbow_params_from_numpy(
            load_params_npz(path), dev), obs_scale=scale)
        return evaluate(pol, l0_policy(), EnvParams(),
                        torch.Generator(device=dev).manual_seed(0),
                        num_envs=N_ENVS_HDQN, min_episodes=256,
                        chunk_steps=512, max_chunks=8)

    zoo = match(ZOO_RB, 0.01)
    trained = match(os.path.join(fused, "params.npz"), None)
    runs = {"rainbow train --fused-kernel": (fused, 5, "learns"),
            "rainbow train --fused-kernel --per --n-step 3": (per, 2,
                                                              "learns"),
            "rainbow train (step loop)": (loop, 2, "learns")}
    return runs, zoo, trained


def mlp_cases(params, hdqn_nets, b_hdqn):
    """(label, params, input width, batches) of a Q-net kernel's checks:
    the zoo net at the evaluation shapes, and the h-DQN meta (10 -> 3) and
    low (11 -> 5) nets at the h-DQN path's batch."""
    meta, low = hdqn_nets
    return [("10->5", params, 10, (*QNET_BATCHES, B_RAGGED, B_TAIL)),
            ("10->3", meta, 10, (b_hdqn,)), ("11->5", low, 11, (b_hdqn,))]


def check_k3(checks, torch, FM, params, hdqn_nets, dev, rng):
    """K3 against its plain version (exact); 256 envs is the batch of the
    ``evaluate(hdqn_policy)`` main path."""
    for what, p, d_in, batches in mlp_cases(params, hdqn_nets, N_ENVS_HDQN):
        for b in batches:
            x = torch.as_tensor(rng.standard_normal((b, d_in)) * 100,
                                dtype=torch.float32, device=dev)
            for cd in ("float32", "bfloat16"):
                checks.equal("K3", f"{what} B={b} {cd}",
                             FM.qnet_apply_fused(p, x, cd),
                             FM.qnet_apply_plain(p, x, cd))
    print("K3: 10->5 at B=256, 1024, 4096, 1001 and 1025, h-DQN 10->3 and "
          "11->5 at B=256, f32 and bf16 equal", flush=True)


def check_k4(checks, torch, FA, FM, params, hdqn_nets, dev, rng):
    """K4 against its plain version (exact), and its kept-greedy share;
    1,024 envs is the batch of the step-loop h-DQN main path."""
    for what, p, d_in, batches in mlp_cases(params, hdqn_nets, N_TRAIN):
        for b in batches:
            x = torch.as_tensor(rng.standard_normal((b, d_in)) * 100,
                                dtype=torch.float32, device=dev)
            for cd in ("float32", "bfloat16"):
                checks.equal("K4", f"{what} B={b} {cd}",
                             FA.fused_eps_greedy_actions(p, x, 5, 0.7, cd),
                             FA.fused_eps_greedy_actions_plain(p, x, 5, 0.7,
                                                               cd))
    # Share of rows where the greedy arm was kept, from the kernel's
    # actions: match = kept + (1 - kept) / A over 8 seeds x 4,096 rows.
    x = torch.as_tensor(rng.standard_normal((B_MLP, 10)) * 100,
                        dtype=torch.float32, device=dev)
    greedy = FM.qnet_apply_fused(params, x).argmax(dim=1)
    match = sum((FA.fused_eps_greedy_actions(params, x, s) == greedy)
                .float().mean().item() for s in range(8)) / 8
    a = 5
    kept = (match - 1.0 / a) / (1.0 - 1.0 / a)
    if abs(kept - FA.phi(0.7)) > 0.01:
        raise AssertionError(f"K4 greedy share {kept:.4f}, expected "
                             f"{FA.phi(0.7):.4f} +- 0.01")
    print(f"K4: 10->5 at B=256, 1024, 4096, 1001 and 1025, h-DQN 10->3 and "
          f"11->5 at B=1024, "
          f"f32 and bf16 equal; greedy share "
          f"{kept:.4f} (Phi(0.7) = {FA.phi(0.7):.4f})", flush=True)
    return kept


def k6_cases(EnvParams, qnet_init, torch, p_l2, p_l1, dev):
    """K6's checks, ``{label: (steps, envs, params1, params2, kwargs)}``:
    every mode at 4,096 envs x ``T_POLICY`` (32 envs a block, both nets
    resident), and every other geometry choice of the main paths and the
    card tests at full width: ragged blocks (4,097 envs; 200 envs, 2 a
    block), one net (L0), self-play, and nets too wide to stay resident
    (``--hidden 1024 512``), which stream every step."""
    g = torch.Generator(device=dev).manual_seed(11)
    wide = qnet_init(g, 10, 5, hidden=(1024, 512))
    wide2 = qnet_init(g, 10, 5, hidden=(1024, 512))
    t, n = T_POLICY, N_ENVS
    return {
        "greedy vs L0": (t, n, p_l2, None, dict(greedy=True)),
        # Greedy L2 vs L1 both brake from the deterministic start; a
        # 300-step cap makes the timeout and auto-reset part of the check.
        "greedy L2 vs L1": (t, n, p_l2, p_l1, dict(
            greedy=True, env_params=EnvParams(max_steps=300))),
        "phi-greedy L2 vs L1": (t, n, p_l2, p_l1, dict(greedy=False, seed=1)),
        "random_start": (t, n, p_l2, p_l1, dict(
            greedy=False, seed=2, env_params=EnvParams(random_start=True))),
        "bf16": (t, n, p_l2, p_l1, dict(greedy=False, seed=3,
                                        compute_dtype="bfloat16")),
        "phi-greedy vs L0": (300, n, p_l2, None, dict(greedy=False, seed=4)),
        "self-play": (300, n, p_l2, p_l2, dict(greedy=False, seed=5)),
        "4,097 envs": (300, n + 1, p_l2, p_l1, dict(greedy=False, seed=6)),
        "4,097 envs bf16": (300, n + 1, p_l2, p_l1, dict(
            greedy=False, seed=7, compute_dtype="bfloat16")),
        "200 envs": (300, 200, p_l2, p_l1, dict(greedy=False, seed=8)),
        "200 envs bf16 vs L0": (300, 200, p_l2, None, dict(
            greedy=False, seed=9, compute_dtype="bfloat16")),
        "streamed 1024x512": (16, n, wide, wide2, dict(greedy=False,
                                                       seed=10)),
        "streamed 1024x512 bf16": (16, n, wide, wide2, dict(
            greedy=False, seed=11, compute_dtype="bfloat16")),
    }


def check_k6(checks, torch, FPR, cases):
    """K6 against its plain version, bit for bit: every event and reward,
    in each case of :func:`k6_cases`; prints each case's geometry and its
    max |kernel - plain| over the rewards."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for what, (t, n, pa, pb, kw) in cases.items():
        got = FPR.fused_policy_rollout(t, n, pa, pb, **kw)
        want = FPR.fused_policy_rollout_plain(t, n, pa, pb, **kw)
        checks.events("K6", what, got, want,
                      ("actions", "done", "winner", "collision", "rewards"),
                      {})
        w = pa["fc1"]["w"]
        elem = 2 if kw.get("compute_dtype") == "bfloat16" else 4
        g = FPR.policy_geometry(n, (10, w.shape[0], w.shape[1], 5), elem,
                                sms, pb is not None)
        err = (got["rewards"] - want["rewards"]).abs().max().item()
        print(f"K6 {what} ({t} x {n}, {g.rows} envs a block, "
              f"{g.rm}x{g.rn}, {'resident' if g.resident else 'streamed'}): "
              f"{int(got['done'].sum())} episodes agree, max_abs_err {err}",
              flush=True)


def k6_sweep(torch, FPR, FM, p1, p2, EnvParams, dev):
    """K6 as ``eval --fused`` plays (Phi-greedy L2 vs L1, f32, seed 1) at
    4,096 envs x ``T_POLICY``, CUDA-event ms, at 8, 16 and 32 envs a block with every micro-tile of
    ``FM.QNET_TILES`` that fits (RM <= rows), beside what
    ``policy_geometry`` picks: the readings its rule stands on.  Each
    geometry's events must equal the picked one's, which ``check_k6``'s
    "phi-greedy L2 vs L1" holds against the plain version."""
    w1 = FM.cast_weights(p1, torch.float32, dev)
    w2 = FM.cast_weights(p2, torch.float32, dev)
    dims = (w1[0].shape[0], w1[0].shape[1], w1[2].shape[1], w1[4].shape[1])
    kw = dict(greedy=False, epsilon=0.7, seed=1, env_params=EnvParams())
    want = FPR.fused_policy_rollout(T_POLICY, N_ENVS, p1, p2, **kw)
    ev = FPR.empty_events(T_POLICY, N_ENVS, dev)
    times = {}
    for rows in (8, 16, 32):
        base = FPR.policy_tiling(dims, rows, 4, 2)
        for rm, rn in FM.QNET_TILES:
            if rm > rows:
                continue
            g = base._replace(rm=rm, rn=rn)
            FPR.launch_policy_rollout(ev, w1, w2, geometry=g, **kw)
            for k in want:
                if not torch.equal(ev[k], want[k].to(ev[k].dtype)):
                    raise AssertionError(f"K6 at {g} differs in {k}")
            times[f"{rows} {rm}x{rn}"] = cuda_ms(
                torch, lambda: FPR.launch_policy_rollout(ev, w1, w2,
                                                         geometry=g, **kw),
                5)
    picked = FPR.policy_geometry(
        N_ENVS, dims, 4, torch.cuda.get_device_properties(
            dev).multi_processor_count, True)
    return {"picked": picked._asdict(), "ms": times}


def numpy_outcomes(np, done, winner, collision, rewards):
    """``evaluate_fused``'s reduction as the JAX package takes it
    (``merging_gym_tpu/agents/evaluate.py:146-165``), on host arrays: the
    five counts and the two f32 return sums."""
    d = done
    counts = [int(d.sum()), int((d & (winner == 1)).sum()),
              int((d & (winner == 2)).sum()), int((d & collision).sum()),
              int((d & (winner == 0) & ~collision).sum())]
    T = d.shape[0]
    last_done = np.where(d.any(axis=0), T - 1 - d[::-1].argmax(axis=0), -1)
    in_finished = np.arange(T)[:, None] <= last_done[None, :]
    return counts, (rewards * in_finished[:, None, :]).sum(axis=(0, 2))


def eval_fused_split(torch, np, FPR, FR, FM, load_params_npz,
                     qnet_params_from_numpy, EnvParams, fused_outcomes, dev,
                     reps=3):
    """``eval --fused`` of model_zoo/L2 vs L1 at 4,096 x ``T_EVAL`` split
    by phase, host ms around synchronised steps, median over ``reps``:
    npz load and weight cast, output allocation, the kernel, the bool
    events (``as_events``), then the host reduction of the JAX package
    (the copy of done, winner, collision and rewards, and numpy) and,
    where ``fused_outcomes`` is given, the reduction on the card with its
    one read-back.  The counts must agree exactly and the card's f32
    return sums must be within rtol 1e-6 of an f64 sum of the same rewards;
    each f32 sum's relative error against the f64 one, and the card's
    against numpy's, are printed."""
    def clock(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    kw = dict(greedy=False, epsilon=0.7, seed=0, env_params=EnvParams())
    rows, check = [], {}
    for _ in range(reps):
        r = {}

        def load():
            ps = [qnet_params_from_numpy(load_params_npz(f), dev)
                  for f in (ZOO_L2, ZOO_L1)]
            return [FM.cast_weights(p, torch.float32, dev) for p in ps]
        (w1, w2), r["load_cast"] = clock(load)
        out, r["alloc"] = clock(lambda: FPR.empty_events(T_EVAL, N_ENVS, dev))
        _, r["kernel"] = clock(lambda: FPR.launch_policy_rollout(
            out, w1, w2, **kw))
        ev, r["as_events"] = clock(lambda: FR.as_events(out))
        keys = ("done", "winner", "collision", "rewards")
        host, r["copy"] = clock(lambda: [ev[k].cpu().numpy() for k in keys])
        (counts, ret), r["reduce_numpy"] = clock(
            lambda: numpy_outcomes(np, *host))
        r["host_path"] = r["copy"] + r["reduce_numpy"]
        if fused_outcomes is not None:
            sums, r["reduce_card"] = clock(lambda: fused_outcomes(
                *(ev[k] for k in keys)))
            sums, r["readback"] = clock(lambda: sums.tolist())
            r["card_path"] = r["reduce_card"] + r["readback"]
            f64 = numpy_outcomes(np, *host[:3], host[3].astype(np.float64))[1]
            card = np.asarray(sums[5:])
            check = {"counts": counts, "return_sums_card": sums[5:],
                     "return_sums_numpy_f32": ret.tolist(),
                     "return_sums_f64": f64.tolist(),
                     "rel_err_card": (abs(card - f64) / abs(f64)).tolist(),
                     "rel_err_numpy": (abs(ret - f64) / abs(f64)).tolist(),
                     "rel_card_vs_numpy": (abs(card - ret)
                                           / abs(ret)).tolist()}
            if sums[:5] != counts:
                raise AssertionError(f"card counts {sums[:5]} != {counts}")
            if not np.allclose(card, f64, rtol=1e-6, atol=0.0):
                raise AssertionError(f"card return sums off the f64 sums: "
                                     f"{check}")
        rows.append(r)
    split = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
    return {"ms": split, "reductions": check}


def qnet_batch_times(torch, FM, FA, params, dev, rng, reps=50):
    """K3 and K4 beside their library calls (three ``addmm`` + ReLU; K4:
    and ``argmax``) at each main-path batch, f32, in ms: CUDA-event medians
    of one call (``cuda_ms``, host launch time included), the device time
    alone (``*_device_ms``, ``graph_ms``), and the bound of the work (x,
    weights and the output once)."""
    w = FM.cast_weights(params, torch.float32, dev)
    dims = (w[0].shape[0], w[0].shape[1], w[2].shape[1], w[4].shape[1])
    w_bytes = sum(t.numel() * 4 for t in w)
    out = {}
    for b in QNET_BATCHES:
        x = torch.as_tensor(rng.standard_normal((b, dims[0])) * 100,
                            dtype=torch.float32, device=dev)
        q = torch.empty(b, dims[3], device=dev)
        acts = torch.empty(b, dtype=torch.int32, device=dev)

        def library():
            h = torch.relu(torch.addmm(w[1], x, w[0]))
            h = torch.relu(torch.addmm(w[3], h, w[2]))
            return torch.addmm(w[5], h, w[4])
        calls = {"k3": lambda: FM.launch_mlp(w, x, q),
                 "k3_library": library,
                 "k4": lambda: FA.launch_actor(w, x, acts, 5, 0.7),
                 "k4_library": lambda: library().argmax(dim=1)}
        row = {f"{k}_ms": cuda_ms(torch, f, reps) for k, f in calls.items()}
        row.update({f"{k}_device_ms": graph_ms(torch, f)
                    for k, f in calls.items()})
        row["bound_ms"], _ = bound(b * (dims[0] + dims[3]) * 4 + w_bytes,
                                   b * mlp_flops(*dims))
        out[str(b)] = row
    return out


def qnet_rows_times(torch, FM, params, dev, rng):
    """K3's device time (``graph_ms``, f32, ms) at each main-path batch
    for every power of two of rows per block up to ``FM.QNET_ROWS_MAX``,
    each with ``qnet_tiling``'s micro-tile and chunk, beside the rows
    ``qnet_geometry`` picks: the readings its rule stands on.  Each
    geometry's q must equal the picked one's."""
    w = FM.cast_weights(params, torch.float32, dev)
    dims = (w[0].shape[0], w[0].shape[1], w[2].shape[1], w[4].shape[1])
    out = {}
    for b in QNET_BATCHES:
        x = torch.as_tensor(rng.standard_normal((b, dims[0])) * 100,
                            dtype=torch.float32, device=dev)
        want = FM.qnet_apply_fused(params, x)
        q = torch.empty_like(want)
        times, rows = {}, 1
        while rows <= FM.QNET_ROWS_MAX:
            g = FM.qnet_tiling(dims, rows, 4)
            if g is not None:
                FM.launch_mlp(w, x, q, g)
                if not torch.equal(q, want):
                    raise AssertionError(f"K3 at {g} differs at B={b}")
                times[str(rows)] = graph_ms(
                    torch, lambda: FM.launch_mlp(w, x, q, g))
            rows *= 2
        picked = FM.qnet_geometry(b, dims, 4, FM.sm_count(dev)).rows
        out[str(b)] = {"picked_rows": picked, "device_ms": times}
    return out


def kernel_split(torch, kernels, launch, dev):
    """Device time of each kernel that ``launch()`` issues, in launch
    order: every C entry point it calls is timed where it is called (the
    call's tensors are alive then) by ``graph_ms`` on the same arguments,
    then called once for real.  Returns ``[[entry point, ms], ...]``.  It
    needs only ``kernels.function``, so it times a parent's package too."""
    split = []
    real = kernels.function

    def timing(lib, name, argtypes):
        fn = real(lib, name, argtypes)

        def call(*args):
            def again():
                rc = fn(*args[:-1], kernels.stream_ptr(dev))
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            split.append([name, graph_ms(torch, again)])
            return fn(*args)
        return call
    kernels.function = timing
    try:
        launch()
        torch.cuda.synchronize()
    finally:
        kernels.function = real
    return split


def addmm_chain_ms(torch, dev, nets, rows):
    """Device ms (``graph_ms``) of the ``torch.addmm`` + ReLU chains of
    Q-nets of widths ``nets`` on ``rows`` rows each, one after the other
    (random f32 weights and inputs): one library call a layer for the
    forwards of an act kernel, as K3's library time is taken."""
    g = torch.Generator(device=dev).manual_seed(0)
    chains = []
    for d in nets:
        w = [torch.randn(k, j, generator=g, device=dev) * 0.1
             for k, j in zip(d[:3], d[1:])]
        b = [torch.randn(j, generator=g, device=dev) * 0.1 for j in d[1:]]
        chains.append((torch.randn(rows, d[0], generator=g, device=dev), w,
                       b))

    def run():
        for x, w, b in chains:
            h = torch.relu(torch.addmm(b[0], x, w[0]))
            h = torch.relu(torch.addmm(b[1], h, w[1]))
            torch.addmm(b[2], h, w[2])
    return graph_ms(torch, run)


def act_numbers(torch, dev, split, nets):
    """The act kernel of a split step (its first launch) beside its bound,
    ``mlp_flops`` of the forwards ``nets`` x 1,024 envs at the f32 rate,
    and the library's ``addmm`` chains of the same forwards."""
    return {"act_ms": split[0][1],
            "act_bound_ms": bound(0, N_TRAIN * sum(mlp_flops(*d)
                                                   for d in nets))[0],
            "act_library_ms": addmm_chain_ms(torch, dev, nets, N_TRAIN)}


def trainer_split(torch, np, kernels, FT, FH, D, H, EnvParams, dev):
    """One warm step of K5 and of K7 at the CLI defaults (L0, 1,024 envs,
    B 1,024) split by kernel (``kernel_split``): device ms of each launch,
    launches per warm step, their sum, the act kernel beside its bound and
    the library's forwards (``act_numbers``: K5 one forward, K7 the upper,
    lower and upper nets), and one learn (every launch after the act
    kernel; K7: each of its two learners) beside its bound, ``learn_flops``
    x B at the f32 rate; and the time per step of a warm 200-step chunk
    (CUDA events, host launches included)."""
    ep = EnvParams()
    out = {}
    cfg = D.DQNConfig(memory_capacity=4 * N_TRAIN)
    carry = FT.fused_dqn_chunk(cfg, ep, FT.fused_dqn_init(
        0, cfg, ep, N_TRAIN, device=dev), 20, 0)
    st = FT.working_state(carry, torch.float32)
    zeros = np.zeros(carry["K"], np.int32)
    split = kernel_split(torch, kernels, lambda: FT.launch_trainer(
        st, carry, cfg, ep, 1, 1, False, zeros, zeros), dev)
    r = np.random.default_rng(1)
    rounds = r.integers(0, carry["R"], T_CHUNK).astype(np.int32)
    cols = np.zeros(T_CHUNK, np.int32)
    chunk_ms = cuda_ms(torch, lambda: FT.launch_trainer(
        st, carry, cfg, ep, T_CHUNK, 1, False, rounds, cols), 3)
    dims = (10, 200, 100, 5)
    out["K5"] = {"kernels": split, "launches_per_warm_step": len(split),
                 "chunk_step_ms": chunk_ms / T_CHUNK,
                 "step_device_ms": sum(ms for _, ms in split),
                 "learn_ms": sum(ms for _, ms in split[1:]),
                 "learn_bound_ms": bound(0, carry["B"] * learn_flops(*dims))[0],
                 **act_numbers(torch, dev, split, (dims,))}
    hcfg = H.HDQNConfig(memory_capacity=4 * N_TRAIN,
                        goal_memory_capacity=2 * N_TRAIN)
    hcarry = FH.fused_hdqn_chunk(hcfg, ep, FH.fused_hdqn_init(
        0, hcfg, ep, N_TRAIN, device=dev), 20, 0)
    hst = FH.working_state(hcarry, torch.float32)
    up0 = FH.upper_learns(hst["state"])
    z = np.zeros(1, np.int64)
    split = kernel_split(torch, kernels, lambda: FH.launch_hdqn(
        hst, hcarry, hcfg, ep, 1, 1, False, z, z, np.zeros(2, np.int64)),
        dev)
    fired = FH.upper_learns(hst["state"]) - up0
    streams = (r.integers(0, hcarry["R_lo"], T_CHUNK),
               r.integers(0, hcarry["R_up"], T_CHUNK),
               np.zeros(2 * T_CHUNK, np.int64))
    chunk_ms = cuda_ms(torch, lambda: FH.launch_hdqn(
        hst, hcarry, hcfg, ep, T_CHUNK, 1, False, *streams), 3)
    half = (len(split) - 1) // 2
    B = hcarry["B"]
    out["K7"] = {"kernels": split, "launches_per_warm_step": len(split),
                 "chunk_step_ms": chunk_ms / T_CHUNK,
                 "upper_fired": fired,
                 "step_device_ms": sum(ms for _, ms in split),
                 "lower_learn_ms": sum(ms for _, ms in split[1:1 + half]),
                 "upper_learn_ms": sum(ms for _, ms in split[1 + half:]),
                 "lower_learn_bound_ms": bound(
                     0, B * learn_flops(11, 200, 100, 5))[0],
                 "upper_learn_bound_ms": bound(
                     0, B * learn_flops(10, 200, 100, 3))[0],
                 **act_numbers(torch, dev, split, ((10, 200, 100, 3),
                                                   (11, 200, 100, 5),
                                                   (10, 200, 100, 3)))}
    return out


def act_geometry_sweep(torch, np, kernels, FT, FH, FM, D, H, EnvParams,
                       dev):
    """One act launch of K5 and of K7 at the training CLI's defaults (L0,
    1,024 envs, f32; step 0 of a cold carry, which launches the act kernel
    alone), device ms by ``kernel_split``: at 4, 8, 16 and 32 envs a block
    with every micro-tile of ``FM.QNET_TILES`` that fits (RM <= rows), the
    nets held as ``act_tiling`` holds them, and at the picked rows and tile
    with every net streamed, beside what ``act_geometry`` picks: the
    readings its rule stands on.  Each geometry's step must equal the
    picked one's, which ``check_k5`` and ``check_k7`` hold against the
    plain versions."""
    ep, n = EnvParams(), N_TRAIN
    z = np.zeros(1, np.int32)
    cfg = D.DQNConfig(memory_capacity=4 * n)
    carry = FT.fused_dqn_init(0, cfg, ep, n, device=dev)
    hcfg = H.HDQNConfig(memory_capacity=4 * n, goal_memory_capacity=2 * n)
    hcarry = FH.fused_hdqn_init(0, hcfg, ep, n, device=dev)
    trainers = {
        "K5": (((10, 200, 100, 5),), ("env", "ring", "met"),
               lambda: FT.working_state(carry, torch.float32),
               lambda st, g: FT.launch_trainer(st, carry, cfg, ep, 1, 1,
                                               False, z, z, act_geom=g)),
        "K7": (((10, 200, 100, 3), (11, 200, 100, 5)),
               ("state", "lo_ring", "up_ring", "met"),
               lambda: FH.working_state(hcarry, torch.float32),
               lambda st, g: FH.launch_hdqn(st, hcarry, hcfg, ep, 1, 1,
                                            False, z, z,
                                            np.zeros(2, np.int32),
                                            act_geom=g))}
    out = {}
    for name, (nets, keys, state, launch) in trainers.items():
        picked = FT.act_geometry(n, nets, 4, FM.sm_count(dev))
        want = state()
        launch(want, picked)

        def time(g):
            st = state()
            launch(st, g)
            for k in keys:
                if not torch.equal(st[k], want[k]):
                    raise AssertionError(f"{name}'s act kernel at {g} "
                                         f"differs in {k}")
            return kernel_split(torch, kernels, lambda: launch(state(), g),
                                dev)[0][1]
        times = {}
        for rows in (4, 8, 16, 32):
            base = FT.act_tiling(nets, rows, 4)
            for rm, rn in FM.QNET_TILES:
                if rm <= rows:
                    times[f"{rows} {rm}x{rn}"] = time(base._replace(rm=rm,
                                                                    rn=rn))
        streamed = FT.act_tiling(nets, picked.rows, 4, resident=0)._replace(
            rm=picked.rm, rn=picked.rn)
        out[name] = {"picked": picked._asdict(), "device_ms": times,
                     "streamed_ms": time(streamed)}
    return out


def rb_chain_ms(torch, dev, rows):
    """Device ms (``graph_ms``) of the library's eager chain of K8's acting
    forward on ``rows`` rows (random f32 weights and inputs): ``addmm`` +
    ReLU for the trunk, value1 and advantage1, ``addmm`` for value2 and
    advantage2, the dueling combine, ``torch.softmax`` and E[Z] as one
    product with the support."""
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev) * 0.1
    x = rnd(rows, 10)
    w = {name: (rnd(k, j), rnd(j)) for name, (k, j) in zip(
        ("l1", "l2", "v1", "v2", "a1", "a2"), RB_LAYERS)}
    z = torch.linspace(-10.0, 10.0, 51, device=dev)

    def run():
        h = torch.relu(torch.addmm(w["l1"][1], x, w["l1"][0]))
        h = torch.relu(torch.addmm(w["l2"][1], h, w["l2"][0]))
        hv = torch.relu(torch.addmm(w["v1"][1], h, w["v1"][0]))
        ha = torch.relu(torch.addmm(w["a1"][1], h, w["a1"][0]))
        zv = torch.addmm(w["v2"][1], hv, w["v2"][0])
        adv = torch.addmm(w["a2"][1], ha, w["a2"][0]).view(-1, 5, 51)
        logits = zv[:, None] + adv - adv.mean(dim=1, keepdim=True)
        return torch.softmax(logits, dim=-1) @ z
    return graph_ms(torch, run)


def drqn_chain_ms(torch, dev, rows):
    """Device ms (``graph_ms``) of the library's eager chain of K9's
    recurrent acting forward on ``rows`` rows (random f32 weights, inputs
    and state): ``addmm`` + ReLU (fc1), ``addmm`` (fc2),
    ``torch.lstm_cell``, ``addmm`` + ReLU (fc3), ``addmm`` (fc4)."""
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev) * 0.1
    x, h, c = rnd(rows, 10), rnd(rows, 16), rnd(rows, 16)
    w1, b1, w2, b2 = rnd(10, 200), rnd(200), rnd(200, 16), rnd(16)
    wih, whh, bih, bhh = rnd(64, 16), rnd(64, 16), rnd(64), rnd(64)
    w3, b3, w4, b4 = rnd(16, 16), rnd(16), rnd(16, 5), rnd(5)

    def run():
        x2 = torch.addmm(b2, torch.relu(torch.addmm(b1, x, w1)), w2)
        hn, _ = torch.lstm_cell(x2, (h, c), wih, whh, bih, bhh)
        return torch.addmm(b4, torch.relu(torch.addmm(b3, hn, w3)), w4)
    return graph_ms(torch, run)


def drqn_split(torch, np, kernels, FD, DR, EnvParams, dev):
    """One warm K9 learning step at the CLI defaults (L0, 1,024 envs, L 16,
    burn-in 4, R 4, B 1,024, f32) split by kernel (``kernel_split``):
    device ms of each launch, launches per learning step, their sum, one
    learn (every launch after the act kernel) beside its bound
    (``drqn_learn_flops`` on the windows that step samples), the act
    kernel beside its bound (``drqn_forward_flops`` x 1,024 envs at the f32
    rate) and the library's eager chain of the same forward
    (``drqn_chain_ms``); and the time per step of a warm 200-step chunk
    (CUDA events, host launches included).  It calls only what every
    version of ``ops.fused_drqn`` has, so it splits a parent's step
    too."""
    ep = EnvParams()
    cfg = DR.DRQNConfig(memory_capacity=4 * N_TRAIN)
    carry = FD.fused_drqn_chunk(cfg, ep, FD.fused_drqn_init(
        0, cfg, ep, N_TRAIN, device=dev), T_CHUNK, 0)
    st = FD.working_state(carry)
    one, zero = np.ones(1, np.int32), np.zeros(1, np.int32)
    split = kernel_split(torch, kernels, lambda: FD.launch_drqn(
        st, carry, cfg, ep, 1, 1, False, one, zero), dev)
    L, B = carry["L"], carry["B"]
    done = carry["ring"].reshape(carry["R"], L + 1, FD.SLOT, N_TRAIN)[
        1, 1:, FD.IN_DIM + 2, :B].T.cpu().numpy()            # [B, L]
    r = np.random.default_rng(4)
    rounds = r.integers(0, carry["R"], T_CHUNK).astype(np.int32)
    cols = np.zeros(T_CHUNK, np.int32)
    chunk_ms = cuda_ms(torch, lambda: FD.launch_drqn(
        st, carry, cfg, ep, T_CHUNK, 1, False, rounds, cols), 3)
    return {"kernels": split, "launches_per_learning_step": len(split),
            "step_device_ms": sum(ms for _, ms in split),
            "learn_ms": sum(ms for _, ms in split[1:]),
            "learn_bound_ms": bound(0, drqn_learn_flops(done,
                                                        cfg.burn_in))[0],
            "act_ms": split[0][1],
            "act_bound_ms": bound(0, N_TRAIN * drqn_forward_flops())[0],
            "act_library_ms": drqn_chain_ms(torch, dev, N_TRAIN),
            "chunk_step_ms": chunk_ms / T_CHUNK}


def drqn_learn_sweep(torch, kernels, FD, FM, DR, EnvParams, dev):
    """One K9 learn at the CLI defaults (B 1,024, L 16), device ms by
    ``graph_ms``: at every input-side rows per block (16-128), every
    recurrence windows per block (1, 2, 4) and every gradient block size
    (``FD.GRAD_THREADS``), each with the picked rest, beside what
    ``learn_geometry`` picks: the readings its rule stands on.  Each
    geometry's parameters, moments and loss after one learn must equal the
    picked one's."""
    ep = EnvParams()
    cfg = DR.DRQNConfig(memory_capacity=4 * N_TRAIN)
    carry = FD.fused_drqn_chunk(cfg, ep, FD.fused_drqn_init(
        0, cfg, ep, N_TRAIN, device=dev), T_CHUNK, 0)
    B, L = carry["B"], carry["L"]

    def learn(lr):  # on the current stream (graph_ms captures it)
        lr.stream = kernels.stream_ptr(dev)
        lr.launch(cfg, 1, 0, False, 2)

    def time(g):
        lr = FD.Learner(FD.working_state(carry), B, L, g)
        learn(lr)
        if not all(torch.equal(lr.st[k], want.st[k]) for k in (
                "p", "tp", "m", "v", "loss")):
            raise AssertionError(f"the K9 learner at {g} differs")
        return graph_ms(torch, lambda: learn(lr))
    picked = FD.learn_geometry(B, L, FM.sm_count(dev))
    want = FD.Learner(FD.working_state(carry), B, L)
    learn(want)
    rows, windows = picked.in_rows, picked.rec_windows
    return {"picked": picked._asdict(),
            "device_ms_by_in_rows": {
                str(r): time(FD.learn_tiling(B, L, r, windows))
                for r in (16, 32, 64, 128)},
            "device_ms_by_rec_windows": {
                str(w): time(FD.learn_tiling(B, L, rows, w))
                for w in (1, 2, 4)},
            "device_ms_by_grad_threads": {
                str(t): time(FD.learn_tiling(B, L, rows, windows, t))
                for t in FD.GRAD_THREADS}}


RB_NUM_T = 29824       # the online net's transposed weights (rb_post)
RB_W1 = 32 * 64        # the trunk's w1, transposed by rb_post


def post_bytes(n, B, regen, sync, per_wb, check_sync):
    """Bytes ``rb_post`` must move in one call, f32 and i32 at 4 B, each
    input read once and each output written once.  Read: mu and sigma of
    both nets' noisy layers (the target's from tp, or from p on a sync),
    w1 (for its transpose), the noise where it is not redrawn, on a sync
    the rest of p (the copy), with the PER write-back the B CEs, their
    (round, lane) picks and env row 13, with the sync check the two
    episode counts.  Written: both nets' effective weights, the
    transposes, the noise where redrawn, tp on a sync, with the write-back
    B priorities and env row 13, with the sync check env row 11 and the
    total."""
    E = RB_ELEMS
    read = (2 * E + (0 if sync else 2 * E) + RB_W1 + (0 if regen else 2 * E)
            + (RB_PARAMS - 2 * E - RB_W1 if sync else 0)
            + (3 * B + n if per_wb else 0) + (2 if check_sync else 0))
    write = (2 * E + RB_NUM_T + (2 * E if regen else 0)
             + (RB_PARAMS if sync else 0) + (B + n if per_wb else 0)
             + (n + 1 if check_sync else 0))
    return 4 * (read + write)


def post_flops(regen):
    """f32 operations of ``rb_post`` on both nets: a multiply and an add
    per effective weight, a multiply per redrawn weight entry (f_out *
    f_in); the draws' Box-Muller and Philox work is not counted."""
    return 2 * 2 * RB_ELEMS + (2 * RB_ELEMS if regen else 0)


def pick_bytes(valid_rounds, n, B):
    """Bytes ``rb_per_pick`` must move: the priorities of the valid rounds
    (the masked ones are not needed), the offset, and the B (round, lane)
    picks and weights written."""
    return 4 * (valid_rounds * n + 1 + 3 * B)


def pick_flops(R, n, B):
    """Its f32 operations: the cdf's R * n adds and the chunk prefix, per
    target the offset (3), ~log2(R * n) compares of an add each, and the
    weight (2 powers of ~4 operations, 3 multiplies)."""
    N = R * n
    return N + N // 128 + B * (3 + 2 * max(N - 1, 1).bit_length() + 11)


def empty_kernel_ms(torch, kernels, dev):
    """Device ms of an empty one-block kernel by CUDA-graph replay: the
    floor under any launch's time (rainbow_trainer.cu:rb_empty_kernel)."""
    import ctypes
    fn = kernels.function("rainbow_trainer", "mgt_rb_empty",
                          [ctypes.c_void_p])

    def run():
        if fn(kernels.stream_ptr(dev)) != 0:
            raise RuntimeError("rb_empty_kernel launch failed")
    return graph_ms(torch, run)


def pick_library_ms(torch, ring, R, n, B, r_cur, stored, n_step, u0):
    """Device ms (``graph_ms``) of the library's version of the PER pick on
    the same ring: the masked grid by ``torch.where``, ``torch.cumsum``,
    ``torch.searchsorted`` of the B targets, clipped, and a gather of the
    picked priorities."""
    dev = ring.device
    age = (r_cur - torch.arange(R, device=dev) + R) % R
    valid = ((age >= n_step - 1) & (age <= stored - 1))[:, None]
    prio = ring.view(R, -1, n)[:, -1]
    steps = (torch.arange(B, dtype=torch.float32, device=dev) + u0) / B

    def run():
        P = torch.where(valid, prio, 0.0).reshape(-1)
        cdf = torch.cumsum(P, 0)
        idx = torch.searchsorted(cdf, cdf[-1] * steps, right=True)
        return P[idx.clamp_(max=R * n - 1)]
    return graph_ms(torch, run)


def post_library_ms(torch, FRB, st):
    """Device ms (``graph_ms``) of the library's version of the post on a
    working state's nets, the factors drawn beforehand (the library has no
    Philox Box-Muller): per net and noisy layer ``torch.outer`` of the
    factor vectors and the bias vector copied into the noise, ``torch.
    addcmul`` for the effective weights and biases; the online net's
    weights and w1 transposed by ``.t().contiguous()``."""
    dev = st["p"].device
    g = torch.Generator(device=dev).manual_seed(5)
    eps = [st["eps"].clone(), st["teps"].clone()]
    weff = [torch.empty_like(st["eps"]), torch.empty_like(st["teps"])]
    nets = [st["p"], st["tp"]]
    layers = list(zip(FRB.E_OFF, FRB.P_OFF, FRB.NOISY_OUT))
    fac = [[(torch.randn(64, generator=g, device=dev),
             torch.randn(o, generator=g, device=dev),
             torch.randn(o, generator=g, device=dev)) for _, _, o in layers]
           for _ in range(2)]
    w1 = FRB.IN_DIM * 32 + 32

    def run():
        for net in range(2):
            p, ep, we = nets[net], eps[net], weff[net]
            for (e0, p0, o), (fin, fout, fb) in zip(layers, fac[net]):
                w = 64 * o
                torch.outer(fin, fout, out=ep[e0:e0 + w].view(64, o))
                ep[e0 + w:e0 + w + o].copy_(fb)
                torch.addcmul(p[p0:p0 + w], p[p0 + w:p0 + 2 * w],
                              ep[e0:e0 + w], out=we[e0:e0 + w])
                torch.addcmul(p[p0 + 2 * w:p0 + 2 * w + o],
                              p[p0 + 2 * w + o:p0 + 2 * w + 2 * o],
                              ep[e0 + w:e0 + w + o],
                              out=we[e0 + w:e0 + w + o])
        out = [weff[0][e0:e0 + 64 * o].view(64, o).t().contiguous()
               for e0, _, o in layers]
        return out + [nets[0][w1:w1 + 2048].view(32, 64).t().contiguous()]
    return graph_ms(torch, run)


PICK_CASES = ((8, 1024, 32), (4, 128, 8), (8, 1024, 1024), (16, 4096, 32))
PICK_GRIDS = ("random", "zeros", "tied", "dominant")


def post_state(torch, np, FRB, dev, n, R, B, seed):
    """A working state for ``rb_post`` alone: random nets, noise, env rows
    and ring at ``n`` lanes and R rounds; B CEs and picks, the second pick
    a duplicate of the first with the same CE."""
    rng = np.random.default_rng(seed)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)
    st = {"p": f32(rng.standard_normal(FRB.NUM_P) * 0.1),
          "tp": f32(rng.standard_normal(FRB.NUM_P) * 0.1),
          "eps": f32(rng.standard_normal(FRB.NUM_E)),
          "teps": f32(rng.standard_normal(FRB.NUM_E)),
          "env": f32(rng.random((FRB.ENV_ROWS, n))),
          "ring": f32(rng.random((R * FRB.NUM_F, n)))}
    for k in ("wp", "wt"):
        st[k] = torch.full((FRB.NUM_E,), float("nan"), device=dev)
    st["wpt"] = torch.full((FRB.NUM_T,), float("nan"), device=dev)
    sel = torch.as_tensor(np.stack([rng.integers(0, R, B),
                                    rng.integers(0, n, B)]),
                          dtype=torch.int32, device=dev)
    ce = f32(rng.random(B) * 3)
    sel[:, 1], ce[1] = sel[:, 0], ce[0]
    return st, sel, ce


def pick_ring(torch, np, FRB, dev, R, n, kind, seed):
    """A ring of R rounds of ``n`` lanes whose priorities (row 23) are
    random, zero in 30% of the slots, in round 0's first chunk (where the
    round has more) and in the whole last round ("zeros"), all tied, or one
    slot dominant."""
    rng = np.random.default_rng(seed)
    ring = rng.random((R * FRB.NUM_F, n)).astype(np.float32)
    P = rng.random((R, n)).astype(np.float32) * 2
    if kind == "zeros":
        P[rng.random((R, n)) < 0.3] = 0.0
        P[0, :128 if n > 128 else 0] = 0.0
        P[R - 1] = 0.0
    elif kind == "tied":
        P[:] = 0.25
    elif kind == "dominant":
        P *= 1e-6
        P[R // 2, n - 1] = 1e3
    ring[FRB.NUM_F - 1::FRB.NUM_F] = P
    return torch.as_tensor(ring, device=dev)


def check_rb_post_pick(checks, torch, np, FRB, dev):
    """``rb_post`` and ``rb_per_pick`` alone against their plain versions
    (``post_plain``, ``pick_plain``), bit for bit, at the main paths'
    shapes.  The post at 1,024 lanes, R 8, B 32: the chunk-opening post,
    then every combination of the noise redraw, the target sync and the
    PER write-back, each run twice on fresh copies for the same bits.  The
    pick at (R, n, B) in PICK_CASES, each on the grids of ``pick_ring``,
    in the layout ``pick_geometry`` picks (the global cdf at R 16, n
    4,096) and at the CLI's shape in the global layout too."""
    n, R, B = N_TRAIN, 8, 32
    base, sel, ce = post_state(torch, np, FRB, dev, n, R, B, 21)
    key = FRB.philox.seed_key(77)
    inv_sync = float(np.float32(1.0 / 20))
    modes = [("chunk-opening", 0, 0, 0, 0, 0)] + [
        (f"regen {r} sync {s} per_wb {w}", 3, r, w, 1, 30 * s)
        for r in (0, 1) for s in (0, 1) for w in (0, 1)]
    for what, i, regen, per_wb, check_sync, ep in modes:
        tot = torch.zeros(5, dtype=torch.int32, device=dev)
        tot[i] = 37
        ep_step = torch.zeros(4, dtype=torch.int32, device=dev)
        ep_step[i] = ep
        want = {k: v.clone() for k, v in base.items()}
        want_tot = tot.clone()
        FRB.post_plain(want, want_tot, ep_step, ce, sel, i=i, regen=regen,
                       per_wb=per_wb, check_sync=check_sync, gstep=11,
                       key=key, alpha=0.6, inv_sync=inv_sync, synced0=1.0)
        for run in range(2):
            st = {k: v.clone() for k, v in base.items()}
            got_tot = tot.clone()
            FRB.post_launcher(st, got_tot, ep_step, ce, sel, B, key, 0.6,
                              inv_sync, 1.0)(i, regen, per_wb, check_sync,
                                             11)
            for k in want:
                checks.equal("K8", f"rb_post {what} {k}", st[k], want[k])
            checks.equal("K8", f"rb_post {what} tot", got_tot, want_tot)
        synced = not torch.equal(want["tp"], base["tp"])
        if synced != (ep > 0):
            raise AssertionError(f"rb_post {what}: sync {synced}")
    print(f"rb_post alone: {len(modes)} modes x 2 runs bit-equal to "
          "post_plain", flush=True)
    count = 0
    for (R, n, B), kind in ((c, k) for c in PICK_CASES for k in PICK_GRIDS):
        ring = pick_ring(torch, np, FRB, dev, R, n, kind, R * n + B)
        r_cur, stored, n_step = R // 2, R, 3
        us = torch.tensor([0.61], device=dev)
        want = FRB.pick_plain(ring, us, R, n, B, r_cur, stored, n_step, 0.4)
        layouts = [FRB.pick_geometry(R, n)]
        if (R, n, B) == PICK_CASES[0]:
            layouts.append(FRB.pick_tiling(R, n, FRB.PICK_GLOBAL))
        for g in layouts:
            sel = torch.zeros(2, B, dtype=torch.int32, device=dev)
            wts = torch.zeros(B, device=dev)
            FRB.pick_launcher(ring, sel, wts, B, n_step, 0.4, g)(
                r_cur, stored, us)
            what = f"rb_per_pick R {R} n {n} B {B} {kind} layout {g.layout}"
            checks.equal("K8", f"{what} sel", sel, want[0])
            checks.equal("K8", f"{what} wts", wts, want[1])
            count += 1
    if FRB.pick_geometry(16, 4096).layout != FRB.PICK_GLOBAL:
        raise AssertionError("R 16, n 4,096 did not take the global cdf")
    print(f"rb_per_pick alone: {count} cases bit-equal to pick_plain",
          flush=True)


def rb_post_pick_sweep(torch, np, kernels, FRB, dev):
    """``rb_post`` and ``rb_per_pick`` alone, device ms of one launch
    (``kernel_split``, so on the capturing stream).  The post at 1,024
    lanes, R 8, B 32 in each mode; the pick at R 8, n 1,024 with B 8, 32
    and 1,024 in both layouts, and at R 16, n 4,096, B 32 in the global
    one."""
    n, R, B = N_TRAIN, 8, 32
    base, sel, ce = post_state(torch, np, FRB, dev, n, R, B, 22)
    key = FRB.philox.seed_key(3)
    ep_step = torch.tensor([30], dtype=torch.int32, device=dev)

    def post(mode):
        st = {k: v.clone() for k, v in base.items()}
        tot = torch.tensor([37, 0], dtype=torch.int32, device=dev)
        eps = ep_step if mode[3] else ep_step * 0
        return kernel_split(torch, kernels, lambda: FRB.post_launcher(
            st, tot, eps, ce, sel, B, key, 0.6, float(np.float32(0.05)),
            1.0)(0, *mode[:3], 5), dev)[0][1]
    # (regen, per_wb, check_sync, sync)
    modes = {"chunk-opening": (0, 0, 0, 0), "greedy": (0, 0, 1, 0),
             "regen": (1, 0, 1, 0), "regen + sync": (1, 0, 1, 1),
             "regen + per_wb": (1, 1, 1, 0),
             "regen + sync + per_wb": (1, 1, 1, 1)}
    by_mode = {what: post(mode) for what, mode in modes.items()}
    by_pick = {}
    for R_, n_, B_ in ((8, 1024, 8), (8, 1024, 32), (8, 1024, 1024),
                       (16, 4096, 32)):
        ring = pick_ring(torch, np, FRB, dev, R_, n_, "random", 1)
        us = torch.tensor([0.61], device=dev)
        sel_ = torch.zeros(2, B_, dtype=torch.int32, device=dev)
        wts = torch.zeros(B_, device=dev)
        for layout in (FRB.PICK_SHARED, FRB.PICK_GLOBAL):
            g = FRB.pick_tiling(R_, n_, layout)
            if g is None:
                continue
            by_pick[f"R {R_} n {n_} B {B_} layout {layout}"] = kernel_split(
                torch, kernels, lambda: FRB.pick_launcher(
                    ring, sel_, wts, B_, 3, 0.4, g)(R_ // 2, R_, us),
                dev)[0][1]
    return {"post": FRB.post_geometry()._asdict(), "post_ms": by_mode,
            "pick_ms": by_pick}


def rainbow_split(torch, np, kernels, FRB, RB, EnvParams, dev):
    """One warm K8 learning step at the CLI defaults (L0, 1,024 envs, R 8,
    B 1,024, uniform 1-step, f32) split by kernel (``kernel_split``):
    device ms of each launch, launches per learning step, their sum, one
    learn (every launch between the act and the post kernel) beside its
    bound (``rb_learn_flops`` x B), the act kernel beside its bound
    (``rb_forward_flops`` x 1,024 envs at the f32 rate) and the library's
    eager chain of the same forward (``rb_chain_ms``); the time per step
    of a warm 200-step chunk and of a warm PER 3-step chunk (the CLI's
    ``--per --n-step 3 --obs-scale 0.01``, B 32), CUDA events, host
    launches included; and one warm PER 3-step learning step split the
    same way (``per_kernels``).  The chunk's first launch (the post kernel
    that forms the carry's effective weights) is listed but is not part of
    a step.  ``rb_post`` (the learning step's, the chunk-opening one and
    the PER step's with its write-back) and ``rb_per_pick`` stand beside
    their bounds (``post_bytes``, ``pick_bytes``) and the library's
    versions of the same functions (``post_library_ms``,
    ``pick_library_ms``).  It calls only what every version of
    ``ops.fused_rainbow`` has, so it splits a parent's step too."""
    ep = EnvParams()
    cfg = RB.RainbowConfig(memory_capacity=8 * N_TRAIN, opponent="L0")
    carry = FRB.fused_rainbow_chunk(cfg, ep, FRB.fused_rainbow_init(
        0, cfg, ep, N_TRAIN, device=dev), T_CHUNK, 0)
    st = FRB.working_state(carry)
    one, zero = np.ones(1, np.int32), np.zeros(1, np.int32)
    split = kernel_split(torch, kernels, lambda: FRB.launch_rainbow(
        st, carry, cfg, ep, 1, 1, False, one, zero,
        np.zeros(1, np.float32)), dev)
    step = split[1:]
    synced = float(st["env"][11, 0]) > float(carry["env"][11, 0])
    r = np.random.default_rng(3)
    streams = (r.integers(0, carry["R"], T_CHUNK).astype(np.int32),
               np.zeros(T_CHUNK, np.int32), np.zeros(T_CHUNK, np.float32))
    chunk_ms = cuda_ms(torch, lambda: FRB.launch_rainbow(
        st, carry, cfg, ep, T_CHUNK, 1, False, *streams), 3)
    pcfg = cfg.replace(per=True, n_step=3, obs_scale=0.01)
    pcarry = FRB.fused_rainbow_chunk(pcfg, ep, FRB.fused_rainbow_init(
        0, pcfg, ep, N_TRAIN, device=dev), T_CHUNK, 0)
    pst = FRB.working_state(pcarry)
    per_ms = cuda_ms(torch, lambda: FRB.launch_rainbow(
        pst, pcarry, pcfg, ep, T_CHUNK, 1, False, zero.repeat(T_CHUNK),
        zero.repeat(T_CHUNK), r.random(T_CHUNK).astype(np.float32)), 3)
    pst = FRB.working_state(pcarry)
    psplit = kernel_split(torch, kernels, lambda: FRB.launch_rainbow(
        pst, pcarry, pcfg, ep, 1, 1, False, zero, zero,
        np.full(1, 0.61, np.float32)), dev)
    psynced = float(pst["env"][11, 0]) > float(pcarry["env"][11, 0])
    R, pB = pcarry["R"], pcarry["B"]
    r_cur, stored = pcarry["steps"] % R, min(pcarry["steps"] + 1, R)

    def ms_of(entries, name):
        return [ms for nm, ms in entries if nm == name][0]
    return {"kernels": split, "launches_per_learning_step": len(step),
            "step_device_ms": sum(ms for _, ms in step),
            "learn_ms": sum(ms for _, ms in step[1:-1]),
            "learn_bound_ms": bound(0, carry["B"] * rb_learn_flops())[0],
            "act_ms": step[0][1],
            "act_bound_ms": bound(0, N_TRAIN * rb_forward_flops())[0],
            "act_library_ms": rb_chain_ms(torch, dev, N_TRAIN),
            "chunk_step_ms": chunk_ms / T_CHUNK,
            "per_3step_chunk_ms": per_ms,
            "per_kernels": psplit,
            "per_launches_per_learning_step": len(psplit) - 1,
            "per_step_device_ms": sum(ms for _, ms in psplit[1:]),
            "post_ms": step[-1][1], "post_synced": synced,
            "post_bound_ms": bound(post_bytes(N_TRAIN, carry["B"], 1, synced,
                                              0, 1), post_flops(1)),
            "post_open_ms": split[0][1],
            "post_open_bound_ms": bound(post_bytes(N_TRAIN, carry["B"], 0, 0,
                                                   0, 0), post_flops(0)),
            "post_per_ms": psplit[-1][1], "post_per_synced": psynced,
            "post_per_bound_ms": bound(post_bytes(N_TRAIN, pB, 1, psynced,
                                                  1, 1), post_flops(1)),
            "post_library_ms": post_library_ms(torch, FRB, st),
            "pick_ms": ms_of(psplit, "mgt_rb_per_pick"),
            "pick_bound_ms": bound(
                pick_bytes(stored - pcfg.n_step + 1, N_TRAIN, pB),
                pick_flops(R, N_TRAIN, pB)),
            "pick_library_ms": pick_library_ms(
                torch, pst["ring"], R, N_TRAIN, pB, r_cur, stored,
                pcfg.n_step, 0.61)}


def rb_learn_sweep(torch, np, kernels, FRB, RB, EnvParams, dev):
    """One K8 learn at the CLI defaults (L0, 1,024 envs, R 8, B 1,024),
    device ms (the sum of the learn's launches by ``kernel_split``): at
    every lanes per block (``FRB.LEARN_LANES``) and every gradient block size
    (``FRB.GRAD_THREADS``), each with the picked rest, beside what
    ``learn_geometry`` picks: the readings its rule stands on.  Each
    geometry's parameters, moments and loss after one learning step must
    equal the picked one's."""
    ep = EnvParams()
    cfg = RB.RainbowConfig(memory_capacity=8 * N_TRAIN, opponent="L0")
    carry = FRB.fused_rainbow_chunk(cfg, ep, FRB.fused_rainbow_init(
        0, cfg, ep, N_TRAIN, device=dev), T_CHUNK, 0)
    B = carry["B"]
    one, zero = np.ones(1, np.int32), np.zeros(1, np.int32)

    def step(g):
        st = FRB.working_state(carry)
        FRB.launch_rainbow(st, carry, cfg, ep, 1, 1, False, one, zero,
                           np.zeros(1, np.float32), geometry=g)
        return st

    def time(g):
        st = step(g)
        if not all(torch.equal(st[k], want[k]) for k in (
                "p", "m", "v", "loss")):
            raise AssertionError(f"the K8 learner at {g} differs")
        split = kernel_split(torch, kernels, lambda: step(g), dev)
        return sum(ms for name, ms in split if "learn" in name)
    picked = FRB.learn_geometry(
        B, torch.cuda.get_device_properties(dev).multi_processor_count)
    want = step(picked)
    return {"picked": picked._asdict(),
            "device_ms_by_lanes": {
                str(n): time(FRB.learn_tiling(B, n, picked.grad_threads))
                for n in FRB.LEARN_LANES},
            "device_ms_by_grad_threads": {
                str(t): time(FRB.learn_tiling(B, picked.lanes, t))
                for t in FRB.GRAD_THREADS}}


def act_sweep(torch, kernels, FM, tiling, picked, launch, keys, at, dev):
    """One act launch (``launch(g)`` on a fresh working state, the act
    kernel at position ``at`` of its ``kernel_split``) at 4, 8, 16 and 32
    envs a block with every micro-tile of ``FM.QNET_TILES`` that fits
    (RM <= rows) and the nets held (``tiling(rows)``), and at the picked
    rows and tile with no net held (``tiling(rows, 0)``: read from global
    memory), device ms, beside ``picked``: the readings the rule stands
    on.  Each geometry's step must equal the picked one's in ``keys``
    (``check_k8`` and ``check_k9`` hold the picked one against the plain
    versions)."""
    want = launch(picked)

    def time(g):
        st = launch(g)
        for k in keys:
            if not torch.equal(st[k], want[k]):
                raise AssertionError(f"the act kernel at {g} differs in {k}")
        return kernel_split(torch, kernels, lambda: launch(g),
                            dev)[at][1]
    times = {}
    for rows in (4, 8, 16, 32):
        base = tiling(rows)
        for rm, rn in FM.QNET_TILES:
            if rm <= rows:
                times[f"{rows} {rm}x{rn}"] = time(base._replace(rm=rm, rn=rn))
    streamed = tiling(picked.rows, 0)._replace(rm=picked.rm, rn=picked.rn)
    return {"picked": picked._asdict(), "device_ms": times,
            "global_weights_ms": time(streamed)}


def rb_act_sweep(torch, np, kernels, FRB, RB, FM, EnvParams, dev):
    """``act_sweep`` of K8's act kernel at the training CLI's defaults (L0,
    1,024 envs, f32), on the warm carry of ``rainbow_split`` (after a
    200-step chunk: a learning step, whose second launch is the act
    kernel); the act kernel in self-play at its picked geometry (both
    seats' 16 rows a block in one pass) on a warm self-play carry; and, at
    L0 on the cold carry (step 0), its time beside the warm one and, for
    both carries, the share of the forward's probabilities (the plain
    version's, on the carry's envs) below the smallest normal f32, 2^-126,
    where the exp and the IEEE division may leave their fast paths."""
    ep, n = EnvParams(), N_TRAIN
    one, zero = np.ones(1, np.int32), np.zeros(1, np.int32)
    out = {}

    def tiny_share(carry):
        st = FRB.working_state(carry)
        dist = FRB.rb_forward(st["p"], st["wp"], FRB._obs_of(st["env"]))[
            "dist"]
        return float((dist < 2.0 ** -126).float().mean())
    for opponent in ("L0", "selfplay"):
        cfg = RB.RainbowConfig(memory_capacity=8 * n, opponent=opponent)
        cold = FRB.fused_rainbow_init(0, cfg, ep, n, device=dev)
        carry = FRB.fused_rainbow_chunk(cfg, ep, cold, T_CHUNK, 0)

        def launch(g, cfg=cfg, carry=carry):
            st = FRB.working_state(carry)
            FRB.launch_rainbow(st, carry, cfg, ep, 1, 1, False, one, zero,
                               np.zeros(1, np.float32), act_geom=g)
            return st
        seats = 2 if opponent == "selfplay" else 1
        picked = FRB.act_geometry(n, FM.sm_count(dev), seats)
        if opponent == "L0":
            out = act_sweep(torch, kernels, FM,
                            lambda rows, *held: FRB.act_tiling(
                                rows, 1, None, *held),
                            picked, launch, ("env", "ring", "met", "p"), 1,
                            dev)
            out["cold_ms"] = kernel_split(
                torch, kernels, lambda: FRB.launch_rainbow(
                    FRB.working_state(cold), cold, cfg, ep, 1, 1, False, zero,
                    zero, np.zeros(1, np.float32)), dev)[1][1]
            out["subnormal_share"] = {"warm": tiny_share(carry),
                                      "cold": tiny_share(cold)}
        else:
            out["selfplay_ms"] = kernel_split(
                torch, kernels, lambda: launch(picked), dev)[1][1]
    return out


def drqn_act_sweep(torch, np, kernels, FD, DR, FM, EnvParams, dev):
    """``act_sweep`` of K9's act kernel at the training CLI's defaults (L0,
    1,024 envs, L 16, f32), on the warm carry of ``drqn_split`` (after a
    200-step chunk: a learning step, whose first launch is the act
    kernel), and the act kernel in self-play at its picked geometry (both
    seats' 16 rows a block in one pass) on a warm self-play carry."""
    ep, n = EnvParams(), N_TRAIN
    one, zero = np.ones(1, np.int32), np.zeros(1, np.int32)
    out = {}
    for opponent in ("L0", "selfplay"):
        cfg = DR.DRQNConfig(memory_capacity=4 * n, opponent=opponent)
        carry = FD.fused_drqn_chunk(cfg, ep, FD.fused_drqn_init(
            0, cfg, ep, n, device=dev), T_CHUNK, 0)

        def launch(g, cfg=cfg, carry=carry):
            st = FD.working_state(carry)
            FD.launch_drqn(st, carry, cfg, ep, 1, 1, False, one, zero, g)
            return st
        picked = FD.act_geometry(n, FM.sm_count(dev),
                                 *FD.act_seats(opponent))
        if opponent == "L0":
            out = act_sweep(torch, kernels, FM,
                            lambda rows, *held: FD.act_tiling(rows, 1, 1,
                                                              *held),
                            picked, launch, ("env", "win", "met", "p"), 0,
                            dev)
        else:
            out["selfplay_ms"] = kernel_split(
                torch, kernels, lambda: launch(picked), dev)[0][1]
    return out


def learn_lanes_times(torch, kernels, FT, FM, D, EnvParams, dev):
    """One K5 learn at the CLI defaults (L0, 1,024 envs, B 1,024, f32),
    device ms by ``graph_ms``: at every power of two of lanes per block up
    to ``FT.LEARN_LANES_MAX`` (``learn_tiling``'s micro-tile and chunk),
    and at the picked lanes with every micro-tile of ``FM.QNET_TILES``,
    beside what ``learn_geometry`` picks: the readings its rule stands on.
    Each geometry's parameters after one learn must equal the picked
    one's."""
    ep = EnvParams()
    cfg = D.DQNConfig(memory_capacity=4 * N_TRAIN)
    carry = FT.fused_dqn_chunk(cfg, ep, FT.fused_dqn_init(
        0, cfg, ep, N_TRAIN, device=dev), 20, 0)
    dims = FT._dims(carry["p"])
    rounds = torch.ones(1, dtype=torch.int32, device=dev)
    cols = torch.zeros(1, dtype=torch.int32, device=dev)

    def learn(lr, st):  # on the current stream (graph_ms captures it)
        lr.stream = kernels.stream_ptr(dev)
        lr.launch(st["ring"], FT.NUM_F, rounds, cols, st["loss"],
                  ("dqn_learn_fwd", "dqn_learn_grad"), t=2)

    def time(g):
        st = FT.working_state(carry, torch.float32)
        lr = FT.Learner(st, "", dims, carry["B"], 1, cfg, dev, g)
        learn(lr, st)
        if not all(torch.equal(st[k], want[k]) for k in (
                "p", "tp", "m", "v", "loss")):
            raise AssertionError(f"the learner at {g} differs")
        return graph_ms(torch, lambda: learn(lr, st))
    picked = FT.learn_geometry(carry["B"], dims, 4, FT.sm_count(dev))
    want = FT.working_state(carry, torch.float32)
    learn(FT.Learner(want, "", dims, carry["B"], 1, cfg, dev), want)
    by_lanes, lanes = {}, 1
    while lanes <= FT.LEARN_LANES_MAX:
        g = FT.learn_tiling(dims, lanes, 4)
        if g is not None:
            by_lanes[str(lanes)] = time(g)
        lanes *= 2
    by_tile = {f"{rm}x{rn}": time(picked._replace(rm=rm, rn=rn))
               for rm, rn in FM.QNET_TILES if rm <= 2 * picked.lanes}
    return {"picked": picked._asdict(), "device_ms_by_lanes": by_lanes,
            "device_ms_by_tile": by_tile}


def train_path(cli, tmp):
    """The training main path through the port's CLI; returns the run
    directories and the ``eval --fused`` result of the trained nets."""
    fused, levelk, loop = (os.path.join(tmp, d) for d in
                           ("fused", "levelk", "loop"))
    cli.main(["train", "--algo", "dqn", "--fused-kernel", "--max-chunks", "5",
              "--episodes", BIG, "--out", fused])
    cli.main(["levelk", "--algo", "dqn", "--fused-kernel", "--levels", "2",
              "--max-chunks", "3", "--episodes", BIG, "--out", levelk])
    res = cli.main(["eval", "--fused",
                    "--p1", os.path.join(levelk, "L2", "params.npz"),
                    "--p2", os.path.join(levelk, "L1", "params.npz"),
                    "--num-envs", str(N_ENVS)])
    cli.main(["train", "--algo", "dqn", "--opponent", "selfplay",
              "--max-chunks", "2", "--episodes", BIG, "--out", loop])
    runs = {"train --fused-kernel": (fused, 5, "learns"),
            "levelk L1": (os.path.join(levelk, "L1"), 3, "learns"),
            "levelk L2": (os.path.join(levelk, "L2"), 3, "learns"),
            "train (step loop)": (loop, 2, "learns")}
    return runs, res


def hdqn_path(cli, tmp, evaluate, hdqn_policy, EnvParams, load_params_npz,
              qnet_params_from_numpy, torch, dev):
    """The h-DQN training path through the port's CLI, then ``evaluate``
    of the trained L2 vs L1 as ``hdqn_policy``; returns the run
    directories (with the scalar that shows learning) and the result."""
    fused, levelk, loop = (os.path.join(tmp, d) for d in
                           ("hdqn_fused", "hdqn_levelk", "hdqn_loop"))
    cli.main(["train", "--algo", "hdqn", "--fused-kernel", "--max-chunks",
              "5", "--episodes", BIG, "--out", fused])
    cli.main(["levelk", "--algo", "hdqn", "--fused-kernel", "--levels", "2",
              "--max-chunks", "3", "--episodes", BIG, "--out", levelk])
    cli.main(["train", "--algo", "hdqn", "--opponent", "selfplay",
              "--max-chunks", "2", "--episodes", BIG, "--out", loop])

    def policy(level):
        nets = load_params_npz(os.path.join(levelk, level, "params.npz"))
        return hdqn_policy(qnet_params_from_numpy(nets["upper"], dev),
                           qnet_params_from_numpy(nets["lower"], dev))

    # Phi(0.7)-greedy L2 vs L1, 512 steps x 2 at 256 envs; a 400-step cap
    # makes every env finish at least two episodes.
    res = evaluate(policy("L2"), policy("L1"), EnvParams(max_steps=400),
                   torch.Generator(device=dev).manual_seed(0),
                   num_envs=N_ENVS_HDQN,
                   min_episodes=512, chunk_steps=512, max_chunks=2)
    runs = {"hdqn train --fused-kernel": (fused, 5, "lower_learns"),
            "hdqn levelk L1": (os.path.join(levelk, "L1"), 3, "lower_learns"),
            "hdqn levelk L2": (os.path.join(levelk, "L2"), 3, "lower_learns"),
            "hdqn train (step loop)": (loop, 2, "loss")}
    return runs, res


def check_runs(np, runs, load_params_npz):
    """Every logged chunk finite and in range, learning under way, and the
    saved params finite."""
    def leaves(tree):
        for v in tree.values():
            yield from (leaves(v) if isinstance(v, dict) else (v,))

    for what, (out, chunks, learned) in runs.items():
        with open(os.path.join(out, "scalars.jsonl")) as f:
            rows = [json.loads(ln) for ln in f]
        if len(rows) != chunks:
            raise AssertionError(f"{what}: {len(rows)} chunks logged")
        for row in rows:
            if not np.isfinite(list(row.values())).all():
                raise AssertionError(f"{what}: non-finite scalars {row}")
            for k in ("collision_rate", "win_rate"):
                if not 0.0 <= row[k] <= 1.0:
                    raise AssertionError(f"{what}: {k} {row[k]}")
        last = rows[-1]
        if (last[learned] <= 0
                or last["env_steps"] != chunks * T_CHUNK * N_TRAIN):
            raise AssertionError(f"{what}: {last}")
        params = load_params_npz(os.path.join(out, "params.npz"))
        if not all(np.isfinite(v).all() for v in leaves(params)):
            raise AssertionError(f"{what}: non-finite params")
        print(f"{what}: {json.dumps(last)}", flush=True)


# K1/K2 checks (T, N, max_steps) at the edges of their geometry (32 envs a
# block: 1, 31, 33, 300, 4,095, 4,096, 4,097 envs), T of 1, not a multiple
# of the 8-step fetch (37) and 512, with the default timeout and with
# 3-step episodes; each in both action sources.
K1_K2_CASES = ((T_ROLLOUT, N_ENVS, None), (T_ROLLOUT, N_ENVS + 1, 3),
               (T_ROLLOUT, 300, None), (37, 1, 3), (37, 31, None),
               (37, 33, 3), (37, N_ENVS - 1, 3), (37, N_ENVS + 1, None),
               (1, N_ENVS, None), (1, 33, 3))


def rollout_times(torch, np, FR, EnvParams, dev):
    """K1 in actions and in seed mode (512 steps) and K2 in seed mode (512
    and 65,536 steps) at 4,096 envs: ms of one launch by CUDA events,
    median, each beside its bound.  Takes the module, so that a parent's
    ``ops.fused_rollout`` can be timed beside the change's."""
    ep = EnvParams()
    actions = torch.as_tensor(
        np.random.default_rng(0).integers(-1, 5, (T_ROLLOUT, 2, N_ENVS)),
        dtype=torch.int32, device=dev)
    out = FR.empty_rollout(T_ROLLOUT, N_ENVS, dev)
    rs = torch.empty(2, N_ENVS, device=dev)
    cs = torch.empty(4, N_ENVS, dtype=torch.int32, device=dev)
    r = {"k1_actions_ms": cuda_ms(torch, lambda: FR.launch_rollout(
            out, actions, None, ep), 10),
         "k1_seed_ms": cuda_ms(torch, lambda: FR.launch_rollout(
             out, None, 12345, ep), 10),
         "k2_seed_ms": cuda_ms(torch, lambda: FR.launch_counters(
             rs, cs, T_ROLLOUT, None, 12345, ep), 10),
         "k2_long_ms": cuda_ms(torch, lambda: FR.launch_counters(
             rs, cs, T_COUNTERS_LONG, None, 12345, ep), 5)}
    steps = T_ROLLOUT * N_ENVS
    # K1 writes 60 B an env-step (obs 40, rewards 8, three events 12) and
    # reads 8 B of actions in actions mode; K2 writes 24 B an env.
    r["bounds"] = {
        "k1_actions": bound(steps * FR.K1_BYTES_PER_ENV_STEP,
                            steps * (ENV_STEP_FLOPS + OBS_FLOPS)),
        "k1_seed": bound(steps * (FR.K1_BYTES_PER_ENV_STEP - 8),
                         steps * (ENV_STEP_FLOPS + OBS_FLOPS)),
        "k2_seed": bound(N_ENVS * 24, steps * (ENV_STEP_FLOPS + 2)),
        "k2_long": bound(N_ENVS * 24,
                         T_COUNTERS_LONG * N_ENVS * (ENV_STEP_FLOPS + 2))}
    r["k2_long_env_steps_per_s"] = (T_COUNTERS_LONG * N_ENVS
                                    / (r["k2_long_ms"] / 1e3))
    return r


# Threads a block of the sweep, at the built 4 lanes an env: at 4,096
# envs 512, 256 and 128 blocks.
ROLLOUT_SWEEP = (32, 64, 128)


def rollout_sweep(torch, np, kernels, FR, EnvParams, dev):
    """K1 (actions, 512 steps) and K2 (seed, 65,536 steps) at 4,096 envs at
    each threads a block of ``ROLLOUT_SWEEP``: a copy of env_rollout.cu
    with its ``kThreads`` set to each, built once for each (one nvcc each,
    all at once), each build's outputs bit-equal to the built kernel's,
    its registers from ``-Xptxas -v``."""
    import ctypes
    with open(os.path.join(kernels.CSRC, "env_rollout.cu")) as f:
        src = f.read()
    built = f"constexpr int kThreads = {FR.ROLLOUT_THREADS};"
    if src.count(built) != 1:
        raise RuntimeError(f"env_rollout.cu does not hold {built!r} once")
    builds = {}
    for threads in ROLLOUT_SWEEP:
        name = os.path.join(kernels.BUILD_DIR, f"env_rollout_t{threads}")
        with open(name + ".cu", "w") as f:
            f.write(src.replace(built,
                                f"constexpr int kThreads = {threads};"))
        log = open(name + ".log", "w")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC,
               "-o", name + ".so", name + ".cu"]
        builds[threads] = (subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT), name, log)
    ep = EnvParams()
    actions = torch.as_tensor(
        np.random.default_rng(1).integers(-1, 5, (T_ROLLOUT, 2, N_ENVS)),
        dtype=torch.int32, device=dev)
    want_k1 = FR.fused_rollout(T_ROLLOUT, N_ENVS, actions=actions)
    want_k2 = FR.fused_rollout_counters(T_COUNTERS_LONG, N_ENVS, seed=12345,
                                        device=dev)
    want_cs = torch.stack([want_k2[k] for k in ("episodes", "collisions",
                                                "wins1", "wins2")])
    stream, ptr = kernels.stream_ptr(dev), kernels.ptr
    lanes = FR.ROLLOUT_LANES
    rows = []
    for threads, (proc, name, log) in builds.items():
        rc = proc.wait()
        log.close()
        with open(name + ".log") as f:
            text = f.read()
        if rc != 0:
            raise RuntimeError(f"sweep build {name} failed:\n{text[-3000:]}")
        lib = ctypes.CDLL(name + ".so")
        k1, k2 = lib.mgt_env_rollout, lib.mgt_env_counters
        k1.argtypes, k2.argtypes = FR.ROLLOUT_ARGS, FR.COUNTERS_ARGS
        g = FR.RolloutGeometry(lanes, threads,
                               -(-N_ENVS // (threads // lanes)))
        out = FR.empty_rollout(T_ROLLOUT, N_ENVS, dev)
        bufs = [out[k] for k in ("obs", "rewards", "done", "winner",
                                 "collision")]
        rs = torch.empty(2, N_ENVS, device=dev)
        cs = torch.empty(4, N_ENVS, dtype=torch.int32, device=dev)

        def run_k1():
            if k1(ptr(actions), *map(ptr, bufs), *FR.env_call_args(
                    T_ROLLOUT, N_ENVS, None, ep, g), stream):
                raise RuntimeError(f"sweep build {name}: K1 launch failed")

        def run_k2():
            if k2(ptr(None), ptr(rs), ptr(cs), *FR.env_call_args(
                    T_COUNTERS_LONG, N_ENVS, 12345, ep, g), stream):
                raise RuntimeError(f"sweep build {name}: K2 launch failed")
        run_k1()
        run_k2()
        torch.cuda.synchronize()
        got = FR.as_events(out)
        same = (all(torch.equal(got[k], want_k1[k]) for k in want_k1)
                and torch.equal(rs, want_k2["reward_sum"])
                and torch.equal(cs, want_cs))
        if not same:
            raise AssertionError(f"sweep build {name} disagrees with K1/K2")
        rows.append({"lanes": lanes, "threads": threads, "blocks": g.blocks,
                     "k1_actions_ms": cuda_ms(torch, run_k1, 10),
                     "k2_long_ms": cuda_ms(torch, run_k2, 3),
                     "registers": [ln.strip() for ln in text.splitlines()
                                   if "registers" in ln]})
    return rows


def check_k1_k2(checks, torch, np, FR, EnvParams, dev):
    """K1 and K2 bit for bit against their plain versions in every case,
    and K2 against K1's reductions."""
    counts = ("episodes", "collisions", "wins1", "wins2")
    for T, N, max_steps in K1_K2_CASES:
        ep = EnvParams(**({} if max_steps is None else
                          {"max_steps": max_steps}))
        r = np.random.default_rng(T * N)
        acts = torch.as_tensor(r.integers(-1, 5, (T, 2, N)),
                               dtype=torch.int32, device=dev)
        for mode, kw in (("actions", {"actions": acts}),
                         ("seed", {"seed": 12345, "device": dev})):
            what = f"{mode} T {T} N {N} max_steps {max_steps}"
            k1 = FR.fused_rollout(T, N, env_params=ep, **kw)
            k1p = FR.fused_rollout_plain(T, N, env_params=ep, **kw)
            checks.events("K1", what, k1, k1p, tuple(k1), {})
            k2 = FR.fused_rollout_counters(T, N, env_params=ep, **kw)
            k2p = FR.fused_rollout_counters_plain(T, N, env_params=ep, **kw)
            checks.events("K2", what, k2, k2p, tuple(k2), {})
            # K2 against K1's reductions (tests/test_fused_rollout_counters
            # .py; the rewards summed in another order, so not part of K2's
            # error against its plain version).
            d, w, c = k1["done"], k1["winner"], k1["collision"]
            red = {"episodes": d.sum(0), "collisions": c.sum(0),
                   "wins1": (d & (w == 1) & ~c).sum(0),
                   "wins2": (d & (w == 2) & ~c).sum(0)}
            for k in counts:
                checks.equal("K2 vs K1", f"{what} {k}", k2[k], red[k])
            checks.close("K2 vs K1", f"{what} reward_sum", k2["reward_sum"],
                         k1["rewards"].sum(0), 1e-5, 1e-3)
            if max_steps == 3:
                assert int(k2["episodes"].sum()) >= N * (T // 3), what
            if T == T_ROLLOUT and N == N_ENVS:
                assert int(k2["episodes"].sum()) > 0
                assert int(k2["collisions"].sum()) > 0
                print(f"K1/K2 {mode}: {int(k2['episodes'].sum())} episodes, "
                      f"{int(k2['collisions'].sum())} collisions in "
                      f"{T} x {N}", flush=True)
    print(f"K1/K2: {2 * len(K1_K2_CASES)} cases bit-equal", flush=True)


# ---------------------------------------------------------------------------
# The m16 phase: play's opponents on K3, the native env with a card
# opponent, the control QP, the trajectory dump, the utilities, and the
# pygame / gymnasium layers where they are installed
# ---------------------------------------------------------------------------

M16_EPISODES = 2       # oracle episodes per learned opponent
M16_NATIVE_ENVS = 1024
M16_NATIVE_STEPS = 500
M16_DUMP_ENVS = 256
M16_DUMP_STEPS = 600
M16_SESSION_STEPS = 200
M16_VECTOR_STEPS = 200
QP_ATOL = 1e-9         # tests/test_control.py's tolerances
KKT_ATOL = 1e-8
ZOO_HD = os.path.join(REPO, "model_zoo", "HD_L1", "params.npz")
ZOO_RB_L0 = os.path.join(REPO, "model_zoo", "RB_L0", "params.npz")


def rainbow_state_dict(torch, np, params):
    """Rainbow params (``[in, out]`` weights) -> a ``RainbowDQN`` state
    dict (``nn.Linear`` weights ``[out, in]``, the noisy layers' mu and
    sigma): the inverse of ``io.torch_import.rainbow_from_state_dict``."""
    sd = {}
    for name, p in params.items():
        p = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
        if "w" in p:
            sd[f"{name}.weight"] = p["w"].T.contiguous()
            sd[f"{name}.bias"] = p["b"]
            continue
        sd[f"{name}.weight_mu"] = p["w_mu"].T.contiguous()
        sd[f"{name}.weight_sigma"] = p["w_sigma"].T.contiguous()
        sd[f"{name}.bias_mu"] = p["b_mu"]
        sd[f"{name}.bias_sigma"] = p["b_sigma"]
    return sd


def play_run_dirs(torch, np, tmp, load_params_npz, qnet_to_state_dict):
    """model_zoo/L2 as a reference DQN run directory, HD_L1 as an h-DQN
    one (eval, target, meta_eval, meta_target) and RB_L0 as a Rainbow
    ``eval.pth``."""
    dirs = {m: os.path.join(tmp, f"play_{m}") for m in ("dqn", "hdqn",
                                                         "rainbow")}
    for d in dirs.values():
        os.makedirs(d)
    l2 = qnet_to_state_dict(load_params_npz(ZOO_L2))
    for f in ("eval.pth", "target.pth"):
        torch.save(l2, os.path.join(dirs["dqn"], f))
    hd = load_params_npz(ZOO_HD)
    for f, net in (("eval.pth", "lower"), ("target.pth", "lower"),
                   ("meta_eval.pth", "upper"), ("meta_target.pth", "upper")):
        torch.save(qnet_to_state_dict(hd[net]), os.path.join(dirs["hdqn"], f))
    torch.save(rainbow_state_dict(torch, np, load_params_npz(ZOO_RB_L0)),
               os.path.join(dirs["rainbow"], "eval.pth"))
    return dirs


def play_opponents(torch, kernels, human, OracleMergeEnv, dirs, dev):
    """``M16_EPISODES`` full oracle episodes against each learned opponent
    (loaded on the card from its run directory), the ego holding action 2
    as a session with no key pressed does.  Returns the opponents, their
    numbers (steps, K3 launches, median host ms of one synchronised
    ``act``) and every K3 call as ``(params, x, q)``."""
    calls = []
    real = human.qnet_apply

    def recording(params, x, compute_dtype="float32"):
        q = real(params, x, compute_dtype)
        calls.append((params, x, q))
        return q
    human.qnet_apply = recording
    opponents, out = {}, {}
    try:
        for mode in ("dqn", "hdqn", "rainbow"):
            opp = human.load_opponent(mode, dirs[mode], dev)
            if opp.device.type != "cuda":
                raise AssertionError(f"the {mode} opponent is on "
                                     f"{opp.device}")
            opponents[mode] = opp
            env = OracleMergeEnv()
            act_ms, steps, winners = [], 0, []

            def episodes():
                nonlocal steps
                for _ in range(M16_EPISODES):
                    state = env.reset()
                    opp.reset()
                    done = False
                    while not done:
                        torch.cuda.synchronize()
                        t = time.perf_counter()
                        a2 = opp.act(state[5:] + state[:5])
                        act_ms.append((time.perf_counter() - t) * 1e3)
                        state, _, done, _ = env.step(2, a2)
                        steps += 1
                    winners.append(env.winner)
            _, launches = counted(kernels, episodes)
            out[mode] = {"steps": steps, "winners": winners,
                         "k3_launches": launches["qnet_mlp"],
                         "act_ms_median": statistics.median(act_ms)}
    finally:
        human.qnet_apply = real
    return opponents, out, calls


def native_with_card_opponent(torch, np, native, OracleMergeEnv, P,
                              qnet_apply, params, dev):
    """The native core against the port's oracle on one env's episode (bit
    for bit), then ``M16_NATIVE_ENVS`` native envs against a Phi-greedy
    card opponent (K3 at ``M16_NATIVE_ENVS`` rows a step) for
    ``M16_NATIVE_STEPS`` steps, finished envs reset in place."""
    rng = np.random.default_rng(0)
    env, oracle = native.NativeMergeEnv(1), OracleMergeEnv()
    steps = 0
    while True:
        a1, a2 = int(rng.integers(0, 5)), int(rng.integers(-1, 5))
        obs_o, r_o, done_o, info_o = oracle.step(a1, None if a2 < 0 else a2)
        obs_n, r_n, done_n, col_n, _ = env.step([a1], [a2])
        steps += 1
        if (not np.array_equal(obs_n[0], np.asarray(obs_o))
                or not np.array_equal(r_n[0], np.asarray(r_o))
                or bool(done_n[0]) != done_o
                or bool(col_n[0]) != info_o["collision"]):
            raise AssertionError(f"native core != oracle at step {steps}")
        if done_o:
            break
    n, T = M16_NATIVE_ENVS, M16_NATIVE_STEPS
    venv = native.NativeMergeEnv(n)
    pol = P.q_policy(qnet_apply, params, greedy=False)
    gen = torch.Generator(device=dev).manual_seed(0)
    a1 = rng.integers(0, 5, (T, n)).astype(np.int32)
    obs = venv.observe()
    episodes = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(T):
        swapped = torch.as_tensor(np.concatenate([obs[:, 5:], obs[:, :5]], 1),
                                  dtype=torch.float32, device=dev)
        a2 = pol.act(pol.params, swapped, gen).cpu().numpy()
        obs, _, done, _, _ = venv.step(a1[t], a2)
        if done.any():
            episodes += int(done.sum())
            venv.reset_envs(done)
            obs = venv.observe()
    wall = time.perf_counter() - t0
    if episodes < n:
        raise AssertionError(f"{episodes} native episodes in {T} steps")
    return {"oracle_episode_steps": steps, "envs": n, "steps": T,
            "episodes": episodes, "s": wall, "env_steps_per_s": n * T / wall}


def control_on_card(torch, np, control, C, dev):
    """``mpc_1d_qp`` and ``eq_qp`` in f64 on the card against the analytic
    law (atol 1e-9) and a numpy KKT solve (atol 1e-8)."""
    worst = 0.0
    for v0 in (0.0, 7.3, 20.0, 39.9, 55.0):
        for vt in C.TARGET_VELS:
            u = control.mpc_1d_qp(v0, vt, device=dev)
            if u.device.type != "cuda" or u.dtype != torch.float64:
                raise AssertionError(f"mpc_1d_qp on {u.device} {u.dtype}")
            worst = max(worst, float((u - (vt - v0) / C.PREDICTION_T).abs()
                                     .max()))
    if worst > QP_ATOL:
        raise AssertionError(f"mpc_1d_qp off the analytic law by {worst}")
    rng = np.random.default_rng(0)
    n, m = 12, 3
    a = rng.standard_normal((n, n))
    P_ = a @ a.T + np.eye(n)
    q, A, b = (rng.standard_normal(s) for s in (n, (m, n), m))
    want = np.linalg.solve(np.block([[P_, A.T], [A, np.zeros((m, m))]]),
                           np.concatenate([-q, b]))[:n]
    got = control.eq_qp(*(torch.tensor(v, device=dev) for v in (P_, q, A, b)))
    kkt_err = float(np.abs(got.cpu().numpy() - want).max())
    if kkt_err > KKT_ATOL:
        raise AssertionError(f"eq_qp off numpy's solve by {kkt_err}")
    return {"mpc_max_abs_err": worst, "eq_qp_max_abs_err": kkt_err}


def dump_on_card(torch, trajectory, P, EnvParams, reset_batch, rollout, tmp,
                 dev):
    """``dump_batch_trajectories`` of a ``core.vector.rollout`` on the card
    (``M16_DUMP_ENVS`` x ``M16_DUMP_STEPS``, const 4 against L0): one file
    per done, 14 columns in every row."""
    import csv
    ep = EnvParams()
    fn, ps = P.two_player(P.constant_policy(4), P.l0_policy())
    gen = torch.Generator(device=dev).manual_seed(0)
    _, traj = rollout(ep, reset_batch(ep, gen, M16_DUMP_ENVS, device=dev),
                      fn, ps, gen, M16_DUMP_STEPS)
    if traj.obs.device.type != "cuda":
        raise AssertionError(f"rollout on {traj.obs.device}")
    t = time.perf_counter()
    paths = trajectory.dump_batch_trajectories(
        trajectory.make_log_dir(os.path.join(tmp, "dump")), traj)
    dump_s = time.perf_counter() - t
    done = int(traj.done.sum())
    rows = 0
    for path in paths:
        with open(path, newline="") as f:
            for row in csv.reader(f):
                if len(row) != 14:
                    raise AssertionError(f"{path}: a row of {len(row)}")
                rows += 1
    if len(paths) != done or done == 0:
        raise AssertionError(f"{len(paths)} files for {done} dones")
    return {"files": len(paths), "dones": done, "rows": rows,
            "dump_s": dump_s}


def utilities_on_card(torch, debug, profiling, FM, params, tmp, dev):
    """``utils.debug.checked`` catches a NaN and an out-of-range action in
    CUDA tensors (read back once, in ``get``); ``utils.profiling.trace``
    around one K3 launch writes a trace whose events name K3's kernel;
    ``time_fn`` and ``ThroughputTimer`` on CUDA tensors."""
    def f(x, a):
        debug.assert_finite({"x": x}, "input")
        debug.validate_actions(a)
        return x * 2
    fn = debug.checked(f)
    ok_x = torch.ones(4, device=dev)
    ok_a = torch.tensor([-1, 0, 4, 2], dtype=torch.int32, device=dev)
    cases = {None: (ok_x, ok_a),
             "non-finite value in input['x']": (
                 torch.tensor([1.0, float("nan")], device=dev), ok_a),
             "action out of range [-1, NUM_ACTIONS)": (
                 ok_x, torch.tensor([0, 5], dtype=torch.int32, device=dev))}
    for want, args in cases.items():
        err, _ = fn(*args)
        if err.get() != want:
            raise AssertionError(f"checked: {err.get()!r} != {want!r}")
    try:
        err.throw()
        raise AssertionError("err.throw() did not raise")
    except debug.CheckError:
        pass
    x = torch.randn(1, 10, device=dev)
    trace_dir = os.path.join(tmp, "trace")
    with profiling.trace(trace_dir) as prof:
        FM.qnet_apply_fused(params, x)
        torch.cuda.synchronize()
    (name,) = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, name)) as f:
        text = f.read()
    if "qnet_kernel" not in text:
        raise AssertionError(f"the trace {name} names no qnet_kernel")
    k3_events = [e.key for e in prof.key_averages() if "qnet_kernel" in e.key]
    mean_s, q = profiling.time_fn(FM.qnet_apply_fused, params, x, iters=20)
    timer = profiling.ThroughputTimer()
    timer.start()
    q = FM.qnet_apply_fused(params, x)
    timer.stop(1, q)
    return {"trace_file": name, "trace_bytes": len(text),
            "k3_profiler_keys": k3_events, "time_fn_k3_b1_ms": mean_s * 1e3,
            "timer_calls_per_s": timer.per_second}


def ui_layers(torch, human, P, qnet_apply, params, opponents, tmp, dev):
    """Where pygame and gymnasium are installed (``find_spec``): a headless
    ``run_session`` (``time_scale`` 0, ``M16_SESSION_STEPS`` steps, 2
    episodes) against each learned opponent, and ``GymnasiumMergeEnv`` and
    ``NativeVectorEnv`` with card opponents.  Returns what ran."""
    import importlib.util
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("pygame", "gymnasium")}
    ran = {}
    if not all(have.values()):
        return {"installed": have, "ran": ran}
    import numpy as np
    os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
    from merging_gym_tpu_torch.envs.gym_env import GymnasiumMergeEnv
    from merging_gym_tpu_torch.envs.vector_env import NativeVectorEnv
    for mode, opp in opponents.items():
        t = time.perf_counter()
        res = human.run_session(opp, episodes=2,
                                log_root=os.path.join(tmp, "log"),
                                max_steps=M16_SESSION_STEPS, time_scale=0.0)
        ran[f"run_session {mode}"] = {
            "s": time.perf_counter() - t,
            "files": len(os.listdir(res["log_dir"]))}
    dqn = opponents["dqn"]
    env = GymnasiumMergeEnv(opponent=lambda obs, rng: dqn.act(obs))
    env.reset(seed=0)
    for steps in range(1, 3001):
        _, _, term, trunc, _ = env.step(2)
        if term or trunc:
            break
    ran["GymnasiumMergeEnv dqn"] = {"steps": steps}
    pol = P.q_policy(qnet_apply, params, greedy=False)
    gen = torch.Generator(device=dev).manual_seed(1)
    venv = NativeVectorEnv(M16_NATIVE_ENVS, opponent=lambda obs, rng: pol.act(
        pol.params, torch.as_tensor(obs, dtype=torch.float32, device=dev),
        gen).cpu().numpy())
    venv.reset(seed=0)
    ends = 0
    for _ in range(M16_VECTOR_STEPS):
        _, _, term, trunc, _ = venv.step(np.full(M16_NATIVE_ENVS, 3,
                                                 np.int32))
        ends += int((term | trunc).sum())
    ran["NativeVectorEnv q_policy"] = {"envs": M16_NATIVE_ENVS,
                                       "steps": M16_VECTOR_STEPS,
                                       "episodes": ends}
    return {"installed": have, "ran": ran}


def k3_b1_times(torch, FM, nets, dev, rng):
    """K3 at B = 1 (``play``'s shape) for each net of the play path, f32:
    CUDA-event median of one launch (``cuda_ms``) and its device time
    (``graph_ms``), the ``addmm`` + ReLU chain's (``library_ms``), the
    plain version's, and the bound (x, the weights and q once)."""
    out = {}
    for label, p in nets:
        w = FM.cast_weights(p, torch.float32, dev)
        dims = (w[0].shape[0], w[0].shape[1], w[2].shape[1], w[4].shape[1])
        x = torch.as_tensor(rng.standard_normal((1, dims[0])) * 100,
                            dtype=torch.float32, device=dev)
        q = torch.empty(1, dims[3], device=dev)

        def library():
            h = torch.relu(torch.addmm(w[1], x, w[0]))
            h = torch.relu(torch.addmm(w[3], h, w[2]))
            return torch.addmm(w[5], h, w[4])
        b_ms, b_by = bound((dims[0] + dims[3]) * 4
                           + sum(t.numel() * 4 for t in w), mlp_flops(*dims))
        out[label] = {
            "ms": cuda_ms(torch, lambda: FM.launch_mlp(w, x, q), 50),
            "device_ms": graph_ms(torch, lambda: FM.launch_mlp(w, x, q)),
            "library_ms": cuda_ms(torch, library, 50),
            "library_device_ms": graph_ms(torch, library),
            "plain_ms": cuda_ms(torch, lambda: FM.qnet_apply_plain(p, x), 5),
            "bound_ms": b_ms, "bound_by": b_by,
            "geometry": FM.qnet_geometry(1, dims, 4,
                                         FM.sm_count(dev))._asdict()}
    return out


def m16_path(torch, np, kernels, checks, p_l2, rng, dev):
    """The m16 phase, with every launch count set to 0 just before its
    main path and read just after: ``play``'s learned opponents, the
    native env with a card opponent, the control QP, the trajectory dump
    and the UI layers; then the utilities, whose K3 launches time the
    kernel and are reported under their own key (``m16`` line); then
    every K3 output of the opponents' episodes against the plain version
    (into ``checks``) and K3 at B = 1 timed.  Returns ``(line, launches)``."""
    from merging_gym_tpu_torch.agents import policies as P
    from merging_gym_tpu_torch.core import constants as C
    from merging_gym_tpu_torch.core import control, native
    from merging_gym_tpu_torch.core.env import EnvParams
    from merging_gym_tpu_torch.core.oracle import OracleMergeEnv
    from merging_gym_tpu_torch.core.vector import reset_batch, rollout
    from merging_gym_tpu_torch.io import trajectory
    from merging_gym_tpu_torch.io.checkpoint import load_params_npz
    from merging_gym_tpu_torch.io.torch_import import qnet_to_state_dict
    from merging_gym_tpu_torch.nn.mlp import (qnet_apply,
                                              qnet_params_from_numpy)
    from merging_gym_tpu_torch.ops import fused_mlp as FM
    from merging_gym_tpu_torch.ui import human
    from merging_gym_tpu_torch.utils import debug, profiling

    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launch_counts()
        t = time.perf_counter()
        dirs = play_run_dirs(torch, np, tmp, load_params_npz,
                             qnet_to_state_dict)
        opponents, played, k3_calls = play_opponents(
            torch, kernels, human, OracleMergeEnv, dirs, dev)
        m16 = {"opponents": played}
        m16["native"] = native_with_card_opponent(
            torch, np, native, OracleMergeEnv, P, qnet_apply, p_l2, dev)
        m16["control"] = control_on_card(torch, np, control, C, dev)
        m16["dump"] = dump_on_card(torch, trajectory, P, EnvParams,
                                   reset_batch, rollout, tmp, dev)
        m16["ui_layers"] = ui_layers(torch, human, P, qnet_apply, p_l2,
                                     opponents, tmp, dev)
        torch.cuda.synchronize()
        launches = dict(kernels.launch_counts)
        # The utilities time K3 (trace, time_fn, ThroughputTimer): their
        # launches are reported apart, not as the path's.
        m16["utils"], util_launches = counted(kernels, lambda: (
            utilities_on_card(torch, debug, profiling, FM, p_l2, tmp, dev)))
        m16["utils"]["launches"] = {k: v for k, v in util_launches.items()
                                    if v}
        m16["s"] = time.perf_counter() - t
    if launches["qnet_mlp"] == 0:
        raise AssertionError("m16 path launched no qnet_mlp")
    # Every K3 output of the opponents' episodes against the plain version.
    shapes, worst = set(), 0.0
    for p, x, q in k3_calls:
        if x.dim() != 1:
            raise AssertionError(f"play called K3 on {tuple(x.shape)}")
        want = FM.qnet_apply_plain(p, x)
        checks.equal("K3", f"play B=1 {x.shape[0]}->{q.shape[0]}", q, want)
        worst = max(worst, float((q - want).abs().max()))
        shapes.add(f"{x.shape[0]}->{q.shape[0]}")
    if shapes != {"10->5", "10->3", "11->5"}:
        raise AssertionError(f"play's K3 shapes {shapes}")
    m16["k3_outputs_checked"] = len(k3_calls)
    m16["k3_max_abs_err"] = worst
    hd = load_params_npz(ZOO_HD)
    m16["k3_b1"] = k3_b1_times(torch, FM, [
        ("10->5 L2", p_l2),
        ("10->3 HD_L1 meta", qnet_params_from_numpy(hd["upper"], dev)),
        ("11->5 HD_L1 lower", qnet_params_from_numpy(hd["lower"], dev))],
        dev, rng)
    m16["launches"] = {k: v for k, v in launches.items() if v}
    return m16, launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np

    from merging_gym_tpu_torch import bench, cli, kernels
    from merging_gym_tpu_torch.agents import dqn as D
    from merging_gym_tpu_torch.agents import drqn as DR
    from merging_gym_tpu_torch.agents import hdqn as H
    from merging_gym_tpu_torch.agents import policies as P
    from merging_gym_tpu_torch.agents import rainbow as RB
    from merging_gym_tpu_torch.agents.evaluate import (evaluate,
                                                       evaluate_drqn,
                                                       evaluate_fused,
                                                       fused_outcomes)
    from merging_gym_tpu_torch.core.env import EnvParams
    from merging_gym_tpu_torch.core.geometry import lon2coord
    from merging_gym_tpu_torch.io.checkpoint import (CheckpointManager,
                                                     load_params_npz)
    from merging_gym_tpu_torch.io.torch_import import qnet_to_state_dict
    from merging_gym_tpu_torch.nn.lstm import (drqn_init,
                                               drqn_params_from_numpy)
    from merging_gym_tpu_torch.nn.mlp import (qnet_apply, qnet_init,
                                              qnet_params_from_numpy)
    from merging_gym_tpu_torch.nn.rainbow_net import \
        rainbow_params_from_numpy
    from merging_gym_tpu_torch.ops import fused_actor as FA
    from merging_gym_tpu_torch.ops import fused_drqn as FD
    from merging_gym_tpu_torch.ops import fused_hdqn as FH
    from merging_gym_tpu_torch.ops import fused_mlp as FM
    from merging_gym_tpu_torch.ops import fused_policy_rollout as FPR
    from merging_gym_tpu_torch.ops import fused_rainbow as FRB
    from merging_gym_tpu_torch.ops import fused_rollout as FR
    from merging_gym_tpu_torch.ops import fused_trainer as FT

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    secs = kernels.build(force=True)
    print(f"build: {time.perf_counter() - t0:.1f} s wall, per library "
          f"{ {k: round(v, 1) for k, v in secs.items()} }")
    for name in kernels.LIBRARIES:
        with open(os.path.join(kernels.BUILD_DIR, f"{name}.log")) as f:
            regs = [ln.strip() for ln in f if "registers" in ln]
        print(f"  {name}: {'; '.join(regs)}")
    sys.stdout.flush()

    checks = Checks(torch)
    ev_tol = {"rewards": (1e-6, 1e-6)}
    p_l1 = qnet_params_from_numpy(load_params_npz(ZOO_L1), dev)
    p_l2 = qnet_params_from_numpy(load_params_npz(ZOO_L2), dev)
    rng = np.random.default_rng(0)

    # ---- 2. every kernel against its plain version ----------------------
    actions = torch.as_tensor(rng.integers(-1, 5, (T_ROLLOUT, 2, N_ENVS)),
                              dtype=torch.int32, device=dev)
    check_k1_k2(checks, torch, np, FR, EnvParams, dev)

    g = torch.Generator(device=dev).manual_seed(4)
    hdqn_nets = (qnet_init(g, 10, 3), qnet_init(g, 11, 5))
    check_k3(checks, torch, FM, p_l2, hdqn_nets, dev, rng)

    check_k6(checks, torch, FPR, k6_cases(EnvParams, qnet_init, torch,
                                          p_l2, p_l1, dev))

    k4_kept = check_k4(checks, torch, FA, FM, p_l2, hdqn_nets, dev, rng)
    check_k5(checks, torch, FT, D, EnvParams, lon2coord, qnet_init, dev)
    check_k7(checks, torch, FH, H, EnvParams, lon2coord, qnet_init, dev)
    check_k8(checks, torch, FRB, RB, EnvParams, lon2coord, p_l1, dev)
    check_rb_post_pick(checks, torch, np, FRB, dev)
    check_k9(checks, torch, FD, DR, EnvParams, lon2coord, drqn_init, dev)

    # ---- 3. the main paths -----------------------------------------------
    phase_s = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        phase_s[name] = time.perf_counter() - t
        return out

    kernels.reset_launch_counts()
    bench_line = timed("bench", lambda: cli.main(["bench"]))
    bench_launches = dict(kernels.launch_counts)
    print(f"bench path: {phase_s['bench']:.2f} s, launches "
          f"{bench_launches}", flush=True)
    if bench_launches["env_counters"] != 1 + bench.REPS:
        raise AssertionError(f"bench launched K2 "
                             f"{bench_launches['env_counters']} times")
    if (list(bench_line) != ["metric", "value", "unit", "vs_baseline",
                             "device"]
            or bench_line["device"] != torch.cuda.get_device_name(0)
            or not 0 < bench_line["value"] < float("inf")):
        raise AssertionError(f"bench printed {bench_line}")

    kernels.reset_launch_counts()
    traj = timed("fused_rollout", lambda: FR.fused_rollout(
        T_ROLLOUT, N_ENVS, seed=7, device=dev))
    fused = timed("eval --fused", lambda: cli.main(
        ["eval", "--fused", "--p1", ZOO_L2, "--p2", ZOO_L1,
         "--num-envs", str(N_ENVS)]))
    loop = timed("eval", lambda: cli.main(
        ["eval", "--p1", ZOO_L2, "--p2", ZOO_L1, "--num-envs", "256"]))
    eval_launches = dict(kernels.launch_counts)
    eval_s = {k: v for k, v in phase_s.items() if k != "bench"}
    print(f"evaluation path: {sum(eval_s.values()):.2f} s {eval_s}, "
          f"launches {eval_launches}", flush=True)
    missing = [k for k in ("env_rollout", "qnet_mlp", "policy_rollout")
               if eval_launches[k] == 0]
    if missing:
        raise AssertionError(f"evaluation path launched no {missing}")

    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launch_counts()
        runs, trained = timed("training path", lambda: train_path(cli, tmp))
        train_launches = dict(kernels.launch_counts)
        print(f"training path: {phase_s['training path']:.2f} s, launches "
              f"{train_launches}", flush=True)
        missing = [k for k in ("fused_actor", *K5_COUNTS, "policy_rollout")
                   if train_launches[k] == 0]
        if missing:
            raise AssertionError(f"training path launched no {missing}")
        check_runs(np, runs, load_params_npz)

        kernels.reset_launch_counts()
        runs, hdqn_eval = timed("h-DQN training path", lambda: hdqn_path(
            cli, tmp, evaluate, P.hdqn_policy, EnvParams, load_params_npz,
            qnet_params_from_numpy, torch, dev))
        hdqn_launches = dict(kernels.launch_counts)
        print(f"h-DQN training path: {phase_s['h-DQN training path']:.2f} s, "
              f"launches {hdqn_launches}", flush=True)
        missing = [k for k in (*K7_COUNTS, "fused_actor", "qnet_mlp")
                   if hdqn_launches[k] == 0]
        if missing:
            raise AssertionError(f"h-DQN training path launched no {missing}")
        check_runs(np, runs, load_params_npz)
        print("hdqn_policy L2 vs L1:", json.dumps(hdqn_eval), flush=True)

        kernels.reset_launch_counts()
        runs, rb_zoo, rb_trained = timed("Rainbow training path",
                                         lambda: rainbow_path(
            cli, tmp, evaluate, P.rainbow_policy, P.l0_policy, EnvParams,
            load_params_npz, rainbow_params_from_numpy, torch, dev))
        rb_launches = dict(kernels.launch_counts)
        print(f"Rainbow training path: "
              f"{phase_s['Rainbow training path']:.2f} s, launches "
              f"{rb_launches}", flush=True)
        missing = [k for k in K8_COUNTS if rb_launches[k] == 0]
        if missing:
            raise AssertionError(f"Rainbow training path launched no "
                                 f"{missing}")
        check_runs(np, runs, load_params_npz)
        print("rainbow_policy RB_L0_FUSED vs L0:", json.dumps(rb_zoo))
        # The zoo net was trained to beat L0 (model_zoo/RB_L0_FUSED/
        # meta.json: first on 512 of 512 episodes).
        if rb_zoo["p1_first_rate"] <= 0.5:
            raise AssertionError(f"RB_L0_FUSED loses to L0 in the port: "
                                 f"{rb_zoo}")
        print("rainbow_policy trained vs L0:", json.dumps(rb_trained),
              flush=True)

        kernels.reset_launch_counts()
        runs, drqn_eval = timed("DRQN training path", lambda: drqn_path(
            cli, tmp, evaluate_drqn, EnvParams, load_params_npz,
            drqn_params_from_numpy, torch, dev))
        drqn_launches = dict(kernels.launch_counts)
        print(f"DRQN training path: {phase_s['DRQN training path']:.2f} s, "
              f"launches {drqn_launches}", flush=True)
        missing = [k for k in K9_COUNTS if drqn_launches[k] == 0]
        if missing:
            raise AssertionError(f"DRQN training path launched no {missing}")
        check_runs(np, runs, load_params_npz)
        print("evaluate_drqn trained vs L0:", json.dumps(drqn_eval),
              flush=True)

        kernels.reset_launch_counts()
        resumed, pth_eval = timed("resume", lambda: (
            resume_path(cli, np, tmp, load_params_npz, CheckpointManager,
                        torch),
            pth_path(cli, tmp, load_params_npz, qnet_params_from_numpy,
                     qnet_to_state_dict, torch)))
        resume_launches = dict(kernels.launch_counts)
        print(json.dumps({"card": card, "resume": resumed,
                          "resume_s": phase_s["resume"],
                          "launches": resume_launches}), flush=True)
        missing = [k for k in (*K5_COUNTS, *K7_COUNTS, *K8_COUNTS,
                               *K9_COUNTS, "fused_actor", "policy_rollout")
                   if resume_launches[k] == 0]
        if missing:
            raise AssertionError(f"resume path launched no {missing}")
        print("eval --fused of a .pth run dir:", json.dumps(pth_eval),
              flush=True)

    # The spmd path: parallel/ under NCCL at one rank, then gloo at two
    # ranks on this card; the counts of both worlds' spmd calls.
    kernels.reset_launch_counts()
    one, spmd_launches = timed("spmd world of one", lambda: spmd_world_of_one(
        torch, kernels, dev))
    two, two_launches = timed("spmd world of two", lambda: spmd_world_of_two(
        torch, np))
    add_counts(spmd_launches, two_launches)
    dry, dry_launches = timed("spmd dryrun", lambda: dryrun_on_card(np))
    add_counts(spmd_launches, dry_launches)
    print(json.dumps({"card": card, "spmd": {
        "world_of_one": one, "world_of_two": two, "dryrun": dry,
        "s": {k: phase_s[k] for k in ("spmd world of one",
                                      "spmd world of two", "spmd dryrun")},
        "launches": spmd_launches}}), flush=True)
    missing = [k for k in (*K5_COUNTS, *K7_COUNTS, *K8_COUNTS, *K9_COUNTS,
                           "fused_actor")
               if spmd_launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"spmd path launched no {missing}")
    # The m16 path: play's learned opponents (K3 at B = 1), the native env
    # against a card opponent (K3 at B = 1,024), the control QP, the
    # trajectory dump and the utilities on the card, and the pygame and
    # gymnasium layers where they are installed.
    m16, m16_launches = m16_path(torch, np, kernels, checks, p_l2, rng, dev)
    phase_s["m16"] = m16["s"]
    print(json.dumps({"card": card, "m16": m16}), flush=True)

    launches = {k: bench_launches[k] + eval_launches[k] + train_launches[k]
                + hdqn_launches[k] + rb_launches[k] + drqn_launches[k]
                + resume_launches[k] + spmd_launches.get(k, 0)
                + m16_launches[k]
                for k in kernels.launch_counts}
    launches["dqn_trainer"] = sum(launches[k] for k in K5_COUNTS)
    launches["hdqn_trainer"] = sum(launches[k] for k in K7_COUNTS)
    launches["rainbow_trainer"] = sum(launches[k] for k in K8_COUNTS)
    launches["drqn_trainer"] = sum(launches[k] for k in K9_COUNTS)
    assert traj["obs"].shape == (T_ROLLOUT, 10, N_ENVS)
    assert torch.isfinite(traj["obs"]).all()
    assert int(traj["done"].sum()) > 0
    for res, min_eps in ((fused, N_ENVS), (loop, 512),
                         (trained, N_ENVS), (hdqn_eval, 512), (rb_zoo, 256),
                         (rb_trained, 256), (drqn_eval, 512)):
        assert res["episodes"] >= min_eps, res
        for k in ("p1_first_rate", "p2_first_rate", "collision_rate",
                  "timeout_rate"):
            assert 0.0 <= res[k] <= 1.0, res
        assert np.isfinite([res["mean_return_p1"], res["mean_return_p2"]]).all()

    # ---- 4. greedy evaluate (K3 per step) == evaluate_fused (K6) -------
    # The rule of tests/test_fused_policy_rollout.py:100-116: 150-step
    # episodes, 160 steps, rates and mean returns to 1e-5.
    gen = torch.Generator(device=dev).manual_seed(0)
    short = EnvParams(max_steps=150)
    g_loop = evaluate(P.q_policy(qnet_apply, p_l2, greedy=True),
                      P.q_policy(qnet_apply, p_l1, greedy=True), short,
                      gen, num_envs=256, min_episodes=1, chunk_steps=160,
                      max_chunks=1)
    g_fused = evaluate_fused(p_l2, p_l1, short, num_envs=256, num_steps=160,
                             greedy=True, device=dev)
    print("greedy evaluate:", json.dumps(g_loop))
    print("greedy evaluate_fused:", json.dumps(g_fused))
    assert g_loop["episodes"] > 0
    for k, v in g_loop.items():
        assert abs(v - g_fused[k]) <= 1e-5, (k, v, g_fused[k])
    sys.stdout.flush()

    # ---- 5. timing ---------------------------------------------------------
    results = []
    envs = T_ROLLOUT * N_ENVS

    # K1 (actions and seed mode) and K2 (seed mode, bench's action source;
    # also a long launch), then the sweep of their geometry.
    ep = EnvParams()
    k1k2 = rollout_times(torch, np, FR, EnvParams, dev)
    plain = cuda_ms(torch, lambda: FR.fused_rollout_plain(
        T_ROLLOUT, N_ENVS, actions=actions), 3)
    results.append(("K1 env_rollout", "env_rollout", "env_rollout.cu",
                    "merging_gym_tpu/ops/fused_rollout.py:116", "K1",
                    k1k2["k1_actions_ms"], plain,
                    *k1k2["bounds"]["k1_actions"], None))
    plain = cuda_ms(torch, lambda: FR.fused_rollout_counters_plain(
        T_ROLLOUT, N_ENVS, seed=12345, device=dev), 3)
    results.append(("K2 env_counters", "env_counters", "env_rollout.cu",
                    "merging_gym_tpu/ops/fused_rollout.py:168", "K2",
                    k1k2["k2_seed_ms"], plain, *k1k2["bounds"]["k2_seed"],
                    None))
    k1k2["geometry"] = FR.rollout_geometry(N_ENVS)._asdict()
    k1k2["sweep"] = rollout_sweep(torch, np, kernels, FR, EnvParams, dev)
    print(json.dumps({"card": card, "k1_k2": k1k2}), flush=True)

    # K3 at B = 4096, f32
    x = torch.as_tensor(rng.standard_normal((B_MLP, 10)) * 100,
                        dtype=torch.float32, device=dev)
    w = FM.cast_weights(p_l2, torch.float32, dev)
    q = torch.empty(B_MLP, 5, device=dev)
    ms = cuda_ms(torch, lambda: FM.launch_mlp(w, x, q), 20)
    plain = cuda_ms(torch, lambda: FM.qnet_apply_plain(p_l2, x), 5)

    def library():
        h = torch.relu(torch.addmm(w[1], x, w[0]))
        h = torch.relu(torch.addmm(w[3], h, w[2]))
        return torch.addmm(w[5], h, w[4])
    lib = cuda_ms(torch, library, 20)
    if not torch.allclose(q, library(), rtol=1e-5, atol=1e-3):
        raise AssertionError("K3 disagrees with the addmm library forward")
    dims = (10, 200, 100, 5)
    w_bytes = sum(t.numel() * 4 for t in w)
    b_ms, b_by = bound(B_MLP * (10 + 5) * 4 + w_bytes,
                       B_MLP * mlp_flops(*dims))
    results.append(("K3 qnet_mlp", "qnet_mlp", "qnet_mlp.cu",
                    "merging_gym_tpu/ops/fused_mlp.py:28", "K3",
                    ms, plain, b_ms, b_by, lib))

    # K6: Phi-greedy L2 vs L1, f32, as eval --fused plays
    w1 = FM.cast_weights(p_l2, torch.float32, dev)
    w2 = FM.cast_weights(p_l1, torch.float32, dev)
    pol = FPR.empty_events(T_POLICY, N_ENVS, dev)
    kw = dict(greedy=False, epsilon=0.7, seed=1, env_params=ep)
    ms = cuda_ms(torch, lambda: FPR.launch_policy_rollout(pol, w1, w2, **kw),
                 5)
    plain = cuda_ms(torch, lambda: FPR.fused_policy_rollout_plain(
        T_POLICY, N_ENVS, p_l2, p_l1, **kw), 2, warmup=0)
    per_step = 2 * mlp_flops(*dims) + ENV_STEP_FLOPS + OBS_FLOPS
    pol_envs = T_POLICY * N_ENVS
    b_ms, b_by = bound(pol_envs * FPR.K6_BYTES_PER_ENV_STEP + 2 * w_bytes,
                       pol_envs * per_step)
    results.append(("K6 policy_rollout", "policy_rollout",
                    "policy_rollout.cu",
                    "merging_gym_tpu/ops/fused_policy_rollout.py:95", "K6",
                    ms, plain, b_ms, b_by, None))
    full = FPR.empty_events(T_EVAL, N_ENVS, dev)
    full_ms = cuda_ms(torch, lambda: FPR.launch_policy_rollout(
        full, w1, w2, **kw), 3)
    full_bound, _ = bound(T_EVAL * N_ENVS * FPR.K6_BYTES_PER_ENV_STEP,
                          T_EVAL * N_ENVS * per_step)
    k6_sweep_line = k6_sweep(torch, FPR, FM, p_l2, p_l1, EnvParams, dev)
    eval_split = eval_fused_split(torch, np, FPR, FR, FM, load_params_npz,
                                  qnet_params_from_numpy, EnvParams,
                                  fused_outcomes, dev)

    # K4 at B = 4096, f32, as the step-loop actor calls it
    acts = torch.empty(B_MLP, dtype=torch.int32, device=dev)
    ms = cuda_ms(torch, lambda: FA.launch_actor(w, x, acts, 5, 0.7), 20)
    plain = cuda_ms(torch, lambda: FA.fused_eps_greedy_actions_plain(
        p_l2, x, 5), 5)
    lib = cuda_ms(torch, lambda: library().argmax(dim=1), 20)
    b_ms, b_by = bound(B_MLP * (10 + 1) * 4 + w_bytes,
                       B_MLP * mlp_flops(*dims))
    results.append(("K4 fused_actor", "fused_actor", "fused_actor.cu",
                    "merging_gym_tpu/ops/fused_actor.py:33", "K4",
                    ms, plain, b_ms, b_by, lib))
    by_batch = qnet_batch_times(torch, FM, FA, p_l2, dev, rng)
    by_rows = qnet_rows_times(torch, FM, p_l2, dev, rng)

    # K5: one training step at the CLI's defaults (L0, 1,024 envs, R = 4,
    # B = 1,024), timed over a 200-step chunk of a warm carry (every step
    # learns); the plain version per step over a short chunk.
    k5 = {}
    for label, n_envs, kw in (
            ("1024 envs, B 1024", N_TRAIN, {}),
            ("4096 envs, B 512 in 4 windows", N_TRAIN_WIDE,
             dict(learn_batch=512, learn_rounds=4))):
        cfg = D.DQNConfig(memory_capacity=4 * n_envs)
        carry = FT.fused_dqn_init(0, cfg, ep, n_envs, device=dev, **kw)
        carry = FT.fused_dqn_chunk(cfg, ep, carry, T_CHUNK, 0)
        st = FT.working_state(carry, torch.float32)
        r = np.random.default_rng(1)
        rounds = r.integers(0, carry["R"], T_CHUNK * carry["K"])
        cols = r.integers(0, carry["K"] * n_envs // carry["B"],
                          T_CHUNK * carry["K"])
        chunk_ms = cuda_ms(torch, lambda: FT.launch_trainer(
            st, carry, cfg, ep, T_CHUNK, 1, False, rounds, cols), 3)
        step_plain = cuda_ms(torch, lambda: FT.fused_dqn_chunk_plain(
            cfg, ep, carry, T_PLAIN, 1), 1, warmup=0) / T_PLAIN
        B = carry["B"]
        P = sum(t.numel() for t in carry["p"])
        step_bytes = (n_envs * (2 * 11 + 24 + 2 * 4) * 4 + B * 24 * 4
                      + 28 * P)
        step_flops = (n_envs * (mlp_flops(*dims) + ENV_STEP_FLOPS + OBS_FLOPS)
                      + B * learn_flops(*dims) + P * ADAM_FLOPS)
        sb_ms, sb_by = bound(step_bytes, step_flops)
        k5[label] = {"chunk_ms": chunk_ms, "step_ms": chunk_ms / T_CHUNK,
                     "env_steps_per_s": T_CHUNK * n_envs / (chunk_ms / 1e3),
                     "plain_step_ms": step_plain, "bound_step_ms": sb_ms,
                     "bound_by": sb_by}
        if n_envs == N_TRAIN:
            results.append(("K5 dqn_trainer", "dqn_trainer", "dqn_trainer.cu",
                            "merging_gym_tpu/ops/fused_trainer.py:237", "K5",
                            chunk_ms / T_CHUNK, step_plain, sb_ms, sb_by,
                            None))

    # K7: one training step at the CLI's defaults (L0, 1,024 envs, R_lo 4,
    # R_up 2, B 1,024), timed over a 200-step chunk of a warm carry (the
    # lower learner learns every step, the upper one where an option
    # ended); the plain version per step over a short chunk.
    cfg = H.HDQNConfig(memory_capacity=4 * N_TRAIN,
                       goal_memory_capacity=2 * N_TRAIN)
    carry = FH.fused_hdqn_init(0, cfg, ep, N_TRAIN, device=dev)
    carry = FH.fused_hdqn_chunk(cfg, ep, carry, T_CHUNK, 0)
    r = np.random.default_rng(2)
    streams = (r.integers(0, carry["R_lo"], T_CHUNK),
               r.integers(0, carry["R_up"], T_CHUNK),
               np.zeros(2 * T_CHUNK, np.int64))
    st = FH.working_state(carry, torch.float32)
    up0 = FH.upper_learns(st["state"])
    before = dict(kernels.launch_counts)
    FH.launch_hdqn(st, carry, cfg, ep, T_CHUNK, 1, False, *streams)
    torch.cuda.synchronize()
    k7_fired = (FH.upper_learns(st["state"]) - up0) / T_CHUNK
    k7_launches = sum(kernels.launch_counts[k] - before[k]
                      for k in K7_COUNTS) / T_CHUNK
    k7_chunk_ms = cuda_ms(torch, lambda: FH.launch_hdqn(
        st, carry, cfg, ep, T_CHUNK, 1, False, *streams), 3)
    k7_plain = cuda_ms(torch, lambda: FH.fused_hdqn_chunk_plain(
        cfg, ep, carry, T_PLAIN_K7, 1), 1, warmup=0) / T_PLAIN_K7
    dims_up, dims_lo = (10, 200, 100, 3), (11, 200, 100, 5)
    P_up = sum(t.numel() for t in carry["u_p"])
    P_lo = sum(t.numel() for t in carry["l_p"])
    B = carry["B"]
    # Bytes: state rows in and out, the lower slab stored, the upper slab
    # where an option ended, the sampled slabs read, and per learn p,
    # target and moments read, p and moments written (7 x 4 B a parameter).
    k7_bytes = (N_TRAIN * (2 * FH.ROWS + FH.LO_F + k7_fired * FH.UP_F) * 4
                + B * (FH.LO_F + k7_fired * FH.UP_F) * 4
                + 28 * (P_lo + k7_fired * P_up))
    k7_flops = (N_TRAIN * (2 * mlp_flops(*dims_up) + mlp_flops(*dims_lo)
                           + ENV_STEP_FLOPS + OBS_FLOPS)
                + B * (learn_flops(*dims_lo) + k7_fired
                       * learn_flops(*dims_up))
                + ADAM_FLOPS * (P_lo + k7_fired * P_up))
    k7_b_ms, k7_b_by = bound(k7_bytes, k7_flops)
    k7 = {"chunk_ms": k7_chunk_ms, "step_ms": k7_chunk_ms / T_CHUNK,
          "env_steps_per_s": T_CHUNK * N_TRAIN / (k7_chunk_ms / 1e3),
          "plain_step_ms": k7_plain, "bound_step_ms": k7_b_ms,
          "bound_by": k7_b_by, "upper_fired_share": k7_fired,
          "launches_per_warm_step": k7_launches}
    results.append(("K7 hdqn_trainer", "hdqn_trainer", "hdqn_trainer.cu",
                    "merging_gym_tpu/ops/fused_hdqn.py:86", "K7",
                    k7_chunk_ms / T_CHUNK, k7_plain, k7_b_ms, k7_b_by, None))

    # K5's, K7's, K9's and K8's warm steps split by kernel (device time of
    # each), and the learners' geometry sweeps.
    split = trainer_split(torch, np, kernels, FT, FH, D, H, EnvParams, dev)
    split["learn_geometry_sweep"] = learn_lanes_times(
        torch, kernels, FT, FM, D, EnvParams, dev)
    split["act_geometry_sweep"] = act_geometry_sweep(
        torch, np, kernels, FT, FH, FM, D, H, EnvParams, dev)
    split["K9"] = drqn_split(torch, np, kernels, FD, DR, EnvParams, dev)
    split["k9_learn_geometry_sweep"] = drqn_learn_sweep(
        torch, kernels, FD, FM, DR, EnvParams, dev)
    split["K8"] = rainbow_split(torch, np, kernels, FRB, RB, EnvParams, dev)
    split["K8"]["empty_kernel_ms"] = empty_kernel_ms(torch, kernels, dev)
    split["k8_post_pick_sweep"] = rb_post_pick_sweep(torch, np, kernels,
                                                     FRB, dev)
    split["k8_learn_geometry_sweep"] = rb_learn_sweep(
        torch, np, kernels, FRB, RB, EnvParams, dev)
    split["k8_act_geometry_sweep"] = rb_act_sweep(
        torch, np, kernels, FRB, RB, FM, EnvParams, dev)
    split["k9_act_geometry_sweep"] = drqn_act_sweep(
        torch, np, kernels, FD, DR, FM, EnvParams, dev)

    # K8: one training step at the CLI's defaults (L0, 1,024 envs, R 8,
    # B 1,024, uniform 1-step): per step of a warm 200-step chunk (every
    # step learns) and the PER 3-step chunk from its split above; a 1-step
    # launch of a warm carry and the plain version per step over a short
    # chunk here.
    k8s = split["K8"]
    rcfg = RB.RainbowConfig(memory_capacity=8 * N_TRAIN, opponent="L0")
    rcarry = FRB.fused_rainbow_init(0, rcfg, ep, N_TRAIN, device=dev)
    rcarry = FRB.fused_rainbow_chunk(rcfg, ep, rcarry, T_CHUNK, 0)
    one, zero = np.ones(1, np.int32), np.zeros(1, np.int32)
    rst = FRB.working_state(rcarry)
    k8_step_ms = cuda_ms(torch, lambda: FRB.launch_rainbow(
        rst, rcarry, rcfg, ep, 1, 1, False, one, zero,
        np.zeros(1, np.float32)), 20)
    k8_plain = cuda_ms(torch, lambda: FRB.fused_rainbow_chunk_plain(
        rcfg, ep, rcarry, T_PLAIN_K8, 1), 1, warmup=0) / T_PLAIN_K8
    B = rcarry["B"]
    # Bytes: env rows in and out, the slab stored, the sampled slabs read,
    # per learn p, target, m, v read and p, m, v written (7 x 4 B a
    # parameter), both nets' noise read and effective weights written and
    # read (6 x 4 B an element).  Operations: one forward per env (L0), the
    # env step, the learner per sampled lane, Adam (14 per parameter and
    # the sigma products) and the effective weights (2 per element, both
    # nets).
    k8_bytes = (N_TRAIN * (2 * FRB.ENV_ROWS + FRB.NUM_F) * 4
                + B * FRB.NUM_F * 4 + 28 * RB_PARAMS + 6 * 4 * 2 * RB_ELEMS)
    k8_flops = (N_TRAIN * (rb_forward_flops() + ENV_STEP_FLOPS + OBS_FLOPS)
                + B * rb_learn_flops() + RB_PARAMS * ADAM_FLOPS
                + RB_ELEMS + 2 * 2 * RB_ELEMS)
    k8_b_ms, k8_b_by = bound(k8_bytes, k8_flops)
    k8_step = k8s["chunk_step_ms"]
    k8 = {"chunk_ms": k8_step * T_CHUNK, "step_ms": k8_step,
          "one_step_launch_ms": k8_step_ms,
          "env_steps_per_s": N_TRAIN / (k8_step / 1e3),
          "plain_step_ms": k8_plain, "bound_step_ms": k8_b_ms,
          "bound_by": k8_b_by, "step_mflop": k8_flops / 1e6,
          "forward_flops_per_row": rb_forward_flops(),
          "learn_flops_per_lane": rb_learn_flops(),
          "per_3step_chunk_ms": k8s["per_3step_chunk_ms"]}
    results.append(("K8 rainbow_trainer", "rainbow_trainer",
                    "rainbow_trainer.cu",
                    "merging_gym_tpu/ops/fused_rainbow.py:545", "K8",
                    k8_step, k8_plain, k8_b_ms, k8_b_by, None))

    # K9: one training step at the CLI's defaults (L0, 1,024 envs, L 16,
    # R 4, B 1,024), timed over a 200-step chunk of a warm carry (every step
    # learns) and as a 1-step launch; the act kernel alone over the first
    # 50 steps of a cold carry (no learns); the plain version per step.
    dcfg = DR.DRQNConfig(memory_capacity=4 * N_TRAIN)
    dcold = FD.fused_drqn_init(0, dcfg, ep, N_TRAIN, device=dev)
    dcarry = FD.fused_drqn_chunk(dcfg, ep, dcold, T_CHUNK, 0)
    r = np.random.default_rng(4)
    dstreams = (r.integers(0, dcarry["R"], T_CHUNK),
                np.zeros(T_CHUNK, np.int64))
    dst = FD.working_state(dcarry)
    k9_chunk_ms = cuda_ms(torch, lambda: FD.launch_drqn(
        dst, dcarry, dcfg, ep, T_CHUNK, 1, False, *dstreams), 3)
    k9_step_ms = cuda_ms(torch, lambda: FD.launch_drqn(
        dst, dcarry, dcfg, ep, 1, 1, False, *(x[:1] for x in dstreams)), 20)
    cst = FD.working_state(dcold)
    k9_act_ms = cuda_ms(torch, lambda: FD.launch_drqn(
        cst, dcold, dcfg, ep, 50, 1, False, *(x[:50] for x in dstreams)),
        3) / 50
    k9_plain = cuda_ms(torch, lambda: FD.fused_drqn_chunk_plain(
        dcfg, ep, dcarry, T_PLAIN_K9, 1), 1, warmup=0) / T_PLAIN_K9
    L9, B9 = dcarry["L"], dcarry["B"]
    WF9 = (L9 + 1) * FD.SLOT
    # The learner's work depends on where the sampled windows' episodes
    # end: count it on the windows of the rounds the timed chunk samples,
    # as the ring holds them when the chunk starts.
    done9 = dcarry["ring"].reshape(dcarry["R"], L9 + 1, FD.SLOT, N_TRAIN)[
        :, 1:, FD.IN_DIM + 2].cpu().numpy()                  # [R, L, n]
    batches = list(zip(*(x.tolist() for x in dstreams)))
    per_batch = {(r, c): drqn_learn_flops(
        done9[r, :, c * B9:(c + 1) * B9].T, dcfg.burn_in)
        for r, c in set(batches)}
    k9_learn_flops = statistics.mean(per_batch[rc] for rc in batches)
    valid9 = float(drqn_valid(done9.transpose(0, 2, 1),
                              dcfg.burn_in)[1].mean())
    # Bytes: env rows in and out, the metrics, the window slot written, the
    # flush (the window read, a ring round written) once every L steps, the
    # sampled windows read, and per learn p, target, m, v read and p, m, v
    # written (7 x 4 B a parameter).  Operations: one recurrent forward per
    # env (L0), the env step, the learner per sampled window, Adam.
    k9_bytes = (N_TRAIN * (2 * FD.ENV_ROWS + 2 * 4 + FD.SLOT) * 4
                + N_TRAIN * 2 * WF9 * 4 / L9 + B9 * WF9 * 4 + 28 * DRQN_P)
    k9_flops = (N_TRAIN * (drqn_forward_flops() + ENV_STEP_FLOPS + OBS_FLOPS)
                + k9_learn_flops + DRQN_P * ADAM_FLOPS)
    k9_b_ms, k9_b_by = bound(k9_bytes, k9_flops)
    k9 = {"chunk_ms": k9_chunk_ms, "step_ms": k9_chunk_ms / T_CHUNK,
          "one_step_launch_ms": k9_step_ms, "act_step_ms": k9_act_ms,
          "env_steps_per_s": T_CHUNK * N_TRAIN / (k9_chunk_ms / 1e3),
          "plain_step_ms": k9_plain, "bound_step_ms": k9_b_ms,
          "bound_by": k9_b_by, "step_mflop": k9_flops / 1e6,
          "forward_flops_per_row": drqn_forward_flops(),
          "learn_mflop": k9_learn_flops / 1e6,
          "valid_steps_per_window": valid9}
    results.append(("K9 drqn_trainer", "drqn_trainer", "drqn_trainer.cu",
                    "merging_gym_tpu/ops/fused_drqn.py:396", "K9",
                    k9_chunk_ms / T_CHUNK, k9_plain, k9_b_ms, k9_b_by, None))

    # The step-loop h-DQN trainer (K4 actors, two autograd learners) per
    # step, as context for K7: host clock around synchronised chunks.
    hcfg = H.HDQNConfig(memory_capacity=max(2000, 2 * N_TRAIN))
    hcarry = H.hdqn_train_chunk(hcfg, ep, H.hdqn_init(
        0, hcfg, ep, N_TRAIN, device=dev), 3)
    torch.cuda.synchronize()
    t = time.perf_counter()
    hcarry = H.hdqn_train_chunk(hcfg, ep, hcarry, 20)
    torch.cuda.synchronize()
    hdqn_loop_step_ms = (time.perf_counter() - t) * 1e3 / 20

    # The step-loop trainer (K4 actor, autograd learner) per step, as
    # context for K5: host clock around synchronised chunks.
    cfg = D.DQNConfig(memory_capacity=max(2000, 2 * N_TRAIN))
    carry = D.train_chunk(cfg, ep, D.train_init(0, cfg, ep, N_TRAIN,
                                                device=dev), 3)
    torch.cuda.synchronize()
    t = time.perf_counter()
    carry = D.train_chunk(cfg, ep, carry, 20)
    torch.cuda.synchronize()
    loop_step_ms = (time.perf_counter() - t) * 1e3 / 20

    print(json.dumps({"card": card, "k3_k4_by_batch": by_batch,
                      "k3_device_ms_by_rows": by_rows}))
    print(json.dumps({"card": card, "trainer_split": split}))
    print(json.dumps({"card": card, "k6_geometry_sweep": k6_sweep_line}))
    print(json.dumps({
        "card": card,
        "shapes": {"K1": [T_ROLLOUT, N_ENVS], "K2": [T_ROLLOUT, N_ENVS],
                   "K3": [B_MLP, 10], "K4": [B_MLP, 10],
                   "K5": "one step: L0, 1,024 envs, R 4, B 1,024",
                   "K7": "one step: L0, 1,024 envs, R_lo 4, R_up 2, "
                         "B 1,024",
                   "K8": "one step: L0, 1,024 envs, R 8, B 1,024, 1-step",
                   "K9": "one step: L0, 1,024 envs, L 16, R 4, B 1,024",
                   "K6": [T_POLICY, N_ENVS]},
        "k4_greedy_share": k4_kept,
        "k5_chunks": k5,
        "k7_chunk": k7,
        "k8_chunk": k8,
        "k9_chunk": k9,
        "step_loop_train_step_ms": loop_step_ms,
        "step_loop_hdqn_train_step_ms": hdqn_loop_step_ms,
        "launches_by_path": {"bench": bench_launches,
                             "evaluation": eval_launches,
                             "training": train_launches,
                             "h-DQN training": hdqn_launches,
                             "Rainbow training": rb_launches,
                             "DRQN training": drqn_launches,
                             "resume": resume_launches,
                             "spmd": spmd_launches,
                             "m16": m16_launches},
        "k2_long_launch": {"steps": T_COUNTERS_LONG, "envs": N_ENVS,
                           "ms": k1k2["k2_long_ms"],
                           "bound_ms": k1k2["bounds"]["k2_long"][0],
                           "env_steps_per_s": k1k2["k2_long_env_steps_per_s"]},
        "bench": bench_line,
        "k6_eval_launch": {"steps": T_EVAL, "envs": N_ENVS, "ms": full_ms,
                           "bound_ms": full_bound},
        "eval_fused_split": eval_split,
        "main_path_s": phase_s,
        "occupancy_k1_k2": "{blocks} blocks of {threads} threads, {lanes} "
                           "lanes an env, on {sms} SMs".format(
                               **k1k2["geometry"], sms=torch.cuda.
                               get_device_properties(0).multi_processor_count),
    }))
    src = "merging_gym_tpu_torch/kernels/csrc/"
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src + source,
         "replaces": replaces, "launches": launches[count_key],
         "max_abs_err": checks.err[err_key], "ms": ms, "plain_ms": plain,
         "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
        for (name, count_key, source, replaces, err_key, ms, plain, b_ms,
             b_by, lib) in results]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
