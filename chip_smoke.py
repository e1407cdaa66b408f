#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one NVIDIA H100 and hold every kernel
against its plain PyTorch version.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each of which raises (non-zero exit) on failure:
  1. print the card (nvidia-smi) and build the CUDA kernels from
     ``merging_gym_tpu_torch/kernels/csrc`` (one nvcc per source, in parallel);
  2. run each kernel and its plain version on the same inputs on the card,
     at the main path's shapes, and compare at the JAX tests' tolerances;
  3. the main path, with every launch count set to 0 just before it and
     read just after: the env rollout at 4,096 envs as ``bench.py`` drives
     it (K1 trajectories, K2 counters), then ``eval --fused`` of
     model_zoo/L2 vs L1 at 4,096 envs x 2,600 steps (K6) and plain
     ``eval`` at 256 envs (K3 per step), through the port's CLI;
  4. greedy ``evaluate`` (K3) must equal greedy ``evaluate_fused`` (K6);
  5. time every kernel with CUDA events beside its plain version, the
     least time the card could take (``bound_ms``) and, for K3, the three
     ``torch.addmm`` + ReLU library calls.
Prints one JSON line of per-kernel results, then, last,
``{"ok": true, "device": {...}}``.  Without CUDA it exits non-zero.
"""

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
ZOO_L1 = os.path.join(REPO, "model_zoo", "L1", "params.npz")
ZOO_L2 = os.path.join(REPO, "model_zoo", "L2", "params.npz")

N_ENVS = 4096          # bench.py's headline env count
T_ROLLOUT = 512        # K1/K2 check and timing length
T_COUNTERS_LONG = 65536  # K2 launch long enough to amortise launch cost
T_POLICY = 768         # K6 check and timing length: Phi-greedy L2 vs L1
                       # episodes last ~500 steps (the plain version is slow)
T_EVAL = 2600          # evaluate_fused's default length
B_MLP = 4096
B_RAGGED = 1001

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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np

    from merging_gym_tpu_torch import cli, kernels
    from merging_gym_tpu_torch.agents import policies as P
    from merging_gym_tpu_torch.agents.evaluate import evaluate, evaluate_fused
    from merging_gym_tpu_torch.core.env import EnvParams
    from merging_gym_tpu_torch.io.checkpoint import load_params_npz
    from merging_gym_tpu_torch.nn.mlp import qnet_apply, qnet_params_from_numpy
    from merging_gym_tpu_torch.ops import fused_mlp as FM
    from merging_gym_tpu_torch.ops import fused_policy_rollout as FPR
    from merging_gym_tpu_torch.ops import fused_rollout as FR

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
    modes = {"actions": {"actions": actions},
             "seed": {"seed": 12345, "device": dev}}
    for mode, kw in modes.items():
        k1 = FR.fused_rollout(T_ROLLOUT, N_ENVS, **kw)
        k1p = FR.fused_rollout_plain(T_ROLLOUT, N_ENVS, **kw)
        checks.events("K1", mode, k1, k1p, ("done", "winner", "collision"),
                      {"obs": (1e-6, 1e-3), **ev_tol})
        k2 = FR.fused_rollout_counters(T_ROLLOUT, N_ENVS, **kw)
        k2p = FR.fused_rollout_counters_plain(T_ROLLOUT, N_ENVS, **kw)
        counts = ("episodes", "collisions", "wins1", "wins2")
        checks.events("K2", mode, k2, k2p, counts,
                      {"reward_sum": (1e-6, 1e-6)})
        # K2 against K1's reductions (tests/test_fused_rollout_counters.py;
        # summed in another order, so not part of K2's error vs its plain
        # version).
        d, w, c = k1["done"], k1["winner"], k1["collision"]
        red = {"episodes": d.sum(0), "collisions": c.sum(0),
               "wins1": (d & (w == 1) & ~c).sum(0),
               "wins2": (d & (w == 2) & ~c).sum(0)}
        for k in counts:
            checks.equal("K2 vs K1", f"{mode} {k}", k2[k], red[k])
        checks.close("K2 vs K1", f"{mode} reward_sum", k2["reward_sum"],
                     k1["rewards"].sum(0), 1e-5, 1e-3)
        assert int(k2["episodes"].sum()) > 0 and int(k2["collisions"].sum()) > 0
        print(f"K1/K2 {mode}: {int(k2['episodes'].sum())} episodes, "
              f"{int(k2['collisions'].sum())} collisions in "
              f"{T_ROLLOUT} x {N_ENVS}", flush=True)

    for b in (B_MLP, B_RAGGED):
        x = torch.as_tensor(rng.standard_normal((b, 10)) * 100,
                            dtype=torch.float32, device=dev)
        for cd in ("float32", "bfloat16"):
            checks.close("K3", f"B={b} {cd}", FM.qnet_apply_fused(p_l2, x, cd),
                         FM.qnet_apply_plain(p_l2, x, cd), 1e-5, 1e-3)
    print("K3: B=4096 and B=1001, f32 and bf16 agree", flush=True)

    policy_cases = {
        "greedy vs L0": (p_l2, None, dict(greedy=True)),
        # Greedy L2 vs L1 both brake from the deterministic start; a
        # 300-step cap makes the timeout and auto-reset part of the check.
        "greedy L2 vs L1": (p_l2, p_l1, dict(
            greedy=True, env_params=EnvParams(max_steps=300))),
        "phi-greedy L2 vs L1": (p_l2, p_l1, dict(greedy=False, seed=1)),
        "random_start": (p_l2, p_l1, dict(
            greedy=False, seed=2, env_params=EnvParams(random_start=True))),
        "bf16": (p_l2, p_l1, dict(greedy=False, seed=3,
                                  compute_dtype="bfloat16")),
    }
    for what, (pa, pb, kw) in policy_cases.items():
        got = FPR.fused_policy_rollout(T_POLICY, N_ENVS, pa, pb, **kw)
        want = FPR.fused_policy_rollout_plain(T_POLICY, N_ENVS, pa, pb, **kw)
        checks.events("K6", what, got, want,
                      ("actions", "done", "winner", "collision"), ev_tol)
        print(f"K6 {what}: {int(got['done'].sum())} episodes agree",
              flush=True)

    # ---- 3. the main path ------------------------------------------------
    phase_s = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        phase_s[name] = time.perf_counter() - t
        return out

    kernels.reset_launch_counts()
    traj = timed("fused_rollout", lambda: FR.fused_rollout(
        T_ROLLOUT, N_ENVS, seed=7, device=dev))
    cnt = timed("fused_rollout_counters", lambda: FR.fused_rollout_counters(
        T_COUNTERS_LONG, N_ENVS, seed=7, device=dev))
    fused = timed("eval --fused", lambda: cli.main(
        ["eval", "--fused", "--p1", ZOO_L2, "--p2", ZOO_L1,
         "--num-envs", str(N_ENVS)]))
    loop = timed("eval", lambda: cli.main(
        ["eval", "--p1", ZOO_L2, "--p2", ZOO_L1, "--num-envs", "256"]))
    launches = dict(kernels.launch_counts)
    main_s = sum(phase_s.values())
    print(f"main path: {main_s:.2f} s {phase_s}, launches {launches}",
          flush=True)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")
    assert traj["obs"].shape == (T_ROLLOUT, 10, N_ENVS)
    assert torch.isfinite(traj["obs"]).all() and torch.isfinite(
        cnt["reward_sum"]).all()
    assert (cnt["wins1"] + cnt["wins2"] <= cnt["episodes"]).all()
    assert int(cnt["episodes"].sum()) > N_ENVS
    for res, min_eps in ((fused, N_ENVS), (loop, 512)):
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

    # K1, actions mode
    out = FR.empty_rollout(T_ROLLOUT, N_ENVS, dev)
    ep = EnvParams()
    ms = cuda_ms(torch, lambda: FR.launch_rollout(out, actions, None, ep), 10)
    plain = cuda_ms(torch, lambda: FR.fused_rollout_plain(
        T_ROLLOUT, N_ENVS, actions=actions), 3)
    b_ms, b_by = bound(envs * FR.K1_BYTES_PER_ENV_STEP,
                       envs * (ENV_STEP_FLOPS + OBS_FLOPS))
    results.append(("K1 env_rollout", "env_rollout", "env_rollout.cu",
                    "merging_gym_tpu/ops/fused_rollout.py:116", "K1",
                    ms, plain, b_ms, b_by, None))

    # K2, seed mode (bench.py's action source), and a long launch
    rs = torch.empty(2, N_ENVS, device=dev)
    cs = torch.empty(4, N_ENVS, dtype=torch.int32, device=dev)
    ms = cuda_ms(torch, lambda: FR.launch_counters(rs, cs, T_ROLLOUT, None,
                                                   12345, ep), 10)
    plain = cuda_ms(torch, lambda: FR.fused_rollout_counters_plain(
        T_ROLLOUT, N_ENVS, seed=12345, device=dev), 3)
    b_ms, b_by = bound(N_ENVS * 24, envs * (ENV_STEP_FLOPS + 2))
    results.append(("K2 env_counters", "env_counters", "env_rollout.cu",
                    "merging_gym_tpu/ops/fused_rollout.py:168", "K2",
                    ms, plain, b_ms, b_by, None))
    long_ms = cuda_ms(torch, lambda: FR.launch_counters(
        rs, cs, T_COUNTERS_LONG, None, 12345, ep), 5)
    long_bound, _ = bound(N_ENVS * 24,
                          T_COUNTERS_LONG * N_ENVS * (ENV_STEP_FLOPS + 2))
    k2_rate = T_COUNTERS_LONG * N_ENVS / (long_ms / 1e3)

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

    print(json.dumps({
        "card": card,
        "shapes": {"K1": [T_ROLLOUT, N_ENVS], "K2": [T_ROLLOUT, N_ENVS],
                   "K3": [B_MLP, 10], "K6": [T_POLICY, N_ENVS]},
        "k2_long_launch": {"steps": T_COUNTERS_LONG, "envs": N_ENVS,
                           "ms": long_ms, "bound_ms": long_bound,
                           "env_steps_per_s": k2_rate},
        "k6_eval_launch": {"steps": T_EVAL, "envs": N_ENVS, "ms": full_ms,
                           "bound_ms": full_bound},
        "main_path_s": phase_s,
        "occupancy_k1_k2": f"{(N_ENVS + 127) // 128} blocks of 128 threads "
                           f"on {torch.cuda.get_device_properties(0).multi_processor_count} SMs",
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
