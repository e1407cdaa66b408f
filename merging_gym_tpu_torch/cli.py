"""Command-line entry point of the PyTorch / CUDA port.

  python -m merging_gym_tpu_torch.cli [--cpu] eval --p1 SPEC --p2 SPEC \\
      [--fused] [--num-envs N] [--episodes E] [--seed S] [env flags]

SPEC is ``random``, ``l0``, ``const:<a>`` or a Q-net ``params.npz`` (the
JAX package's format, e.g. ``model_zoo/L2/params.npz``).  Runs on the card
unless ``--cpu`` is given; without a card and without ``--cpu`` it fails.
``eval --fused`` plays the whole match as one launch of the policy-rollout
kernel; plain ``eval`` steps the env in a loop with the Q-net kernel.
"""

from __future__ import annotations

import argparse
import json
import os

import torch


def _add_env_args(p):
    p.add_argument("--r-first", type=float, default=2.0)
    p.add_argument("--r-second", type=float, default=1.0)
    p.add_argument("--r-collision", type=float, default=-10.0)
    p.add_argument("--vel-penalty", type=float, default=0.001)
    p.add_argument("--time-penalty", type=float, default=0.0)
    p.add_argument("--random-start", action="store_true",
                   help="randomised start states (merging_env.py:219-221)")
    p.add_argument("--max-steps", type=int, default=None,
                   help="episode step cap (default: the reference's "
                        "float-accumulated 2501, merging_env.py:141-143)")


def _env_params(args):
    from merging_gym_tpu_torch.core.env import EnvParams
    extra = {"max_steps": args.max_steps} if args.max_steps else {}
    return EnvParams(r_first=args.r_first, r_second=args.r_second,
                     r_collision=args.r_collision,
                     vel_penalty=args.vel_penalty,
                     time_penalty=args.time_penalty,
                     random_start=args.random_start, **extra)


def _load_qnet(path, device):
    from merging_gym_tpu_torch.io.checkpoint import load_params_npz
    from merging_gym_tpu_torch.nn.mlp import qnet_params_from_numpy

    if not (path.endswith(".npz") and os.path.exists(path)):
        raise SystemExit(f"cannot load a Q-net from {path!r} "
                         "(expected a params.npz)")
    return qnet_params_from_numpy(load_params_npz(path), device)


def _policy_from_spec(spec: str, device):
    from merging_gym_tpu_torch.agents import policies as P
    from merging_gym_tpu_torch.nn.mlp import qnet_apply

    if spec == "random":
        return P.random_policy()
    if spec == "l0":
        return P.l0_policy()
    if spec.startswith("const:"):
        return P.constant_policy(int(spec.split(":", 1)[1]))
    # Checkpoints play through the reference's Phi(0.7)-greedy actor
    # (human_player.py:158 -> main.py:99-112), as in the JAX CLI.
    return P.q_policy(qnet_apply, _load_qnet(spec, device), greedy=False)


def cmd_eval(args) -> dict:
    from merging_gym_tpu_torch.agents.evaluate import evaluate, evaluate_fused
    from merging_gym_tpu_torch.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    if args.fused:
        if args.p1 == "l0":
            raise SystemExit("--fused needs a Q-net as --p1 (l0 only as --p2)")
        p2 = None if args.p2 == "l0" else _load_qnet(args.p2, device)
        result = evaluate_fused(
            _load_qnet(args.p1, device), p2, _env_params(args),
            num_envs=max(args.num_envs, 128), greedy=False, seed=args.seed,
            device=device)
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        result = evaluate(_policy_from_spec(args.p1, device),
                          _policy_from_spec(args.p2, device),
                          _env_params(args), gen, num_envs=args.num_envs,
                          min_episodes=args.episodes)
    print(json.dumps(result, indent=2))
    return result


def main(argv=None):
    p = argparse.ArgumentParser(prog="merging_gym_tpu_torch")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch versions on the CPU "
                        "(default: the CUDA kernels on the card)")
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("eval", help="head-to-head policy evaluation")
    _add_env_args(pe)
    pe.add_argument("--p1", default="random",
                    help='"random", "l0", "const:<a>" or a params.npz')
    pe.add_argument("--p2", default="l0")
    pe.add_argument("--episodes", type=int, default=512)
    pe.add_argument("--num-envs", type=int, default=256)
    pe.add_argument("--seed", type=int, default=0)
    pe.add_argument("--fused", action="store_true",
                    help="run the match as one launch of the policy-rollout "
                         "kernel (Q-net policies, Phi(0.7)-greedy)")
    pe.set_defaults(fn=cmd_eval)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
