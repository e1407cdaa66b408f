"""Command-line entry point of the PyTorch / CUDA port.

  python -m merging_gym_tpu_torch.cli [--cpu] train \\
      --algo dqn|hdqn|rainbow|drqn \\
      [--fused-kernel] [--opponent L0|selfplay|<params.npz>] ...
  python -m merging_gym_tpu_torch.cli [--cpu] levelk --algo dqn|hdqn \\
      --levels 3 ...
  python -m merging_gym_tpu_torch.cli [--cpu] eval --p1 SPEC --p2 SPEC \\
      [--fused] [--num-envs N] [--episodes E] [--seed S] [env flags]
  python -m merging_gym_tpu_torch.cli bench

SPEC is ``random``, ``l0``, ``const:<a>`` or a Q-net ``params.npz`` (the
JAX package's format, e.g. ``model_zoo/L2/params.npz``).  Runs on the card
unless ``--cpu`` is given; without a card and without ``--cpu`` it fails.

``train --algo dqn --fused-kernel`` runs the single-kernel trainer (K5,
``ops.fused_trainer``), plain ``train --algo dqn`` the step-loop trainer
(``agents.dqn``, its actor K4).  ``train --algo hdqn --fused-kernel`` runs
the h-DQN trainer K7 (``ops.fused_hdqn``), plain ``train --algo hdqn`` the
step loop of ``agents.hdqn`` (its actors K4); an h-DQN run writes its
meta-controller and low net as ``{"upper", "lower"}`` and a frozen h-DQN
opponent is such a ``params.npz``.  ``train --algo rainbow --fused-kernel``
runs the Rainbow trainer K8 (``ops.fused_rainbow``), plain ``train --algo
rainbow`` the step loop of ``agents.rainbow``, with ``--per``,
``--per-alpha``, ``--per-beta``, ``--n-step`` and ``--obs-scale``; its
frozen opponent is an MLP Q-net ``params.npz``.  ``train --algo drqn
--fused-kernel`` runs the DRQN trainer K9 (``ops.fused_drqn``), plain
``train --algo drqn`` the step loop of ``agents.drqn``; a frozen DRQN
opponent is the ``params.npz`` of a drqn run.  Every run writes
``params.npz`` in the JAX key format and logs
``scalars.jsonl``/``scalars.csv``.  ``levelk`` trains L1 against L0, then
each level against the frozen one before it (dqn and hdqn).
``bench`` prints the env-steps/s of the reduce-on-chip rollout (K2) at
4,096 envs as one JSON line (``merging_gym_tpu_torch.bench``); it measures
the card and refuses ``--cpu``.
``--resume``/``--checkpoint-every``, ``--plot-every`` and a reference
``.pth`` opponent are not ported yet and exit with an error.
"""

from __future__ import annotations

import argparse
import json
import os
import time

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


# Flags of the JAX CLI whose code paths are not ported yet: a run that
# sets one exits instead of ignoring it.
_NOT_PORTED = ("--resume", "--checkpoint-every", "--plot-every")


def _train_args(p):
    _add_env_args(p)
    p.add_argument("--algo", choices=["dqn", "hdqn", "rainbow", "drqn"],
                   default="dqn")
    p.add_argument("--opponent", default="L0",
                   help='"L0", "selfplay", or a params.npz (frozen; for '
                        'hdqn the {upper, lower} nets of an hdqn run, for '
                        'drqn the net of a drqn run)')
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--episodes", type=int, default=2000,
                   help="stop once this many episodes completed (main.py:170)")
    p.add_argument("--max-chunks", type=int, default=10000)
    p.add_argument("--chunk-steps", type=int, default=200)
    p.add_argument("--memory-capacity", type=int, default=None)
    p.add_argument("--goal-memory-capacity", type=int, default=None,
                   help="hdqn: the meta-controller's replay (default 200; "
                        "with --fused-kernel 2 x num-envs)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--gamma", type=float, default=None,
                   help="discount (dqn/hdqn default 0.90, main.py:15; "
                        "rainbow default 0.99, ranbowdqn.py:593)")
    p.add_argument("--epsilon", type=float, default=None,
                   help="Phi(eps)-greedy exploration threshold (main.py:105;"
                        " default 0.7; rainbow default none: NoisyNet only)")
    p.add_argument("--per", action="store_true",
                   help="prioritised replay (rainbow)")
    p.add_argument("--per-alpha", type=float, default=0.6,
                   help="PER priority exponent (ranbowdqn.py:344)")
    p.add_argument("--per-beta", type=float, default=0.4,
                   help="PER importance-weight exponent")
    p.add_argument("--n-step", type=int, default=1,
                   help="n-step returns (rainbow)")
    p.add_argument("--obs-scale", type=float, default=None,
                   help="rainbow: multiply observations by this before the "
                        "net (0.01 keeps the C51 streams alive; default "
                        "none = the reference's raw obs)")
    p.add_argument("--hidden", type=int, nargs=2, default=None,
                   metavar=("H1", "H2"),
                   help="Q-net hidden widths (default 200 100)")
    p.add_argument("--compute-dtype", default="float32",
                   choices=("float32", "bfloat16"),
                   help="forward-pass dtype (master params stay f32)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None,
                   help="run directory (default: reference-style name)")
    p.add_argument("--fused-kernel", action="store_true",
                   help="run the whole trainer on the card as a kernel "
                        "sequence: K5 for dqn (ops.fused_trainer), K7 for "
                        "hdqn (ops.fused_hdqn), K8 for rainbow "
                        "(ops.fused_rainbow), K9 for drqn "
                        "(ops.fused_drqn); learner batch = num-envs unless "
                        "--learn-batch")
    p.add_argument("--learn-batch", type=int, default=None,
                   help="with --fused-kernel: lanes per learn (multiple of "
                        "128 dividing num-envs; default num-envs)")
    p.add_argument("--learn-rounds", type=int, default=1,
                   help="with --fused-kernel: compose each learn batch from "
                        "K independent (round, lane-window) draws of "
                        "learn-batch/K lanes (needs learn-batch %% (128*K) "
                        "== 0)")
    p.add_argument("--greedy-actor", action="store_true",
                   help="with --fused-kernel: pure-argmax actor "
                        "(deterministic, no Philox draws)")
    for flag in _NOT_PORTED:
        p.add_argument(flag, nargs="?", const=True, default=None,
                       help="not yet ported")


def _refuse_unported(args):
    if args.algo in ("rainbow", "drqn") and (
            args.hidden or args.compute_dtype != "float32"):
        raise SystemExit("--hidden/--compute-dtype are wired into the dqn "
                         f"and hdqn trainers only; --algo {args.algo} would "
                         "silently ignore them (drop the flags or switch "
                         "algo)")
    if args.algo in ("rainbow", "drqn") and args.learn_rounds != 1:
        raise SystemExit("--learn-rounds is a dqn-only fused option "
                         f"({args.algo} supports --learn-batch)")
    if args.algo == "hdqn" and args.hidden:
        raise SystemExit("--hidden is wired into the dqn trainer only")
    if args.algo == "hdqn" and args.learn_rounds != 1:
        raise SystemExit("--learn-rounds is a dqn-only option (hdqn "
                         "supports --learn-batch)")
    for flag in _NOT_PORTED:
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            raise SystemExit(f"{flag} is not yet ported to the PyTorch "
                             "package")


def _opponent_mode(opponent: str) -> str:
    """``--opponent`` -> mode (main.py:161-168's Strategy_OP switch)."""
    from merging_gym_tpu_torch.agents import dqn as D
    return {"L0": D.OPP_L0, "selfplay": D.OPP_SELFPLAY}.get(opponent,
                                                            D.OPP_FROZEN)


def _load_frozen_hdqn(path, device):
    """A frozen hierarchical opponent: the ``{"upper", "lower"}`` nets of a
    ``params.npz`` that an h-DQN run wrote.  The JAX CLI also reads a
    reference ``.pth`` run directory (``io/torch_import``), not ported yet."""
    from merging_gym_tpu_torch.io.checkpoint import load_params_npz
    from merging_gym_tpu_torch.nn.mlp import qnet_params_from_numpy

    if os.path.isdir(path):
        raise SystemExit(f"{path!r}: a reference .pth run directory as an "
                         "h-DQN opponent is not yet ported to the PyTorch "
                         "package (pass a params.npz)")
    if not (path.endswith(".npz") and os.path.exists(path)):
        raise SystemExit(f"cannot load a frozen h-DQN opponent from {path!r} "
                         "(expected the params.npz of an h-DQN run)")
    nets = load_params_npz(path)
    if set(nets) != {"upper", "lower"}:
        raise SystemExit(f"{path!r} holds {sorted(nets)}, not the "
                         "{upper, lower} nets of an h-DQN run")
    return (qnet_params_from_numpy(nets["upper"], device),
            qnet_params_from_numpy(nets["lower"], device))


def _load_frozen_drqn(path, device):
    """A frozen recurrent opponent: the net of a ``params.npz`` that a
    ``train --algo drqn`` run wrote (the ``nn.lstm.drqn_init`` layout)."""
    from merging_gym_tpu_torch.io.checkpoint import load_params_npz
    from merging_gym_tpu_torch.nn.lstm import drqn_params_from_numpy

    if not (path.endswith(".npz") and os.path.exists(path)):
        raise SystemExit(f"cannot load frozen drqn opponent from {path} "
                         "(expected a params.npz from a --algo drqn run)")
    nets = load_params_npz(path)
    if set(nets) != {"fc1", "fc2", "lstm", "fc3", "fc4"}:
        raise SystemExit(f"{path!r} holds {sorted(nets)}, not the net of a "
                         "drqn run")
    return drqn_params_from_numpy(nets, device)


def _fused_scalars(c, learns_key, learns_name):
    eps = max(c["episodes"], 1.0)
    return {"env_steps": c["env_steps"], "episodes": c["episodes"],
            "collision_rate": c["collisions"] / eps,
            "win_rate": c["wins"] / eps,
            "reward": c["sum_ep_reward"] / eps,
            "loss": c["last_loss"], learns_name: c[learns_key]}


def _dqn_trainer(args, env_params, common, device):
    """``(carry, chunk, scalars_of, params_of)`` of a DQN run."""
    from merging_gym_tpu_torch.agents import dqn as D
    from merging_gym_tpu_torch.io.metrics import rates_from_counters
    from merging_gym_tpu_torch.ops import fused_trainer as FT

    opp = (_load_qnet(args.opponent, device)
           if common["opponent"] == D.OPP_FROZEN else None)
    if args.fused_kernel:
        cfg = D.DQNConfig(
            memory_capacity=args.memory_capacity or 4 * args.num_envs,
            **common)
        carry = FT.fused_dqn_init(args.seed, cfg, env_params, args.num_envs,
                                  opp, learn_batch=args.learn_batch,
                                  learn_rounds=args.learn_rounds,
                                  device=device)

        def chunk(c):
            # Seed = run seed + global step count, as in the JAX CLI.
            return FT.fused_dqn_chunk(cfg, env_params, c, args.chunk_steps,
                                      seed=args.seed + c["steps"],
                                      greedy=args.greedy_actor)

        return (carry, chunk,
                lambda c: _fused_scalars(c, "learns", "learns"),
                lambda c: FT.t_to_params(c["p"]))
    cfg = D.DQNConfig(
        memory_capacity=args.memory_capacity or max(2000, 2 * args.num_envs),
        batch_size=args.batch_size or 128, **common)
    carry = D.train_init(args.seed, cfg, env_params, args.num_envs, opp,
                         device=device)

    def scalars_of(c):
        return {**rates_from_counters(c.metrics),
                "loss": float(c.dqn.last_loss),
                "learns": int(c.dqn.learn_counter)}

    return (carry, lambda c: D.train_chunk(cfg, env_params, c,
                                           args.chunk_steps),
            scalars_of, lambda c: c.dqn.params)


def _hdqn_trainer(args, env_params, common, device):
    """``(carry, chunk, scalars_of, params_of)`` of an h-DQN run: the K7
    trainer with ``--fused-kernel``, else the step loop (cli.py:278-340,
    479-497 of the JAX package, with its defaults)."""
    from merging_gym_tpu_torch.agents import dqn as D
    from merging_gym_tpu_torch.agents import hdqn as H
    from merging_gym_tpu_torch.io.metrics import rates_from_counters
    from merging_gym_tpu_torch.ops import fused_hdqn as FH
    from merging_gym_tpu_torch.ops import fused_trainer as FT

    opp_u = opp_l = None
    if common["opponent"] == D.OPP_FROZEN:
        opp_u, opp_l = _load_frozen_hdqn(args.opponent, device)
    if args.fused_kernel:
        cfg = H.HDQNConfig(
            memory_capacity=args.memory_capacity or 4 * args.num_envs,
            goal_memory_capacity=(args.goal_memory_capacity
                                  or 2 * args.num_envs),
            **common)
        carry = FH.fused_hdqn_init(args.seed, cfg, env_params, args.num_envs,
                                   opp_u, opp_l,
                                   learn_batch=args.learn_batch,
                                   device=device)

        def chunk(c):
            return FH.fused_hdqn_chunk(cfg, env_params, c, args.chunk_steps,
                                       seed=args.seed + c["steps"],
                                       greedy=args.greedy_actor)

        return (carry, chunk,
                lambda c: _fused_scalars(c, "lo_learns", "lower_learns"),
                lambda c: {"upper": FT.t_to_params(c["u_p"]),
                           "lower": FT.t_to_params(c["l_p"])})
    cfg = H.HDQNConfig(
        memory_capacity=args.memory_capacity or max(2000, 2 * args.num_envs),
        goal_memory_capacity=args.goal_memory_capacity or 200,
        batch_size=args.batch_size or 128, **common)
    carry = H.hdqn_init(args.seed, cfg, env_params, args.num_envs, opp_u,
                        opp_l, device=device)

    def scalars_of(c):
        return {**rates_from_counters(c.metrics),
                "loss": float(c.lower.last_loss),
                "meta_loss": float(c.upper.last_loss)}

    return (carry, lambda c: H.hdqn_train_chunk(cfg, env_params, c,
                                                args.chunk_steps),
            scalars_of, lambda c: {"upper": c.upper.params,
                                   "lower": c.lower.params})


def _rainbow_trainer(args, env_params, common, device):
    """``(carry, chunk, scalars_of, params_of)`` of a Rainbow run: K8 with
    ``--fused-kernel``, else the step loop (cli.py:342-399, 516-529 of the
    JAX package, with its defaults)."""
    from merging_gym_tpu_torch.agents import dqn as D
    from merging_gym_tpu_torch.agents import rainbow as RB
    from merging_gym_tpu_torch.io.metrics import rates_from_counters
    from merging_gym_tpu_torch.ops import fused_rainbow as FRB

    opp = None
    if common["opponent"] == D.OPP_FROZEN:
        if os.path.isdir(args.opponent):
            raise SystemExit(f"{args.opponent!r}: a reference .pth run "
                             "directory as an opponent is not yet ported to "
                             "the PyTorch package (pass a params.npz)")
        opp = _load_qnet(args.opponent, device)
    kw = dict(opponent=common["opponent"], per=args.per,
              per_alpha=args.per_alpha, per_beta=args.per_beta,
              n_step=args.n_step,
              gamma=args.gamma if args.gamma is not None else 0.99,
              epsilon=args.epsilon, obs_scale=args.obs_scale,
              lr=args.lr or 1e-3)
    if args.fused_kernel:
        cfg = RB.RainbowConfig(
            memory_capacity=args.memory_capacity or 8 * args.num_envs, **kw)
        carry = FRB.fused_rainbow_init(args.seed, cfg, env_params,
                                       args.num_envs, opp,
                                       learn_batch=args.learn_batch,
                                       device=device)

        def chunk(c):
            return FRB.fused_rainbow_chunk(cfg, env_params, c,
                                           args.chunk_steps,
                                           seed=args.seed + c["steps"],
                                           greedy=args.greedy_actor)

        return (carry, chunk,
                lambda c: _fused_scalars(c, "learns", "learns"),
                lambda c: FRB.flat_to_params(c["p"]))
    cfg = RB.RainbowConfig(memory_capacity=args.memory_capacity or 10000,
                           batch_size=args.batch_size or 32, **kw)
    carry = RB.rainbow_train_init(args.seed, cfg, env_params, args.num_envs,
                                  opp, device=device)

    def scalars_of(c):
        return {**rates_from_counters(c.metrics),
                "loss": float(c.last_loss),
                "learns": int(c.opt_state.count)}

    return (carry, lambda c: RB.rainbow_train_chunk(cfg, env_params, c,
                                                    args.chunk_steps),
            scalars_of, lambda c: c.params)


def _drqn_trainer(args, env_params, common, device):
    """``(carry, chunk, scalars_of, params_of)`` of a DRQN run: K9 with
    ``--fused-kernel``, else the step loop (cli.py:404-458, 498-512 of the
    JAX package, with its defaults)."""
    from merging_gym_tpu_torch.agents import dqn as D
    from merging_gym_tpu_torch.agents import drqn as DR
    from merging_gym_tpu_torch.io.metrics import rates_from_counters
    from merging_gym_tpu_torch.ops import fused_drqn as FD

    opp = (_load_frozen_drqn(args.opponent, device)
           if common["opponent"] == D.OPP_FROZEN else None)
    kw = {k: common[k] for k in ("opponent", "lr", "gamma", "epsilon")}
    if args.fused_kernel:
        cfg = DR.DRQNConfig(
            memory_capacity=args.memory_capacity or 4 * args.num_envs, **kw)
        carry = FD.fused_drqn_init(args.seed, cfg, env_params, args.num_envs,
                                   opp, learn_batch=args.learn_batch,
                                   device=device)

        def chunk(c):
            return FD.fused_drqn_chunk(cfg, env_params, c, args.chunk_steps,
                                       seed=args.seed + c["steps"],
                                       greedy=args.greedy_actor)

        return (carry, chunk,
                lambda c: _fused_scalars(c, "learns", "learns"),
                lambda c: FD.t_to_drqn_params(c["p"]))
    # Windows flush on every lane at once, so the ring holds at least two
    # flushes (drqn_train_init checks one).
    cfg = DR.DRQNConfig(
        memory_capacity=args.memory_capacity or max(512, 2 * args.num_envs),
        batch_size=args.batch_size or 32, **kw)
    carry = DR.drqn_train_init(args.seed, cfg, env_params, args.num_envs,
                               opp, device=device)

    def scalars_of(c):
        return {**rates_from_counters(c.metrics),
                "loss": float(c.last_loss),
                "learns": int(c.learn_counter)}

    return (carry, lambda c: DR.drqn_train_chunk(cfg, env_params, c,
                                                 args.chunk_steps),
            scalars_of, lambda c: c.params)


def cmd_train(args) -> str:
    """Train one DQN, h-DQN, Rainbow or DRQN agent; returns the run
    directory."""
    from merging_gym_tpu_torch.device import resolve_device
    from merging_gym_tpu_torch.io.checkpoint import (run_dir_name,
                                                     save_params_npz)
    from merging_gym_tpu_torch.io.metrics import MetricsWriter

    _refuse_unported(args)
    device = resolve_device("cpu" if args.cpu else None)
    env_params = _env_params(args)
    if args.fused_kernel and env_params.random_start and args.greedy_actor:
        raise SystemExit("--random-start draws from the actor's Philox "
                         "stream, which --greedy-actor skips; drop one of "
                         "the two")
    common = dict(
        opponent=_opponent_mode(args.opponent), lr=args.lr or 0.01,
        gamma=args.gamma if args.gamma is not None else 0.90,
        epsilon=args.epsilon if args.epsilon is not None else 0.7,
        hidden=tuple(args.hidden) if args.hidden else (200, 100),
        compute_dtype=args.compute_dtype)
    trainer = {"dqn": _dqn_trainer, "hdqn": _hdqn_trainer,
               "rainbow": _rainbow_trainer, "drqn": _drqn_trainer}[args.algo]
    carry, chunk, scalars_of, params_of = trainer(args, env_params, common,
                                                  device)
    out = args.out or run_dir_name(f" {args.algo}", args.opponent,
                                   env_params.reward_tuple())
    os.makedirs(out, exist_ok=True)
    writer = MetricsWriter(out)
    t0 = time.time()
    for i in range(args.max_chunks):
        carry = chunk(carry)
        scalars = scalars_of(carry)
        scalars["env_steps_per_sec"] = (scalars["env_steps"]
                                        / (time.time() - t0))
        writer.log(i, scalars)
        print(f"chunk {i}: {json.dumps(scalars)}", flush=True)
        if scalars["episodes"] >= args.episodes:
            break
    save_params_npz(os.path.join(out, "params.npz"), params_of(carry))
    writer.close()
    print(f"run saved to {out}")
    return out


def cmd_levelk(args) -> list:
    """Level-k curriculum (main.py:161-168): L1 trains vs L0, L2 vs frozen
    L1, ..., each level in its own run directory; returns them."""
    if args.algo not in ("dqn", "hdqn"):
        raise SystemExit(
            f"levelk supports --algo dqn or hdqn (got {args.algo!r}): "
            "the curriculum freezes each rung as the next opponent, and "
            "only MLP Q-nets can be frozen opponents (rainbow can train "
            "VS a frozen rung via train --opponent <npz>, but a frozen "
            "rainbow policy is not a supported opponent; drqn has "
            "neither mode)")
    prev, runs = "L0", []
    for level in range(1, args.levels + 1):
        sub = argparse.Namespace(**vars(args))
        sub.opponent = prev if level == 1 else os.path.join(prev,
                                                            "params.npz")
        sub.out = os.path.join(args.out or "levelk_runs", f"L{level}")
        print(f"=== training L{level} vs {sub.opponent} ===", flush=True)
        prev = cmd_train(sub)
        runs.append(prev)
    return runs


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


def cmd_bench(args) -> dict:
    if args.cpu:
        raise SystemExit("bench measures the card: --cpu is refused")
    from merging_gym_tpu_torch import bench
    return bench.main()


def main(argv=None):
    p = argparse.ArgumentParser(prog="merging_gym_tpu_torch")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch versions on the CPU "
                        "(default: the CUDA kernels on the card)")
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train", help="train one agent")
    _train_args(pt)
    pt.set_defaults(fn=cmd_train)

    pl = sub.add_parser("levelk", help="level-k opponent curriculum")
    _train_args(pl)
    pl.add_argument("--levels", type=int, default=2)
    pl.set_defaults(fn=cmd_levelk)

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

    pb = sub.add_parser("bench", help="env-steps/s of the reduce-on-chip "
                                      "rollout at 4,096 envs (one JSON line)")
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
