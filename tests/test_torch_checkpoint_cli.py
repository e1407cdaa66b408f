"""``--checkpoint-every``, ``--resume`` and ``--plot-every`` of the port's
CLI on the CPU.

For each algo, fused and step loop, three runs through ``cli.main``: A
(``--max-chunks 2 --checkpoint-every 1``), B (``--max-chunks 1 --resume
A``) and C (``--max-chunks 3``, uninterrupted).  B's ``params.npz`` must
equal C's bit for bit, and B's last ``scalars.jsonl`` row C's.  A SIGKILLed
run resumes (``tests/test_fused_trainer_recovery.py:97-133`` for the
port), an orbax directory is refused, and ``curves.png`` is drawn by the
step loops only.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from merging_gym_tpu_torch import cli
from merging_gym_tpu_torch.io.checkpoint import (CheckpointManager,
                                                 load_params_npz)
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIG = "1000000000"

RUNS = {
    # name: (flags, envs, chunk steps)
    "dqn_fused": (["--algo", "dqn", "--fused-kernel",
                   "--memory-capacity", "256"], 128, 3),
    "dqn_loop": (["--algo", "dqn", "--opponent", "selfplay",
                  "--memory-capacity", "64", "--batch-size", "8"], 16, 4),
    "hdqn_fused": (["--algo", "hdqn", "--fused-kernel", "--memory-capacity",
                    "256", "--goal-memory-capacity", "256"], 128, 2),
    "hdqn_loop": (["--algo", "hdqn", "--opponent", "selfplay",
                   "--memory-capacity", "48", "--goal-memory-capacity", "32",
                   "--batch-size", "8"], 16, 4),
    "rainbow_fused_per_3step": (["--algo", "rainbow", "--fused-kernel",
                                 "--per", "--n-step", "3", "--obs-scale",
                                 "0.01", "--memory-capacity", "512"], 128, 3),
    "rainbow_loop": (["--algo", "rainbow", "--opponent", "selfplay",
                      "--memory-capacity", "64", "--batch-size", "8"], 16, 4),
    # 16-step windows in R = 2 rounds: K9 learns from step 31 on.
    "drqn_fused": (["--algo", "drqn", "--fused-kernel",
                    "--memory-capacity", "256"], 128, 11),
    "drqn_loop": (["--algo", "drqn", "--opponent", "selfplay",
                   "--memory-capacity", "32", "--batch-size", "4"], 16, 8),
}


def _train(flags, n, steps, out, *extra):
    return cli.main(["--cpu", "train", *flags, "--num-envs", str(n),
                     "--chunk-steps", str(steps), "--episodes", BIG,
                     "--out", str(out), *extra])


def _rows(run):
    with open(os.path.join(run, "scalars.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _flat(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("name", sorted(RUNS))
def test_resumed_run_equals_uninterrupted(tmp_path, capsys, name):
    flags, n, steps = RUNS[name]
    a, b, c = (str(tmp_path / x) for x in "abc")
    _train(flags, n, steps, a, "--max-chunks", "2", "--checkpoint-every", "1")
    assert CheckpointManager(os.path.join(a, "ckpt")).all_steps() == [0, 1, 2]
    capsys.readouterr()
    _train(flags, n, steps, b, "--max-chunks", "1", "--resume", a)
    assert f"resumed from {a} at step {2 * steps * n}\n" in \
        capsys.readouterr().out
    _train(flags, n, steps, c, "--max-chunks", "3")
    assert not os.path.exists(os.path.join(c, "ckpt"))
    got = dict(_flat(load_params_npz(os.path.join(b, "params.npz"))))
    want = dict(_flat(load_params_npz(os.path.join(c, "params.npz"))))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    last_b, last_c = _rows(b)[-1], _rows(c)[-1]
    assert (last_b["step"], last_c["step"]) == (0, 2)
    for k in set(last_c) - {"step", "wall_time", "env_steps_per_sec"}:
        assert last_b[k] == last_c[k], k
    assert last_c["env_steps"] == 3 * steps * n
    learned = last_c.get("learns", last_c.get("lower_learns"))
    assert learned is None or learned > 0


def test_resume_into_its_own_run_dir(tmp_path):
    """``--resume A --out A``: the resumed run's chunk indices start at 0
    again, so its saves at or below A's newest step are skipped (as orbax
    skips them) and the step it resumed from stays."""
    flags, n, steps = RUNS["dqn_fused"]
    a = str(tmp_path / "a")
    _train(flags, n, steps, a, "--max-chunks", "2", "--checkpoint-every", "1")
    _train(flags, n, steps, a, "--max-chunks", "2", "--checkpoint-every", "1",
           "--resume", a)
    assert CheckpointManager(os.path.join(a, "ckpt")).all_steps() == [0, 1, 2]
    assert [r["step"] for r in _rows(a)] == [0, 1, 0, 1]
    assert _rows(a)[-1]["env_steps"] == 4 * steps * n


def test_resume_refuses_orbax_and_missing_checkpoints(tmp_path):
    from merging_gym_tpu.io.checkpoint import CheckpointManager as JaxManager

    flags, n, steps = RUNS["dqn_loop"]
    jm = JaxManager(str(tmp_path / "jax_run" / "ckpt"))
    jm.save(0, {"a": np.zeros(2)}, wait=True)
    jm.close()
    out = tmp_path / "out"
    with pytest.raises(SystemExit, match="orbax checkpoints of the JAX "
                                         "package"):
        _train(flags, n, steps, out, "--resume", str(tmp_path / "jax_run"))
    with pytest.raises(SystemExit, match="no checkpoints under"):
        _train(flags, n, steps, out, "--resume", str(tmp_path / "nowhere"))
    assert not out.exists()


def test_resume_with_other_flags_is_refused(tmp_path):
    flags, n, steps = RUNS["dqn_fused"]
    a = str(tmp_path / "a")
    _train(flags, n, steps, a, "--max-chunks", "1", "--checkpoint-every", "1")
    with pytest.raises(SystemExit, match=r"cannot resume from .*"
                                         r"state\['ring'\]"):
        _train(["--algo", "dqn", "--fused-kernel", "--memory-capacity",
                "384"], n, steps, tmp_path / "b", "--max-chunks", "1",
               "--resume", a)
    with pytest.raises(SystemExit, match="cannot resume from"):
        _train(RUNS["hdqn_fused"][0], n, steps, tmp_path / "c",
               "--max-chunks", "1", "--resume", a)


@pytest.mark.parametrize("name,drawn", [("dqn_loop", True),
                                        ("dqn_fused", False)])
def test_plot_every_draws_curves_on_step_loops(tmp_path, name, drawn):
    flags, n, steps = RUNS[name]
    _train(flags, n, steps, tmp_path, "--max-chunks", "2", "--plot-every", "1")
    assert (tmp_path / "curves.png").exists() == drawn


def test_sigkill_and_resume(tmp_path):
    """A K5 run killed between checkpoints resumes from its newest step."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out, n, steps = str(tmp_path / "run"), 128, 2
    common = [sys.executable, "-m", "merging_gym_tpu_torch.cli", "--cpu",
              "train", "--algo", "dqn", "--fused-kernel", "--num-envs",
              str(n), "--chunk-steps", str(steps), "--memory-capacity", "256",
              "--episodes", BIG, "--checkpoint-every", "1"]
    proc = subprocess.Popen(common + ["--max-chunks", "10000", "--out", out],
                            env=env, cwd=REPO, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    mgr = CheckpointManager(os.path.join(out, "ckpt"))
    deadline = time.time() + 30
    while len(mgr.all_steps()) < 2:
        if proc.poll() is not None:
            pytest.fail(f"trainer exited early: {proc.stderr.read()[-2000:]}")
        if time.time() > deadline:
            proc.kill()
            pytest.fail("no checkpoints within 30 s")
        time.sleep(0.2)
    os.kill(proc.pid, signal.SIGKILL)
    proc.wait()
    proc.stderr.close()
    latest = mgr.latest_step()

    out2 = str(tmp_path / "run2")
    r = subprocess.run(common + ["--max-chunks", "2", "--resume", out,
                                 "--out", out2], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr[-2000:]
    # Step i is saved after chunk i: (i + 1) chunks of env-steps.
    resumed_at = int(r.stdout.split("resumed from")[1].split("at step")[1]
                     .split()[0])
    assert resumed_at == (latest + 1) * steps * n
    assert _rows(out2)[-1]["env_steps"] == resumed_at + 2 * steps * n
