"""The port's CLI on the CPU, its refusal to fall back without a card, and
import hygiene: neither the port nor chip_smoke.py imports JAX or the JAX
package.  The ``params.npz`` that ``train`` writes loads in the JAX
package and in the port's ``eval``."""

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "merging_gym_tpu_torch")
ZOO = os.path.join(REPO, "model_zoo")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "merging_gym_tpu")


def _run(args, timeout=300):
    # One torch thread per CLI process: the tests run several at once.
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=REPO)


def _result(stdout):
    return json.loads(stdout[stdout.index("{"):])


def test_eval_cpu_on_zoo_nets():
    r = _run(["-m", "merging_gym_tpu_torch.cli", "--cpu", "eval",
              "--p1", os.path.join(ZOO, "L2", "params.npz"),
              "--p2", os.path.join(ZOO, "L1", "params.npz"),
              "--num-envs", "64", "--episodes", "64", "--seed", "1"])
    assert r.returncode == 0, r.stderr[-2000:]
    res = _result(r.stdout)
    assert res["episodes"] >= 64
    for k in ("p1_first_rate", "p2_first_rate", "collision_rate",
              "timeout_rate"):
        assert 0.0 <= res[k] <= 1.0


def test_eval_cpu_fused_against_l0():
    r = _run(["-m", "merging_gym_tpu_torch.cli", "--cpu", "eval", "--fused",
              "--p1", os.path.join(ZOO, "L1", "params.npz"), "--p2", "l0",
              "--num-envs", "8", "--max-steps", "300"])
    assert r.returncode == 0, r.stderr[-2000:]
    res = _result(r.stdout)
    # 128 envs (the fused minimum) x 2,600 steps, capped at 300 per episode.
    assert res["episodes"] >= 128 * (2600 // 300)
    # Every learned level yields to L0 (model_zoo/README.md).
    assert res["p2_first_rate"] > 0.5


def test_eval_const_policies_and_bad_spec():
    r = _run(["-m", "merging_gym_tpu_torch.cli", "--cpu", "eval",
              "--p1", "const:4", "--p2", "const:1", "--episodes", "16",
              "--num-envs", "16"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert _result(r.stdout)["p1_first_rate"] > 0.9
    r = _run(["-m", "merging_gym_tpu_torch.cli", "--cpu", "eval",
              "--p1", "no_such_file.npz"], timeout=120)
    assert r.returncode != 0 and "cannot load" in r.stderr


def _load_in_jax(path):
    import jax
    from merging_gym_tpu.io.checkpoint import load_params_npz as jax_load
    from merging_gym_tpu.nn.mlp import qnet_init as jax_qnet_init
    return jax_load(path, jax_qnet_init(jax.random.key(0), 10, 5))


@pytest.mark.parametrize("trainer", [["--fused-kernel", "--greedy-actor"],
                                     []], ids=["fused", "step_loop"])
def test_train_writes_params_that_both_packages_load(tmp_path, trainer):
    out = tmp_path / "run"
    r = _run(["-m", "merging_gym_tpu_torch.cli", "--cpu", "train", "--algo",
              "dqn", *trainer, "--num-envs", "128", "--chunk-steps", "10",
              "--max-chunks", "2", "--memory-capacity", "512",
              "--out", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [json.loads(ln) for ln in
             (out / "scalars.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines] == [0, 1]
    assert lines[-1]["env_steps"] == 128 * 20 and lines[-1]["learns"] > 0
    params = _load_in_jax(str(out / "params.npz"))
    assert params["fc0"]["w"].shape == (10, 200)
    import numpy as np
    assert all(np.isfinite(np.asarray(v)).all()
               for layer in params.values() for v in layer.values())
    r = _run(["-m", "merging_gym_tpu_torch.cli", "--cpu", "eval",
              "--p1", str(out / "params.npz"), "--p2", "l0",
              "--num-envs", "16", "--episodes", "16", "--max-steps", "100"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert _result(r.stdout)["episodes"] >= 16


def test_levelk_chains_two_levels(tmp_path):
    r = _run(["-m", "merging_gym_tpu_torch.cli", "--cpu", "levelk",
              "--algo", "dqn", "--levels", "2", "--fused-kernel",
              "--greedy-actor", "--num-envs", "128", "--chunk-steps", "8",
              "--max-chunks", "1", "--out", str(tmp_path)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "training L2 vs " + str(tmp_path / "L1" / "params.npz") in r.stdout
    for level in ("L1", "L2"):
        _load_in_jax(str(tmp_path / level / "params.npz"))


def _load_hdqn_in_jax(path):
    """The template of the JAX CLI's ``_load_frozen_hdqn``
    (merging_gym_tpu/cli.py:144-150)."""
    import jax
    from merging_gym_tpu.io.checkpoint import load_params_npz as jax_load
    from merging_gym_tpu.nn.mlp import qnet_init as jax_qnet_init
    like = {"lower": jax_qnet_init(jax.random.key(0), 11, 5),
            "upper": jax_qnet_init(jax.random.key(0), 10, 3)}
    return jax_load(path, like)


def _check_hdqn_params(path):
    import numpy as np
    from merging_gym_tpu_torch.io.checkpoint import load_params_npz
    for nets in (_load_hdqn_in_jax(path), load_params_npz(path)):
        assert np.asarray(nets["upper"]["fc2"]["w"]).shape == (100, 3)
        assert np.asarray(nets["lower"]["fc0"]["w"]).shape == (11, 200)
        assert all(np.isfinite(np.asarray(v)).all() for net in nets.values()
                   for layer in net.values() for v in layer.values())


@pytest.mark.parametrize("trainer,n,scalar", [
    (["--fused-kernel", "--greedy-actor"], 128, "lower_learns"),
    ([], 16, "meta_loss")], ids=["fused", "step_loop"])
def test_train_hdqn_writes_params_that_both_packages_load(tmp_path, trainer,
                                                          n, scalar):
    out = tmp_path / "run"
    r = _run(["-m", "merging_gym_tpu_torch.cli", "--cpu", "train", "--algo",
              "hdqn", *trainer, "--num-envs", str(n), "--chunk-steps", "10",
              "--max-chunks", "2", "--out", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [json.loads(ln) for ln in
             (out / "scalars.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines] == [0, 1]
    assert lines[-1]["env_steps"] == n * 20 and scalar in lines[-1]
    if trainer:  # R_lo = 4 rounds: the lower learner fires from step 3 on
        assert lines[-1]["lower_learns"] == 17
    _check_hdqn_params(str(out / "params.npz"))


def test_levelk_hdqn_chains_two_levels(tmp_path):
    r = _run(["-m", "merging_gym_tpu_torch.cli", "--cpu", "levelk",
              "--algo", "hdqn", "--levels", "2", "--fused-kernel",
              "--greedy-actor", "--num-envs", "128", "--chunk-steps", "4",
              "--max-chunks", "1", "--out", str(tmp_path)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "training L2 vs " + str(tmp_path / "L1" / "params.npz") in r.stdout
    for level in ("L1", "L2"):
        _check_hdqn_params(str(tmp_path / level / "params.npz"))


@pytest.mark.parametrize("flags,message", [
    (["--hidden", "64", "32"], "--hidden"),
    (["--opponent", "not_params.txt"], "cannot load"),
    (["--opponent", "."], "cannot load"),
    (["--learn-rounds", "2", "--fused-kernel"], "--learn-rounds")],
    ids=["hidden", "non_npz_opponent", "pth_run_dir", "learn_rounds"])
def test_hdqn_refusals(tmp_path, flags, message):
    r = _run(["-m", "merging_gym_tpu_torch.cli", "--cpu", "train", "--algo",
              "hdqn", *flags, "--num-envs", "128", "--max-chunks", "1",
              "--out", str(tmp_path / "run")], timeout=120)
    assert r.returncode != 0 and message in r.stderr
    assert not (tmp_path / "run").exists()


def _load_rainbow_in_jax(path):
    import jax
    from merging_gym_tpu.io.checkpoint import load_params_npz as jax_load
    from merging_gym_tpu.nn.rainbow_net import rainbow_init
    return jax_load(path, rainbow_init(jax.random.key(0), 10, 5))


@pytest.mark.parametrize("trainer", [
    ["--fused-kernel", "--greedy-actor"],
    ["--fused-kernel", "--greedy-actor", "--per", "--n-step", "3",
     "--obs-scale", "0.01", "--batch-size", "16", "--opponent",
     os.path.join(ZOO, "L1", "params.npz")],
    ["--batch-size", "16"]], ids=["fused", "fused_per_nstep_frozen",
                                  "step_loop"])
def test_train_rainbow_writes_params_that_both_packages_load(tmp_path,
                                                             trainer):
    import numpy as np
    from merging_gym_tpu_torch.io.checkpoint import load_params_npz

    out = tmp_path / "run"
    r = _run(["-m", "merging_gym_tpu_torch.cli", "--cpu", "train", "--algo",
              "rainbow", *trainer, "--num-envs", "128", "--chunk-steps", "4",
              "--max-chunks", "2", "--memory-capacity", "512",
              "--out", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [json.loads(ln) for ln in
             (out / "scalars.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines] == [0, 1]
    n_step = 3 if "--n-step" in trainer else 1
    # K8 learns from step n_step on; the step loop once 16 are stored.
    assert lines[-1]["env_steps"] == 128 * 8
    assert lines[-1]["learns"] == (8 - n_step if "--fused-kernel" in trainer
                                   else 8)
    path = str(out / "params.npz")
    for params in (_load_rainbow_in_jax(path), load_params_npz(path)):
        assert np.asarray(params["noisy_advantage2"]["w_mu"]).shape == (64,
                                                                       255)
        assert all(np.isfinite(np.asarray(v)).all()
                   for layer in params.values() for v in layer.values())


@pytest.mark.parametrize("cmd,flags,message", [
    ("train", ["--hidden", "64", "32"], "--hidden"),
    ("train", ["--learn-rounds", "2", "--fused-kernel"], "--learn-rounds"),
    ("train", ["--opponent", "."], "cannot load"),
    ("levelk", [], "levelk supports --algo dqn or hdqn")],
    ids=["hidden", "learn_rounds", "pth_run_dir", "levelk"])
def test_rainbow_refusals(tmp_path, cmd, flags, message):
    r = _run(["-m", "merging_gym_tpu_torch.cli", "--cpu", cmd, "--algo",
              "rainbow", *flags, "--num-envs", "128", "--max-chunks", "1",
              "--out", str(tmp_path / "run")], timeout=120)
    assert r.returncode != 0 and message in r.stderr
    assert not (tmp_path / "run").exists()


def _check_drqn_params(path):
    """The params.npz of a drqn run loads in both packages (the template
    of the JAX CLI's ``_load_frozen_drqn``, merging_gym_tpu/cli.py:
    157-167)."""
    import jax
    import numpy as np
    from merging_gym_tpu.io.checkpoint import load_params_npz as jax_load
    from merging_gym_tpu.nn.lstm import drqn_init as jax_drqn_init
    from merging_gym_tpu_torch.io.checkpoint import load_params_npz
    for net in (jax_load(path, jax_drqn_init(jax.random.key(0), 10, 5)),
                load_params_npz(path)):
        assert np.asarray(net["lstm"]["w_hh"]).shape == (16, 64)
        assert np.asarray(net["fc1"]["w"]).shape == (10, 200)
        assert all(np.isfinite(np.asarray(v)).all()
                   for layer in net.values() for v in layer.values())


@pytest.mark.parametrize("trainer,n,learns", [
    (["--fused-kernel", "--greedy-actor", "--memory-capacity", "256"], 128,
     40 - 31),
    (["--opponent", "selfplay"], 16, 40 - 31)], ids=["fused", "step_loop"])
def test_train_drqn_writes_params_that_both_packages_load(tmp_path, trainer,
                                                          n, learns):
    # K9 with R = 2 rounds of 16-step windows learns from global step 31;
    # the step loop once 32 windows (batch 32) are stored, after step 32.
    out = tmp_path / "run"
    r = _run(["-m", "merging_gym_tpu_torch.cli", "--cpu", "train", "--algo",
              "drqn", *trainer, "--num-envs", str(n), "--chunk-steps", "20",
              "--max-chunks", "2", "--out", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [json.loads(ln) for ln in
             (out / "scalars.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines] == [0, 1]
    assert lines[-1]["env_steps"] == n * 40
    assert lines[-1]["learns"] == learns and lines[-1]["loss"] > 0.0
    _check_drqn_params(str(out / "params.npz"))


def test_train_drqn_against_a_frozen_drqn(tmp_path):
    first, second = tmp_path / "first", tmp_path / "second"
    base = ["-m", "merging_gym_tpu_torch.cli", "--cpu", "train", "--algo",
            "drqn", "--fused-kernel", "--greedy-actor", "--num-envs", "128",
            "--memory-capacity", "256", "--chunk-steps", "8",
            "--max-chunks", "1"]
    r = _run([*base, "--out", str(first)])
    assert r.returncode == 0, r.stderr[-2000:]
    r = _run([*base, "--opponent", str(first / "params.npz"), "--out",
              str(second)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads((second / "scalars.jsonl").read_text())[
        "env_steps"] == 128 * 8
    _check_drqn_params(str(second / "params.npz"))


@pytest.mark.parametrize("cmd,flags,message", [
    ("train", ["--hidden", "64", "32"], "--hidden/--compute-dtype"),
    ("train", ["--compute-dtype", "bfloat16"], "--hidden/--compute-dtype"),
    ("train", ["--learn-rounds", "2", "--fused-kernel"], "--learn-rounds"),
    ("train", ["--random-start", "--greedy-actor", "--fused-kernel"],
     "--greedy-actor"),
    ("train", ["--opponent", "not_params.txt"], "cannot load frozen drqn"),
    ("train", ["--opponent", os.path.join(ZOO, "L1", "params.npz")],
     "not the net of a drqn run"),
    ("levelk", [], "levelk supports --algo dqn or hdqn")],
    ids=["hidden", "compute_dtype", "learn_rounds", "random_start_greedy",
         "non_npz_opponent", "qnet_opponent", "levelk"])
def test_drqn_refusals(tmp_path, cmd, flags, message):
    r = _run(["-m", "merging_gym_tpu_torch.cli", "--cpu", cmd, "--algo",
              "drqn", *flags, "--num-envs", "128", "--max-chunks", "1",
              "--out", str(tmp_path / "run")], timeout=120)
    assert r.returncode != 0 and message in r.stderr
    assert not (tmp_path / "run").exists()


def test_no_silent_cpu_fallback():
    # Without a card and without --cpu the CLI must fail, and
    # chip_smoke.py must fail without printing a result.
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run(["-m", "merging_gym_tpu_torch.cli", "eval", "--p1", "const:4",
              "--episodes", "4", "--num-envs", "4"], timeout=120)
    assert r.returncode != 0 and "CUDA is not available" in r.stderr
    r = _run([os.path.join(REPO, "chip_smoke.py")], timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def _python_files():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_python_files()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_import_leaves_jax_out():
    code = ("import sys, pkgutil, importlib, merging_gym_tpu_torch as m\n"
            "for i in pkgutil.walk_packages(m.__path__, m.__name__ + '.'):\n"
            "    importlib.import_module(i.name)\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    r = _run(["-c", code], timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
