"""The port's CLI on the CPU, its refusal to fall back without a card, and
import hygiene: neither the port nor chip_smoke.py imports JAX or the JAX
package."""

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
    env = dict(os.environ)
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
