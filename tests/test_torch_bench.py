"""The port's ``bench`` command (``merging_gym_tpu_torch/bench.py``, ``cli
bench``) without a card: it fails without CUDA, refuses ``--cpu``, and its
measurement and JSON line work on the CPU at a tiny size.
"""

import ast
import json
import os

import pytest
import torch

from merging_gym_tpu_torch import bench
from tests.test_torch_cli import REPO, _python_files, _run
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_bench_without_a_card_fails_with_the_cuda_message():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run(["-m", "merging_gym_tpu_torch.cli", "bench"], timeout=120)
    assert r.returncode != 0 and "CUDA is not available" in r.stderr
    assert '"metric"' not in r.stdout


def test_bench_refuses_cpu():
    r = _run(["-m", "merging_gym_tpu_torch.cli", "--cpu", "bench"],
             timeout=120)
    assert r.returncode != 0 and "--cpu is refused" in r.stderr
    assert '"metric"' not in r.stdout


def test_measure_on_the_cpu_gives_positive_rates():
    rates = bench.measure(num_envs=8, launch_steps=32, reps=2, device="cpu")
    assert len(rates) == 2 and all(r > 0 for r in rates)


def test_result_line_has_the_jax_keys_and_the_device():
    line = bench.result_line(5.4e9 + 0.04, "NVIDIA H100 80GB HBM3")
    assert list(line) == ["metric", "value", "unit", "vs_baseline", "device"]
    assert line == {"metric": "env_steps_per_sec_1chip_4096envs",
                    "value": 5400000000.0, "unit": "env-steps/s",
                    "vs_baseline": 5400000.0,
                    "device": "NVIDIA H100 80GB HBM3"}
    assert json.loads(json.dumps(line)) == line
    # The JAX package's constants, held in the port's own copy.
    assert (bench.NUM_ENVS, bench.REPS, bench.REFERENCE_STEPS_PER_SEC,
            bench.LAUNCH_STEPS) == (4096, 5, 1e3, 1 << 20)


def test_bench_module_is_walked_and_imports_no_root_bench():
    path = os.path.join(REPO, "merging_gym_tpu_torch", "bench.py")
    assert path in set(_python_files())  # test_no_jax_imports covers it
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert "bench" not in names
    assert all(not m.startswith("merging_gym_tpu.") for m in names if m)
