"""The benchmark's own files: names, units and keys of ``BENCHMARK.json``,
each cell's files found by name, the frozen counts, the import rules, and
a run without a card.  CPU only; run them with

    python -m pytest -o addopts="" -p no:cacheprovider perfbench/tests
"""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.reference import counts

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "merging_gym_tpu"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def one_line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_names():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in metrics()]
    for group in (names, [c["name"] for c in BENCH["configs"]],
                  [w["name"] for w in BENCH["workloads"]]):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group), group
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and one_line(w["why"])
    for m in metrics():
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and one_line(m["layer"])


def test_every_cell_reports_what_it_must():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(BENCH, w["name"], 0)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.cell_metrics(BENCH, w["name"], 1)
        assert layer and all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(workload):
    w, config, traffic = harness.cell_spec(BENCH, workload)
    assert config["name"] == w["config"]
    assert os.path.exists(os.path.join(
        harness.BENCH_DIR, "paths", f"{traffic['path']}.py"))
    assert set(traffic["limits"]) and "why" in traffic
    for m in harness.cell_metrics(BENCH, workload, 0) + \
            harness.cell_metrics(BENCH, workload, 1):
        assert hasattr(harness.reader(m["name"]), "read"), m["name"]
    for c in BENCH["configs"]:
        assert c["file"] == f"perfbench/configs/{c['name']}.json"


def test_frozen_counts_reproduce_the_step_bounds():
    """A warm step at 1,024 envs against L0: K5 0.004067 ms (272.5 MFLOP)
    and K8 0.004780 ms (320.3 MFLOP), both bound by operations; K6 at
    4,096 x 2,600 14.51 ms."""
    ms, by = counts.bound(counts.dqn_step_bytes(1024, 1024),
                          counts.dqn_step_flops(1024, 1024))
    assert by == "operations" and round(ms, 6) == 0.004067
    assert round(counts.dqn_step_flops(1024, 1024) / 1e6, 1) == 272.5
    ms, by = counts.bound(counts.rainbow_step_bytes(1024, 1024),
                          counts.rainbow_step_flops(1024, 1024))
    assert by == "operations" and round(ms, 6) == 0.004780
    assert round(counts.rainbow_step_flops(1024, 1024) / 1e6, 1) == 320.3
    ms, _ = counts.bound(counts.policy_bytes(4096, 2600),
                         counts.policy_flops(4096, 2600))
    assert round(ms, 2) == 14.51


def imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def sources():
    for d, _, files in os.walk(harness.BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    """Top-level names compared whole: ``merging_gym_tpu_torch`` is the
    port, ``merging_gym_tpu`` the JAX package; the old ``benchmarks/``
    folder is not read either."""
    for path in sources():
        tops = {m.split(".")[0] for m in imports(path)}
        assert not tops & (FORBIDDEN | {"benchmarks"}), (path, tops)
        if os.sep + "reference" + os.sep in path:
            assert "merging_gym_tpu_torch" not in tops, path


def test_a_run_without_a_card_fails():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "dqn_train_l0",
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    """On the card: one short run of the first cell prints a correct
    result line (the harness end to end, the build included)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "dqn_train_l0",
         "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
