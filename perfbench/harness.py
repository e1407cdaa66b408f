"""The benchmark's general harness: one run of one cell.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a configuration
(``configs/<config>.json``) under a traffic mix (``traffic/<traffic>.json``).
The traffic file names the module of the entry point it exercises
(``paths/<path>.py``), and every metric is read by a reader of its own
(``metrics/<name>.py``).  Nothing here knows a cell, a path or a metric by
name: a later change adds one by adding files and entries.

A run: set-up (the cell builds the program's state from the seed and
drives it through its first steps), a measured window of ``--seconds`` in
which the cell's call runs back to back, with ``--trace 1`` a profiled
sub-window after it (without it too, where an end-to-end metric of the
cell is read from the device's trace), then the program's state is freed
and the cell compares what the program produced with the plain reference
under ``reference/``.  The last line of standard output is one JSON object.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "merging_gym_tpu")
MAX_FAILURES = 10   # a window that keeps raising ends after this many


class Window:
    """What the measured window did: per call its host time and its work
    units (env-steps), the calls that raised, its length, and the
    program's launch counters over it."""

    def __init__(self):
        self.ms: list = []
        self.units = 0
        self.attempted = 0
        self.failed = 0
        self.seconds = 0.0
        self.launches: dict = {}


class Run:
    """Everything a metric reader may read: the cell, the set-up
    time, the window and, in a traced run, the trace."""

    def __init__(self, cell, setup_s, window, trace):
        self.cell = cell
        self.setup_s = setup_s
        self.window = window
        self.trace = trace


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(bench: dict, workload: str):
    """``(workload entry, config, traffic)`` of a cell, found by name."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            config = load_json(BENCH_DIR, "configs", f"{w['config']}.json")
            traffic = load_json(BENCH_DIR, "traffic", f"{w['traffic']}.json")
            return w, config, traffic
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` reports: its end-to-end metrics,
    or with ``trace`` its per-layer ones (those that list it, or, without
    a list, those whose ``moves`` metric it reports)."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader(name: str):
    """The reader module ``metrics/<name>.py`` (names may hold dots)."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def launch_counts() -> dict:
    from merging_gym_tpu_torch import kernels
    return dict(kernels.launch_counts)


def run_window(cell, seconds: float) -> Window:
    """Call the cell back to back until ``seconds`` have passed; the
    window ends at a synchronize after the last call."""
    import torch

    w = Window()
    sync = cell.device.type == "cuda"
    if sync:
        torch.cuda.synchronize()
    before = launch_counts()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds and w.failed < MAX_FAILURES:
        w.attempted += 1
        t = time.perf_counter()
        try:
            units = cell.call()
        except Exception:   # a call that raises counts as failed
            w.failed += 1
            traceback.print_exc(file=sys.stderr)
            continue
        w.ms.append(1e3 * (time.perf_counter() - t))
        w.units += units
    if sync:
        torch.cuda.synchronize()
    w.seconds = time.perf_counter() - t0
    after = launch_counts()
    w.launches = {k: after[k] - before.get(k, 0) for k in after
                  if after[k] != before.get(k, 0)}
    return w


def compare(numbers: dict, limits: dict) -> tuple:
    """``(correct, rows)``: every number compared at or under its limit;
    a number without a limit, a limit without a number, or a number that
    is not finite fails."""
    rows, ok = {}, True
    for name in sorted(set(numbers) | set(limits)):
        value, limit = numbers.get(name), limits.get(name)
        good = (value is not None and limit is not None
                and math.isfinite(value) and value <= limit)
        ok = ok and good
        rows[name] = {"value": finite_or_none(value), "limit": limit}
    return ok, rows


def finite_or_none(x):
    """JSON has no NaN: a number that is not finite is written as null."""
    return x if x is not None and math.isfinite(x) else None


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, traffic_overrides=None,
             control=None) -> dict:
    """One run of a cell on ``device``; returns the result object."""
    import torch

    w, config, traffic = cell_spec(bench, workload)
    traffic = {**traffic, **(traffic_overrides or {})}
    path = importlib.import_module(f"perfbench.paths.{traffic['path']}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    cell = path.Cell(config, traffic, seed, device, control=control)
    gc.collect()   # every window starts from the same collector state
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    window = run_window(cell, seconds)
    trace_data = None
    if trace or profiled(cell_metrics(bench, workload, False)):
        from perfbench import trace as tr
        trace_data = tr.profile(cell, int(traffic["trace_calls"]), device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    run = Run(cell, setup_s, window, trace_data)
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        value = finite_or_none(reader(m["name"]).read(run))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cell.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    correct, rows = compare(cell.check(), traffic["limits"])
    print(json.dumps({"phase_s": {
        "setup": setup_s, "window": window.seconds,
        "trace": trace_data.wall_s if trace_data else 0.0,
        "check": time.perf_counter() - t_check},
        "window_ms": spread(window.ms)}), file=sys.stderr)
    correct = correct and window.failed == 0 and window.attempted > 0
    result = {"correct": correct, "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics,
              "device": device_info(device, w["chips"], peak,
                                    trace_data if trace else None)}
    if trace:
        result["breakdown"] = trace_data.breakdown()
    result["checks"] = rows
    notes = getattr(cell, "notes", None)
    if notes:
        print(json.dumps({"notes": notes(run)}), file=sys.stderr)
    return result


def profiled(end_to_end) -> bool:
    """Whether an untraced run profiles a sub-window after its window: it
    does where one of its end-to-end metrics is read from the device's
    trace (a traced run always does)."""
    return any(m["source"] == "device_trace" for m in end_to_end)


def spread(ms) -> dict:
    """Count, 10th, 50th and 90th percentiles and maximum of the window's
    call times (printed on standard error beside the result)."""
    if len(ms) < 2:
        return {"n": len(ms)}
    q = statistics.quantiles(ms, n=10, method="inclusive")
    return {"n": len(ms), "p10": q[0], "p50": statistics.median(ms),
            "p90": q[8], "max": max(ms)}


def device_info(device, chips, peak, trace_data) -> dict:
    import torch
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    info = {"platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": kind, "count": chips, "memory_peak_bytes": int(peak)}
    if trace_data is not None:
        info["busy_s"] = trace_data.busy_s
        info["window_s"] = trace_data.window_s
    return info


def card_state() -> str:
    """The card's name, power limit, SM clock and draw (read only)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "power.draw,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv, t_start: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    w, _, _ = cell_spec(bench, args.workload)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < w["chips"]:
        print(f"{args.workload} needs {w['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), device, t_start)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the port "
              "alone", file=sys.stderr)
        return 3
    print(f"card: {card_state()}", file=sys.stderr)
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result, allow_nan=False))
    return 0


def quantile(values, q: float) -> float:
    """The ``q``-th percentile (``statistics.quantiles`` over 100 cuts,
    inclusive method) of at least two values."""
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]
