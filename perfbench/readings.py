"""The readings that a cell's limits are set from: the numbers that decide
``correct``, for the program and for its control or a planted fault, on
many seeds in one process (set-up builds the kernels once), without the
measured window (a serving cell's calls run as many times as a run checks).

    python3 perfbench/readings.py --workload <name> --seeds 1,2,3 \\
        [--controls none,bfloat16,fault:half_batch,fault:altered_action] \\
        [--out readings.jsonl]

One JSON line per (control, seed) on standard output (and appended to
``--out``): the numbers, the set-up's and the check's seconds.  Needs the
card, as a run does; ``--cpu`` with ``--tiny`` runs it on the CPU at a
test's size.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
os.environ["OMP_NUM_THREADS"] = "1"
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != HERE]

from perfbench import harness  # noqa: E402


def readings(workload, seeds, controls, device, overrides=None, out=None):
    import torch

    bench = harness.load_json(ROOT, "BENCHMARK.json")
    _, config, traffic = harness.cell_spec(bench, workload)
    traffic = {**traffic, **(overrides or {})}
    path = importlib.import_module(f"perfbench.paths.{traffic['path']}")
    rows = []
    for control in controls:
        for seed in seeds:
            t = time.perf_counter()
            cell = path.Cell(config, traffic, seed, device,
                             control=None if control == "none" else control)
            for _ in range(int(traffic.get("checked_matchups", 0))):
                cell.call()
            if device.type == "cuda":
                torch.cuda.synchronize()
            setup_s = time.perf_counter() - t
            cell.release()
            t = time.perf_counter()
            numbers = cell.check()
            row = {"workload": workload, "control": control, "seed": seed,
                   "numbers": numbers, "setup_s": setup_s,
                   "check_s": time.perf_counter() - t}
            if hasattr(cell, "first"):
                row["first_losses"] = cell.first["losses"]
            print(json.dumps(row), flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(json.dumps(row) + "\n")
            rows.append(row)
            del cell
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", default="none,bfloat16")
    p.add_argument("--out", default=None)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--tiny", default=None,
                   help="JSON of traffic keys to override (CPU rehearsal)")
    args = p.parse_args(argv)
    import torch

    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        print("no CUDA device (pass --cpu for a rehearsal)", file=sys.stderr)
        return 2
    readings(args.workload, [int(s) for s in args.seeds.split(",")],
             args.controls.split(","), device,
             json.loads(args.tiny) if args.tiny else None, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
