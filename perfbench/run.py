"""Run one cell of the benchmark once, on the card of the machine it runs
on, and print one JSON object as the last line of standard output:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run it from the root of a checkout.  Build and kernel caches stay inside
the checkout: the port builds its CUDA libraries into
``merging_gym_tpu_torch/kernels/_build/``, and any Triton or
``torch.utils.cpp_extension`` cache goes under ``perfbench/.cache/``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["OMP_NUM_THREADS"] = "1"   # one process, few threads: steadier
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != HERE]

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
