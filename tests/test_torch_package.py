"""The port's package surface against the JAX package's.

``merging_gym_tpu_torch`` re-exports every name of
``merging_gym_tpu.__all__`` that the port has, from the same modules as
JAX's (``core.constants``, ``core.env``, ``core.vector``), and importing
it builds no kernel and leaves CUDA untouched.
"""

import os
import subprocess
import sys

import pytest

import merging_gym_tpu
import merging_gym_tpu_torch
from merging_gym_tpu_torch.core import constants, env, vector

# Names of merging_gym_tpu.__all__ whose modules are not ported yet
# (OracleMergeEnv: core/oracle.py, ROADMAP Queue 1, M16).
UNPORTED = {"OracleMergeEnv"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_all_covers_the_jax_package_less_the_unported():
    ported = set(merging_gym_tpu.__all__) - UNPORTED
    assert UNPORTED <= set(merging_gym_tpu.__all__)
    assert set(merging_gym_tpu_torch.__all__) == ported
    assert len(merging_gym_tpu_torch.__all__) == len(ported)


@pytest.mark.parametrize("name", sorted(set(merging_gym_tpu.__all__)
                                        - UNPORTED))
def test_export_is_the_core_module_object(name):
    home = {"constants": None}.get(name, env if hasattr(env, name)
                                   else vector)
    want = constants if home is None else getattr(home, name)
    assert getattr(merging_gym_tpu_torch, name) is want
    assert callable(want) == callable(getattr(merging_gym_tpu, name))


def test_import_builds_no_kernel_and_leaves_cuda_alone():
    code = ("import sys, torch, merging_gym_tpu_torch as m; "
            "k = sys.modules.get('merging_gym_tpu_torch.kernels'); "
            "print(torch.cuda.is_initialized(), "
            "k is not None and bool(k._libs), 'jax' in sys.modules, "
            "len(m.__all__))")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120, check=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"}).stdout.split()
    assert out == ["False", "False", "False",
                   str(len(merging_gym_tpu_torch.__all__))]
