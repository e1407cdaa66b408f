"""merging_gym_tpu_torch: the PyTorch / CUDA port of merging_gym_tpu.

The two-player on-ramp merging simulator, its vectorised auto-reset
rollouts, the reference Q-net, Double-DQN, h-DQN, Rainbow (noisy dueling
C51 with PER and n-step returns) and DRQN training (for each a step-loop
trainer and a single-kernel trainer; level-k curricula for Double-DQN and
h-DQN) and the head-to-head evaluation of learned policies, their
checkpoints and runs over several ranks, the human experiment harness
(``play``), the float64 oracle and native C++ core, the gymnasium envs,
trajectory logs and their analysis, on PyTorch with hand-written CUDA
kernels for the NVIDIA H100 (``kernels/csrc``).  It imports nothing of
JAX or of the JAX package, which stays in the repository as the
reference the tests hold it to.  Entry points run on ``cuda`` unless the
caller asks for the CPU; importing the package builds no kernel, does
not touch CUDA and imports neither pygame, gymnasium nor matplotlib.
"""

__version__ = "0.1.0"

from merging_gym_tpu_torch.core import constants
from merging_gym_tpu_torch.core.env import (EnvParams, EnvState, TimeStep,
                                            observe, reset, step, swap_obs)
from merging_gym_tpu_torch.core.oracle import OracleMergeEnv
from merging_gym_tpu_torch.core.vector import (autoreset_step, reset_batch,
                                               rollout, step_batch)

__all__ = [
    "constants",
    "EnvParams",
    "EnvState",
    "TimeStep",
    "observe",
    "reset",
    "step",
    "swap_obs",
    "OracleMergeEnv",
    "autoreset_step",
    "reset_batch",
    "rollout",
    "step_batch",
]
