"""merging_gym_tpu_torch: the PyTorch / CUDA port of merging_gym_tpu.

The two-player on-ramp merging simulator, its vectorised auto-reset
rollouts, the reference Q-net and the head-to-head evaluation of learned
policies, on PyTorch with hand-written CUDA kernels for the NVIDIA H100
(``kernels/csrc``).  It imports nothing of JAX or of the JAX package,
which stays in the repository as the reference the tests hold it to.
Entry points run on ``cuda`` unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
