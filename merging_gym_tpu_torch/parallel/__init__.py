"""Runs over several ranks on ``torch.distributed``: the ``(data,
model)`` mesh (``mesh``), process setup (``multihost``), the SPMD
trainers (``spmd``) and reward sweeps (``sweep``).  Counterpart of
``merging_gym_tpu/parallel/``; importing it starts no process group."""
