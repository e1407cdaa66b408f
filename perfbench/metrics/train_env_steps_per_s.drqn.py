"""``train_env_steps_per_s``'s reading, for the DRQN cell: a per-layer
metric of the fused host loop there, beside the cell's end-to-end device
time a step."""

from perfbench.harness import reader

read = reader("train_env_steps_per_s").read
