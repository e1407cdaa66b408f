"""``train_env_steps_per_s``'s reading, for the host-paced Rainbow cell:
there its runs spread too widely for an end-to-end bound (the host's speed
sets it), so it stands as a per-layer metric of the fused host loop."""

from perfbench.harness import reader

read = reader("train_env_steps_per_s").read
