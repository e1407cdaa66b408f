"""``launches_per_step.train``'s reading, for the device-paced training cell, where it
moves ``train_env_steps_per_s.wide``."""

from perfbench.harness import reader

read = reader("launches_per_step.train").read
