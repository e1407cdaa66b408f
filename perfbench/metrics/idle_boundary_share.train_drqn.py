"""``idle_boundary_share.train``'s reading, for the DRQN cell, where it
moves ``train_device_us_per_step``."""

from perfbench.harness import reader

read = reader("idle_boundary_share.train").read
