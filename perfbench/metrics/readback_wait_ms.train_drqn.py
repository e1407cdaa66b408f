"""``readback_wait_ms.train``'s reading, for the DRQN cell, where it moves
``train_device_us_per_step``."""

from perfbench.harness import reader

read = reader("readback_wait_ms.train").read
