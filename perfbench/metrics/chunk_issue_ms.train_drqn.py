"""``chunk_issue_ms.train``'s reading, for the DRQN cell, where it moves
``train_device_us_per_step``."""

from perfbench.harness import reader

read = reader("chunk_issue_ms.train").read
