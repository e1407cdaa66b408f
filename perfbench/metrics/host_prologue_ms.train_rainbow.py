"""``host_prologue_ms.train``'s reading, for the Rainbow cell, where it
moves ``train_device_us_per_step``."""

from perfbench.harness import reader

read = reader("host_prologue_ms.train").read
