"""``host_transfers_per_chunk.train``'s reading, for the Rainbow cell, where it
moves ``train_device_us_per_step``."""

from perfbench.harness import reader

read = reader("host_transfers_per_chunk.train").read
