"""``train_env_steps_per_s``'s reading, for the device-paced training cell:
its spread is a tenth of the host-paced cells', so it carries a bound of
its own."""

from perfbench.harness import reader

read = reader("train_env_steps_per_s").read
