"""Class-based envs: the reference-API ``MergeEnv``, the gymnasium env and
its registration, and the gymnasium vector env over the native core."""
