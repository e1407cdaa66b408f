"""Param files, checkpoints, metrics, reference .pth import and training
curves."""
