"""Kernel wrappers (K1/K2 env rollout, K3 Q-net, K6 policy rollout), each
beside its plain PyTorch version, and the Philox generator they share."""
