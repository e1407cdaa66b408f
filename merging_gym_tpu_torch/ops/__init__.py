"""Kernel wrappers (K1/K2 env rollout, K3 Q-net, K4 actor, K5 DQN trainer,
K6 policy rollout), each beside its plain PyTorch version; the Philox
generator they share; the replay ring of the step-loop trainer."""
