"""Q-network parameters and forward."""
