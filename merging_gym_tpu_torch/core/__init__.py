"""Env core: constants, geometry, control law, env step, vectorised rollout."""
