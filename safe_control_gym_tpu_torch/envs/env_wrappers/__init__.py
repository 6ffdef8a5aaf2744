"""Env wrappers of the port: the vectorized envs and the episode statistics."""
