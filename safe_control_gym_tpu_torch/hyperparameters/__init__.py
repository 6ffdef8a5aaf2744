"""Hyperparameter optimization: the study, its storage, the samplers, population PPO and HPO."""
