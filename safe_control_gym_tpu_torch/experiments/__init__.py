"""Experiment harness of the port: so far the open-loop rollout benchmark."""
