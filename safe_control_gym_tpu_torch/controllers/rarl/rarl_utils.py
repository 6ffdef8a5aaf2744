"""RARL/RAP helpers: observations grouped by their assigned adversary.

Port of ``safe_control_gym_tpu/controllers/rarl/rarl_utils.py``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ['split_obs_by_adversary']


def split_obs_by_adversary(obs, assignment, num_adversaries):
    """The rows of ``obs`` assigned to each adversary index, in order: a list
    of ``num_adversaries`` arrays (tensors in, tensors out)."""
    if torch.is_tensor(obs):
        assignment = torch.as_tensor(assignment, device=obs.device)
        return [obs[assignment == i] for i in range(num_adversaries)]
    obs, assignment = np.asarray(obs), np.asarray(assignment)
    return [obs[assignment == i] for i in range(num_adversaries)]
