"""The frozen observation normalizer of a trained PPO policy.

Port of ``NormalizerState`` and ``rms_normalize`` of
``safe_control_gym_tpu/math/normalization.py``. The running updates
(``rms_update`` and the return normalizer) come with PPO training (ROADMAP
Queue 1 item 8).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ['NormalizerState', 'rms_normalize']


@dataclass
class NormalizerState:
    """Running mean, variance and count of the observations."""
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor


def rms_normalize(state: NormalizerState, x, clip=10.0):
    """``clip((x - mean) / sqrt(var + 1e-8), -clip, clip)``."""
    return torch.clamp((x - state.mean) / torch.sqrt(state.var + 1e-8), -clip, clip)
