"""The diagonal Gaussian of the PPO actor.

Port of ``Normal`` of ``safe_control_gym_tpu/math/distributions.py``: log-prob
and entropy summed over the last dim, ``mode()`` the mean, and ``sample`` from
an explicit ``torch.Generator`` in place of a JAX key. ``Categorical`` comes
with PPO training (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import math

import torch

__all__ = ['Normal']

_LOG_2PI = math.log(2.0 * math.pi)


class Normal:
    """Diagonal Gaussian; ``log_prob`` and ``entropy`` summed over the last dim."""

    def __init__(self, loc, scale):
        self.loc = loc
        self.scale = scale

    def sample(self, gen: torch.Generator, shape=()):
        shape = tuple(shape) + tuple(self.loc.shape)
        noise = torch.randn(shape, generator=gen, device=gen.device).to(self.loc.device)
        return self.loc + self.scale * noise

    def log_prob(self, value):
        var = self.scale ** 2
        lp = -((value - self.loc) ** 2) / (2 * var) - torch.log(self.scale) - 0.5 * _LOG_2PI
        return torch.sum(lp, dim=-1, keepdim=True)

    def entropy(self):
        ent = 0.5 + 0.5 * _LOG_2PI + torch.log(torch.as_tensor(self.scale))
        return torch.sum(torch.broadcast_to(ent, self.loc.shape), dim=-1, keepdim=True)

    def mode(self):
        return self.loc
