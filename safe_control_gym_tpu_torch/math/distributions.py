"""The PPO actor's distributions: a diagonal Gaussian and a Categorical.

Port of ``Normal`` and ``Categorical`` of
``safe_control_gym_tpu/math/distributions.py``. ``Normal`` sums log-prob and
entropy over the last dim and its ``mode()`` is the mean. ``Categorical`` is
over logits; its ``log_prob`` takes ``(...,)`` or ``(..., 1)`` indices and
returns ``(..., 1)``. ``sample`` draws from an explicit ``torch.Generator``
in place of a JAX key.
"""

from __future__ import annotations

import math

import torch

__all__ = ['Normal', 'Categorical']

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


class Categorical:
    """Categorical over logits (the last dim)."""

    def __init__(self, logits):
        self.logits = logits
        self.log_p = torch.log_softmax(logits, dim=-1)

    def sample(self, gen: torch.Generator):
        """Indices (int64, the logits' leading shape) by the Gumbel-max trick."""
        u = torch.rand(self.logits.shape, generator=gen, device=gen.device)
        gumbel = -torch.log(-torch.log(u.to(self.logits.device)))
        return torch.argmax(self.logits + gumbel, dim=-1)

    def log_prob(self, value):
        idx = torch.as_tensor(value, device=self.logits.device).to(torch.int64)
        if idx.dim() != self.logits.dim():
            idx = idx[..., None]
        return torch.gather(self.log_p, -1, idx)

    def entropy(self):
        return -torch.sum(torch.exp(self.log_p) * self.log_p, dim=-1, keepdim=True)

    def mode(self):
        return torch.argmax(self.logits, dim=-1)
