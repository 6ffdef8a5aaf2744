"""Exploration noise: i.i.d. Gaussian and Ornstein-Uhlenbeck processes.

Port of ``safe_control_gym_tpu/math/random_processes.py``. The functional
form is ``ou_init(shape)`` and ``ou_sample(state, gen, std) -> (noise,
state')``; ``gaussian_sample(gen, shape, std)``. Each draw comes from an
explicit ``torch.Generator``, or from ``normals``, standard normals drawn
beforehand (a test feeds the JAX package's draws this way). The classes keep
the reference's ``sample()`` / ``reset_states()`` API over a generator of
their own.

    state = ou_init((8, 1), device='cuda')
    noise, state = ou_sample(state, gen, std=0.2)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from safe_control_gym_tpu_torch.math.schedules import ConstantSchedule, LinearSchedule  # noqa: F401
from safe_control_gym_tpu_torch.utils.device import resolve_device

__all__ = ['GaussianProcess', 'OrnsteinUhlenbeckProcess', 'ou_init', 'ou_sample',
           'gaussian_sample']


def _normals(gen, shape, normals, device):
    if normals is not None:
        return torch.tensor(np.asarray(normals, np.float32), device=device).reshape(shape)
    return torch.randn(shape, generator=gen, device=gen.device).to(device)


def gaussian_sample(gen, shape, std, normals=None):
    """``std`` times a standard normal draw of ``shape``."""
    device = gen.device if gen is not None else 'cpu'
    return _normals(gen, tuple(shape), normals, device) * std


def ou_init(shape, device='cpu'):
    return torch.zeros(shape, device=resolve_device(device))


def ou_sample(state, gen, std, theta=0.15, dt=1e-2, mu=0.0, normals=None):
    """One Ornstein-Uhlenbeck step; returns ``(noise, noise)``, the new state
    being the noise."""
    w = _normals(gen, state.shape, normals, state.device)
    noise = state + theta * (mu - state) * dt + std * math.sqrt(dt) * w
    return noise, noise


class GaussianProcess:
    """i.i.d. Gaussian noise of ``size`` with a scheduled std."""

    def __init__(self, size, std, seed=0, device='cpu'):
        self.size = size
        self.std = std
        self.gen = torch.Generator(device=resolve_device(device)).manual_seed(int(seed))

    def sample(self, normals=None):
        return gaussian_sample(self.gen, (self.size,), self.std(), normals).cpu().numpy()

    def reset_states(self):
        pass


class OrnsteinUhlenbeckProcess:
    """Temporally correlated noise of ``size`` for DDPG's exploration."""

    def __init__(self, size, std, theta=0.15, dt=1e-2, x0=None, seed=0, device='cpu'):
        self.size = size
        self.std = std
        self.theta = theta
        self.dt = dt
        self.x0 = x0
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.reset_states()

    def sample(self, normals=None):
        noise, self.x_prev = ou_sample(self.x_prev, self.gen, self.std(), theta=self.theta,
                                       dt=self.dt, normals=normals)
        return noise.cpu().numpy()

    def reset_states(self):
        self.x_prev = (torch.as_tensor(self.x0, dtype=torch.float32, device=self.device)
                       if self.x0 is not None else ou_init((self.size,), self.device))
