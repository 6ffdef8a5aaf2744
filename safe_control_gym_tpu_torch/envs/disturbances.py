"""Disturbance framework (observation / action / dynamics channels), in PyTorch.

Port of ``safe_control_gym_tpu/envs/disturbances.py``. Each spec works on a
batch of envs:

* ``init(gen, n) -> (n, state_size)`` draws the per-episode parameters (the
  random step offset of impulse/step disturbances);
* ``draw(gen, n) -> (n, noise_size)`` draws one step's randomness for the
  whole batch;
* ``apply_drawn(target, dstate, ctrl_step, t, drawn)`` adds the disturbance
  to a (n, dim) target given those draws; ``ctrl_step`` and ``t`` are (n,);
* ``apply(target, dstate, ctrl_step, t, gen)`` is ``apply_drawn`` on a
  fresh ``draw``: the keyed path of the JAX package, with a
  ``torch.Generator`` in place of a key.

Every supported type is stateless with noise (uniform, white, periodic) or
stateful without noise (impulse, step), as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

__all__ = [
    'DisturbanceSpec', 'ImpulseDisturbance', 'StepDisturbance',
    'UniformNoise', 'WhiteNoise', 'PeriodicNoise', 'BrownianNoise',
    'StateDependentDisturbance', 'DisturbanceList', 'DISTURBANCE_TYPES',
    'create_disturbance_list',
]


def _as_vec(v, dim, name):
    if isinstance(v, (int, float)):
        return np.full(dim, float(v), dtype=np.float32)
    arr = np.asarray(v, dtype=np.float32).ravel()
    if arr.size == 1:
        return np.full(dim, float(arr[0]), dtype=np.float32)
    if arr.size != dim:
        raise ValueError(f'{name} shape should match dim {dim}.')
    return arr


def _uniform(gen, shape, low, high):
    """U[low, high) as ``jax.random.uniform`` maps it: max(low, u*(high-low)+low)."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    low = torch.as_tensor(low, dtype=torch.float32, device=gen.device)
    high = torch.as_tensor(high, dtype=torch.float32, device=gen.device)
    return torch.maximum(low, u * (high - low) + low)


class DisturbanceSpec:
    """Base disturbance: the identity, with an optional mask."""

    #: f32 slots of per-episode state this spec needs.
    state_size = 0
    #: i.i.d. random slots this spec consumes per step.
    noise_size = 0

    def __init__(self, dim: int, mask=None, **kwargs):
        self.dim = dim
        self.mask = None if mask is None else np.asarray(mask, dtype=np.float32)
        if self.mask is not None and self.dim != len(self.mask):
            raise ValueError('mask length must equal the channel dim')

    def _masked(self, noise):
        if self.mask is not None:
            return noise * torch.as_tensor(self.mask, device=noise.device)
        return noise

    def init(self, gen, n):
        return torch.zeros((n, self.state_size), device=gen.device)

    def draw(self, gen, n):
        return torch.zeros((n, self.noise_size), device=gen.device)

    def apply_drawn(self, target, dstate, ctrl_step, t, drawn):
        return target

    def apply(self, target, dstate, ctrl_step, t, gen):
        return self.apply_drawn(target, dstate, ctrl_step, t,
                                self.draw(gen, target.shape[0]))


class _OffsetDisturbance(DisturbanceSpec):
    """Shared init of impulse and step: a fixed or random step offset."""

    state_size = 1

    def init(self, gen, n):
        if self.step_offset is None:
            off = torch.randint(0, self.max_step, (n,), generator=gen,
                                device=gen.device)
        else:
            off = torch.full((n,), int(self.step_offset), device=gen.device)
        return off.to(torch.float32)[:, None]


class ImpulseDisturbance(_OffsetDisturbance):
    """Square/triangle pulse around a (possibly random) step offset."""

    def __init__(self, dim, mask=None, magnitude=1, step_offset=None,
                 duration=1, decay_rate=1, max_step=100, **kwargs):
        super().__init__(dim, mask)
        if duration < 1 or not 0 < decay_rate <= 1:
            raise ValueError('impulse needs duration >= 1 and 0 < decay_rate <= 1')
        self.magnitude = float(magnitude)
        self.step_offset = step_offset
        self.duration = float(duration)
        self.decay_rate = float(decay_rate)
        self.max_step = int(max_step)

    def apply_drawn(self, target, dstate, ctrl_step, t, drawn):
        offset = dstate[:, 0]
        peak_step = torch.floor(offset + self.duration / 2)
        peak_offset = torch.abs(ctrl_step - peak_step)
        decay = torch.where(peak_offset < self.duration / 2,
                            torch.pow(self.decay_rate, peak_offset),
                            torch.zeros_like(peak_offset))
        active = (ctrl_step >= offset).to(torch.float32)
        noise = self.magnitude * decay * active
        return target + self._masked(noise[:, None].expand_as(target))


class StepDisturbance(_OffsetDisturbance):
    """Constant bias after a (possibly random) step offset."""

    def __init__(self, dim, mask=None, magnitude=1, step_offset=None,
                 max_step=100, **kwargs):
        super().__init__(dim, mask)
        self.magnitude = float(magnitude)
        self.step_offset = step_offset
        self.max_step = int(max_step)

    def apply_drawn(self, target, dstate, ctrl_step, t, drawn):
        active = (ctrl_step >= dstate[:, 0]).to(torch.float32)
        noise = self.magnitude * active
        return target + self._masked(noise[:, None].expand_as(target))


class UniformNoise(DisturbanceSpec):
    """i.i.d. U(low, high) noise per step."""

    def __init__(self, dim, mask=None, low=0.0, high=1.0, **kwargs):
        super().__init__(dim, mask)
        self.low = _as_vec(low, dim, 'low')
        self.high = _as_vec(high, dim, 'high')
        self.noise_size = dim

    def draw(self, gen, n):
        return _uniform(gen, (n, self.dim), self.low, self.high)

    def apply_drawn(self, target, dstate, ctrl_step, t, drawn):
        return target + self._masked(drawn)


class WhiteNoise(DisturbanceSpec):
    """i.i.d. N(0, std) noise per step."""

    def __init__(self, dim, mask=None, std=1.0, **kwargs):
        super().__init__(dim, mask)
        self.std = _as_vec(std, dim, 'std')
        self.noise_size = dim

    def draw(self, gen, n):
        z = torch.randn((n, self.dim), generator=gen, device=gen.device)
        return z * torch.as_tensor(self.std, device=gen.device)

    def apply_drawn(self, target, dstate, ctrl_step, t, drawn):
        return target + self._masked(drawn)


class PeriodicNoise(DisturbanceSpec):
    """Sinusoid with a random phase per step (the draw is the phase)."""

    def __init__(self, dim, mask=None, scale=1.0, frequency=1.0, **kwargs):
        super().__init__(dim, mask)
        self.scale = float(scale)
        self.frequency = float(frequency)
        self.noise_size = dim

    def draw(self, gen, n):
        return _uniform(gen, (n, self.dim), -math.pi, math.pi)

    def apply_drawn(self, target, dstate, ctrl_step, t, drawn):
        noise = self.scale * torch.sin(2 * math.pi * self.frequency * t[:, None] + drawn)
        return target + self._masked(noise)


class BrownianNoise(DisturbanceSpec):
    """Random-walk noise: an extension point, not in ``DISTURBANCE_TYPES``
    (the walk state would have to be carried between steps)."""

    def __init__(self, dim, mask=None, std=1.0, **kwargs):
        super().__init__(dim, mask)
        self.std = _as_vec(std, dim, 'std')
        self.state_size = dim
        self.noise_size = dim

    def draw(self, gen, n):
        z = torch.randn((n, self.dim), generator=gen, device=gen.device)
        return z * torch.as_tensor(self.std, device=gen.device)

    def apply_drawn(self, target, dstate, ctrl_step, t, drawn):
        return target + self._masked(dstate + drawn)


class StateDependentDisturbance(DisturbanceSpec):
    """Time/state-varying disturbance such as friction: an extension point."""


class DisturbanceList:
    """Sequential composition of disturbances on one channel."""

    def __init__(self, disturbances: Sequence[DisturbanceSpec]):
        self.disturbances = list(disturbances)
        self.state_size = sum(d.state_size for d in self.disturbances)
        self.noise_size = sum(d.noise_size for d in self.disturbances)

    def init(self, gen, n):
        """(n, state_size): every spec's per-episode parameters, in order."""
        parts = [d.init(gen, n) for d in self.disturbances]
        return torch.cat([torch.zeros((n, 0), device=gen.device)] + parts, dim=1)

    def draw(self, gen, n):
        """(n, noise_size): one step's randomness for every spec, in order."""
        parts = [d.draw(gen, n) for d in self.disturbances if d.noise_size > 0]
        return torch.cat([torch.zeros((n, 0), device=gen.device)] + parts, dim=1)

    def apply_drawn(self, target, dstate, ctrl_step, t, drawn):
        out = target
        s_idx = n_idx = 0
        for d in self.disturbances:
            out = d.apply_drawn(out, dstate[:, s_idx:s_idx + d.state_size],
                                ctrl_step, t, drawn[:, n_idx:n_idx + d.noise_size])
            s_idx += d.state_size
            n_idx += d.noise_size
        return out

    def apply(self, target, dstate, ctrl_step, t, gen):
        return self.apply_drawn(target, dstate, ctrl_step, t,
                                self.draw(gen, target.shape[0]))


DISTURBANCE_TYPES = {
    'impulse': ImpulseDisturbance,
    'step': StepDisturbance,
    'uniform': UniformNoise,
    'white_noise': WhiteNoise,
    'periodic': PeriodicNoise,
}


def create_disturbance_list(disturbance_specs, shared_args, max_step: int
                            ) -> DisturbanceList:
    """A DisturbanceList from config spec dicts. ``shared_args`` carries the
    channel dim; ``max_step`` bounds random step offsets."""
    disturb_list = []
    for disturb in disturbance_specs:
        func = disturb.get('disturbance_func')
        if func not in DISTURBANCE_TYPES:
            raise ValueError(f'[ERROR]: unknown disturbance_func {func!r}.')
        cfg = {k: v for k, v in disturb.items() if k != 'disturbance_func'}
        disturb_list.append(
            DISTURBANCE_TYPES[func](**shared_args, max_step=max_step, **cfg))
    return DisturbanceList(disturb_list)
