"""Running observation and return normalizers, as functional states.

Port of the functional core of ``safe_control_gym_tpu/math/normalization.py``:
``NormalizerState`` with ``rms_init``, ``rms_update`` (Welford's parallel
update over the leading batch axes, with the population variance) and
``rms_normalize``; ``RetState`` with ``ret_init``, ``ret_update`` (the running
discounted return of each env and the statistics of those returns) and
``ret_normalize``. Every function returns a new state and leaves its input
alone, so a rollout can carry the states through its steps on the device.
``count`` is a float32 tensor, as JAX's is.

    state = rms_init((4,), device='cuda')
    state = rms_update(state, obs)          # obs (B, 4)
    obs_n = rms_normalize(state, obs, clip=10.0)

The stateful classes of the reference's API sit on that core:
``RunningMeanStd`` (a Welford tracker on the host), ``BaseNormalizer`` (the
identity, with a read-only flag), ``MeanStdNormalizer`` (observations),
``RewardStdNormalizer`` (rewards by the std of the discounted returns),
``RescaleNormalizer``, ``ImageNormalizer`` and ``ActionUnnormalizer``. They
take and give numpy arrays; their state dicts hold numpy arrays in the JAX
package's layout, so a saved normalizer carries across either way.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from safe_control_gym_tpu_torch.math.rotations import normalize_angle  # noqa: F401 (re-export)

__all__ = ['normalize_angle', 'RunningMeanStd', 'BaseNormalizer', 'MeanStdNormalizer',
           'RewardStdNormalizer', 'RescaleNormalizer', 'ImageNormalizer',
           'ActionUnnormalizer', 'NormalizerState', 'rms_init', 'rms_update',
           'rms_normalize', 'RetState', 'ret_init', 'ret_update', 'ret_normalize']


@dataclass
class NormalizerState:
    """Running mean, variance and count of the observations."""
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor

    def replace(self, **changes) -> 'NormalizerState':
        return dataclasses.replace(self, **changes)


def rms_init(shape, epsilon=1e-4, device='cpu') -> NormalizerState:
    """Mean 0, variance 1 and count ``epsilon``."""
    return NormalizerState(mean=torch.zeros(shape, device=device),
                           var=torch.ones(shape, device=device),
                           count=torch.tensor(epsilon, dtype=torch.float32, device=device))


def rms_update(state: NormalizerState, batch, psum=None) -> NormalizerState:
    """Fold ``batch`` (any leading axes over the state's shape) into the
    running statistics. ``psum``, for a batch sharded over ranks, sums a
    tensor over them (``parallel/sharding.Mesh.psum`` of the batch's axis)
    and has ``n``, the number of shards: the statistics are then the whole
    batch's, in two passes (mean, then the squared deviations)."""
    flat = batch.reshape((-1,) + tuple(state.mean.shape))
    if psum is None:
        batch_mean = flat.mean(dim=0)
        batch_var = flat.var(dim=0, correction=0)
        batch_count = flat.shape[0]
    else:
        batch_count = flat.shape[0] * psum.n
        batch_mean = psum(flat.sum(dim=0)) / batch_count
        batch_var = psum(((flat - batch_mean) ** 2).sum(dim=0)) / batch_count
    delta = batch_mean - state.mean
    tot = state.count + batch_count
    new_mean = state.mean + delta * batch_count / tot
    m_a = state.var * state.count
    m_b = batch_var * batch_count
    m2 = m_a + m_b + delta ** 2 * state.count * batch_count / tot
    return NormalizerState(mean=new_mean, var=m2 / tot, count=tot)


def rms_normalize(state: NormalizerState, x, clip=10.0):
    """``clip((x - mean) / sqrt(var + 1e-8), -clip, clip)``."""
    return torch.clamp((x - state.mean) / torch.sqrt(state.var + 1e-8), -clip, clip)


@dataclass
class RetState:
    """The statistics of the discounted returns, and each env's running return."""
    rms: NormalizerState
    ret: torch.Tensor

    def replace(self, **changes) -> 'RetState':
        return dataclasses.replace(self, **changes)


def ret_init(n_envs: int, epsilon=1e-4, device='cpu') -> RetState:
    return RetState(rms=rms_init((), epsilon, device), ret=torch.zeros(n_envs, device=device))


def ret_update(state: RetState, rewards, dones, gamma: float, psum=None) -> RetState:
    """Discount and add this step's rewards, fold the returns into the
    statistics, and restart the return of every done env (``psum`` as in
    ``rms_update``)."""
    ret = state.ret * gamma + rewards
    rms = rms_update(state.rms, ret, psum)
    return RetState(rms=rms, ret=torch.where(dones, torch.zeros_like(ret), ret))


def ret_normalize(state: RetState, rewards, clip=10.0):
    """``clip(rewards / sqrt(var + 1e-8), -clip, clip)``."""
    return torch.clamp(rewards / torch.sqrt(state.rms.var + 1e-8), -clip, clip)


# ---------------------------------------------------------------------------
# Stateful wrappers (the reference's class API), numpy in and out
# ---------------------------------------------------------------------------

def _f32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


class RunningMeanStd:
    """A Welford tracker of mean and variance on the host (``rms_update``)."""

    def __init__(self, epsilon=1e-4, shape=()):
        self.state = rms_init(shape, epsilon)

    @property
    def mean(self):
        return self.state.mean.numpy()

    @property
    def var(self):
        return self.state.var.numpy()

    def update(self, arr):
        self.state = rms_update(self.state, _f32(arr))


class BaseNormalizer:
    """The identity, with a read-only flag."""

    def __init__(self, read_only=False):
        self.read_only = read_only

    def set_read_only(self):
        self.read_only = True

    def unset_read_only(self):
        self.read_only = False

    def __call__(self, x, *args, **kwargs):
        return x

    def state_dict(self):
        return {}

    def load_state_dict(self, _):
        return


class MeanStdNormalizer(BaseNormalizer):
    """Observations to ``clip((x - mean) / sqrt(var + epsilon))``, the
    statistics updated by every call unless read-only."""

    def __init__(self, shape=(), read_only=False, clip=10.0, epsilon=1e-8):
        super().__init__(read_only)
        self.rms = RunningMeanStd(shape=shape)
        self.clip = clip
        self.epsilon = epsilon

    def __call__(self, x):
        x = np.asarray(x)
        if not self.read_only:
            self.rms.update(x.reshape((-1,) + tuple(self.rms.state.mean.shape)))
        return np.clip((x - self.rms.mean) / np.sqrt(self.rms.var + self.epsilon),
                       -self.clip, self.clip)

    def state_dict(self):
        return {'mean': self.rms.mean, 'var': self.rms.var,
                'count': self.rms.state.count.numpy()}

    def load_state_dict(self, saved):
        self.rms.state = NormalizerState(mean=_f32(saved['mean']), var=_f32(saved['var']),
                                         count=_f32(saved['count']))


class RewardStdNormalizer(BaseNormalizer):
    """Rewards over the std of each env's discounted return (the returns
    restart where an env is done), unless read-only."""

    def __init__(self, gamma=0.99, read_only=False, clip=10.0, epsilon=1e-8):
        super().__init__(read_only)
        self.gamma = gamma
        self.rms = RunningMeanStd(shape=())
        self.clip = clip
        self.epsilon = epsilon
        self.ret = None

    def __call__(self, rews, dones):
        rews = np.atleast_1d(np.asarray(rews, dtype=np.float64))
        dones = np.atleast_1d(np.asarray(dones))
        if self.ret is None:
            self.ret = np.zeros(rews.shape[0])
        if not self.read_only:
            self.ret = self.ret * self.gamma + rews
            self.rms.update(self.ret)
            self.ret[dones.astype(bool)] = 0.0
        return np.clip(rews / np.sqrt(self.rms.var + self.epsilon), -self.clip, self.clip)

    def state_dict(self):
        return {'mean': self.rms.mean, 'var': self.rms.var,
                'count': self.rms.state.count.numpy(), 'ret': self.ret}

    def load_state_dict(self, saved):
        self.rms.state = NormalizerState(mean=_f32(saved['mean']), var=_f32(saved['var']),
                                         count=_f32(saved['count']))
        self.ret = saved.get('ret')


class RescaleNormalizer(BaseNormalizer):
    """Multiplies by a constant."""

    def __init__(self, coef=1.0):
        super().__init__()
        self.coef = coef

    def __call__(self, x):
        return np.asarray(x) * self.coef


class ImageNormalizer(RescaleNormalizer):
    """8-bit pixels to [0, 1]."""

    def __init__(self):
        super().__init__(1.0 / 255)


class ActionUnnormalizer(BaseNormalizer):
    """Actions in [-1, 1] to the Box ``action_space``."""

    def __init__(self, action_space):
        super().__init__()
        self.low = np.asarray(action_space.low)
        self.high = np.asarray(action_space.high)

    def __call__(self, action):
        action = np.clip(np.asarray(action), -1, 1)
        return self.low + (action + 1) * 0.5 * (self.high - self.low)
