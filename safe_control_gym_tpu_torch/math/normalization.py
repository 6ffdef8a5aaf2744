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
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ['NormalizerState', 'rms_init', 'rms_update', 'rms_normalize',
           'RetState', 'ret_init', 'ret_update', 'ret_normalize']


@dataclass
class NormalizerState:
    """Running mean, variance and count of the observations."""
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor


def rms_init(shape, epsilon=1e-4, device='cpu') -> NormalizerState:
    """Mean 0, variance 1 and count ``epsilon``."""
    return NormalizerState(mean=torch.zeros(shape, device=device),
                           var=torch.ones(shape, device=device),
                           count=torch.tensor(epsilon, dtype=torch.float32, device=device))


def rms_update(state: NormalizerState, batch) -> NormalizerState:
    """Fold ``batch`` (any leading axes over the state's shape) into the
    running statistics."""
    flat = batch.reshape((-1,) + tuple(state.mean.shape))
    batch_mean = flat.mean(dim=0)
    batch_var = flat.var(dim=0, correction=0)
    batch_count = flat.shape[0]
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


def ret_init(n_envs: int, epsilon=1e-4, device='cpu') -> RetState:
    return RetState(rms=rms_init((), epsilon, device), ret=torch.zeros(n_envs, device=device))


def ret_update(state: RetState, rewards, dones, gamma: float) -> RetState:
    """Discount and add this step's rewards, fold the returns into the
    statistics, and restart the return of every done env."""
    ret = state.ret * gamma + rewards
    rms = rms_update(state.rms, ret)
    return RetState(rms=rms, ret=torch.where(dones, torch.zeros_like(ret), ret))


def ret_normalize(state: RetState, rewards, clip=10.0):
    """``clip(rewards / sqrt(var + 1e-8), -clip, clip)``."""
    return torch.clamp(rewards / torch.sqrt(state.rms.var + 1e-8), -clip, clip)
