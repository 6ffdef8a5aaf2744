"""CBF utilities: the cartpole's barrier, the linear class-K function, the
grid helper and CBF-NN's replay buffer.

Port of ``safe_control_gym_tpu/safety_filters/cbf/cbf_utils.py``. The
barrier is a function of one state tensor, composable under ``torch.func``.
"""

from __future__ import annotations

import numpy as np
import torch

from safe_control_gym_tpu_torch.controllers.off_policy_utils import (replay_init, replay_push,
                                                                     replay_sample)

__all__ = ['cbf_cartpole', 'linear_function', 'cartesian_product', 'CBFBuffer']


def cbf_cartpole(state_limits, device='cuda'):
    """The ellipsoidal barrier h(x) = 1 - sum_i (x_i / limit_i)^2."""
    limits = torch.tensor(np.asarray(state_limits, dtype=np.float32), device=device)

    def cbf(x):
        return 1.0 - torch.sum((x / limits) ** 2)

    return cbf


def linear_function(slope: float):
    """The linear class-K function alpha(x) = slope x."""
    def linear_func(x):
        return slope * x
    return linear_func


def cartesian_product(*arrays):
    """The rows of the cartesian product of 1-D arrays."""
    la = len(arrays)
    arr = np.empty([len(a) for a in arrays] + [la], dtype=np.result_type(*arrays))
    for i, a in enumerate(np.ix_(*arrays)):
        arr[..., i] = a
    return arr.reshape(-1, la)


class CBFBuffer:
    """CBF-NN's training data (state, act, barrier_dot, barrier_dot_approx)
    in the replay ring on ``device``, sampled from a generator seeded 0."""

    def __init__(self, obs_dim, act_dim, max_size, batch_size=64, device='cuda'):
        self.batch_size = batch_size
        self.state = replay_init({'state': obs_dim, 'act': act_dim, 'barrier_dot': 1,
                                  'barrier_dot_approx': 1}, int(max_size), device)
        self.device = self.state.ptr.device
        self.gen = torch.Generator(device=self.device).manual_seed(0)

    def push(self, batch):
        self.state = replay_push(self.state, {
            k: torch.as_tensor(np.atleast_2d(np.asarray(v, np.float32)), device=self.device)
            for k, v in batch.items()})

    def sample(self, batch_size=None):
        return replay_sample(self.state, self.gen, batch_size or self.batch_size)
