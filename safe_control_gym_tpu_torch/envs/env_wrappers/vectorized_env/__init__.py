"""The vectorized envs and their factory.

Port of ``safe_control_gym_tpu/envs/env_wrappers/vectorized_env/__init__.py``.
``make_vec_envs`` builds seeded env thunks and picks the backend:
``TorchVecEnv`` (the batch on the device, one physics launch a step) by
default, ``SubprocVecEnv`` when ``n_processes > 1`` is asked for, else
``DummyVecEnv``. The JAX package's default backend is ``'jax'``, its
``JaxVecEnv``; the port's is ``'torch'``.

    venv = make_vec_envs(partial(make, 'cartpole', device='cuda'), batch_size=4096, seed=0)
"""

from __future__ import annotations

from safe_control_gym_tpu_torch.envs.env_wrappers.vectorized_env.dummy_vec_env import \
    DummyVecEnv
from safe_control_gym_tpu_torch.envs.env_wrappers.vectorized_env.subproc_vec_env import \
    SubprocVecEnv
from safe_control_gym_tpu_torch.envs.env_wrappers.vectorized_env.torch_vec_env import \
    TorchVecEnv
from safe_control_gym_tpu_torch.envs.env_wrappers.vectorized_env.vec_env import (VecEnv,
                                                                                 VecEnvWrapper)

__all__ = ['VecEnv', 'VecEnvWrapper', 'DummyVecEnv', 'SubprocVecEnv', 'TorchVecEnv',
           'EnvThunk', 'make_env_fn', 'make_vec_envs']


class EnvThunk:
    """``env_func(seed=seed + rank, **kwargs)`` (no seed where ``seed`` is None)
    as a picklable callable: ``SubprocVecEnv`` sends it to its workers, which
    call it with ``device='cpu'``."""

    def __init__(self, env_func, seed=None, rank=0):
        self.env_func, self.seed, self.rank = env_func, seed, rank

    def __call__(self, **kwargs):
        if self.seed is not None:
            kwargs = {'seed': self.seed + self.rank, **kwargs}
        return self.env_func(**kwargs)


def make_env_fn(env_func, seed=None, rank=0):
    """The seeded env thunk of env ``rank``."""
    return EnvThunk(env_func, seed, rank)


def make_vec_envs(env_func, env_configs=None, batch_size=1, n_processes=1, seed=None,
                  backend='torch'):
    """A vectorized env of ``batch_size`` envs of ``env_func`` (see the module
    docstring for the backends)."""
    if backend == 'torch':
        return TorchVecEnv(env_func, batch_size, seed=seed or 0)
    env_fns = [make_env_fn(env_func, seed=seed, rank=i) for i in range(batch_size)]
    if n_processes > 1:
        return SubprocVecEnv(env_fns, n_workers=n_processes)
    return DummyVecEnv(env_fns)
