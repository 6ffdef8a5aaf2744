"""The vectorized-env API: ``VecEnv`` and the pass-through ``VecEnvWrapper``.

Port of ``safe_control_gym_tpu/envs/env_wrappers/vectorized_env/vec_env.py``:
the asynchronous protocol (``reset``, ``step_async``, ``step_wait``,
``get_attr``, ``set_attr``, ``env_method``, ``get_images``) that
``DummyVecEnv``, ``SubprocVecEnv`` and ``TorchVecEnv`` implement, and
``render``, every env's frame tiled into one image.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np

from safe_control_gym_tpu_torch.envs.env_wrappers.vectorized_env.vec_env_utils import tile_images

__all__ = ['VecEnv', 'VecEnvWrapper']


class VecEnv(ABC):
    """An abstract asynchronous, vectorized environment."""

    closed = False

    def __init__(self, num_envs, observation_space, action_space):
        self.num_envs = num_envs
        self.observation_space = observation_space
        self.action_space = action_space

    @abstractmethod
    def reset(self):
        raise NotImplementedError

    @abstractmethod
    def step_async(self, actions):
        raise NotImplementedError

    @abstractmethod
    def step_wait(self):
        raise NotImplementedError

    def close_extras(self):
        pass

    def close(self):
        if self.closed:
            return
        self.close_extras()
        self.closed = True

    def step(self, actions):
        """Step all environments synchronously."""
        self.step_async(actions)
        return self.step_wait()

    @abstractmethod
    def get_attr(self, attr_name, indices=None):
        raise NotImplementedError

    @abstractmethod
    def set_attr(self, attr_name, values, indices=None):
        raise NotImplementedError

    @abstractmethod
    def env_method(self, method_name, method_args=None, method_kwargs=None, indices=None):
        raise NotImplementedError

    def get_images(self):
        """One RGB frame (H, W, 3) an env."""
        raise NotImplementedError

    def render(self, mode='rgb_array'):
        """Every env's frame tiled into one image."""
        return tile_images(np.stack(self.get_images()))

    def _get_indices(self, indices):
        if indices is None:
            indices = range(self.num_envs)
        elif isinstance(indices, int):
            indices = [indices]
        return indices

    @property
    def unwrapped(self):
        if isinstance(self, VecEnvWrapper):
            return self.venv.unwrapped
        return self


class VecEnvWrapper(VecEnv):
    """A proxy over a ``VecEnv``."""

    def __init__(self, venv, observation_space=None, action_space=None):
        self.venv = venv
        super().__init__(num_envs=venv.num_envs,
                         observation_space=observation_space or venv.observation_space,
                         action_space=action_space or venv.action_space)

    def step_async(self, actions):
        self.venv.step_async(actions)

    @abstractmethod
    def reset(self):
        raise NotImplementedError

    @abstractmethod
    def step_wait(self):
        raise NotImplementedError

    def close(self):
        return self.venv.close()

    def render(self, mode='rgb_array'):
        return self.venv.render(mode)

    def get_images(self):
        return self.venv.get_images()

    def get_attr(self, attr_name, indices=None):
        return self.venv.get_attr(attr_name, indices)

    def set_attr(self, attr_name, values, indices=None):
        return self.venv.set_attr(attr_name, values, indices)

    def env_method(self, method_name, method_args=None, method_kwargs=None, indices=None):
        return self.venv.env_method(method_name, method_args=method_args,
                                    method_kwargs=method_kwargs, indices=indices)

    def __getattr__(self, name):
        if name.startswith('_'):
            raise AttributeError(name)
        return getattr(self.venv, name)
