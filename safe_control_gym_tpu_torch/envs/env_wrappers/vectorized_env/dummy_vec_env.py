"""Sequential in-process vec env.

Port of ``safe_control_gym_tpu/envs/env_wrappers/vectorized_env/dummy_vec_env.py``:
the envs step one after another in this process; a finished env is reset
at once, its last observation and info stashed in the step's info as
``terminal_observation`` and ``terminal_info``.
"""

from __future__ import annotations

import numpy as np

from safe_control_gym_tpu_torch.envs.env_wrappers.vectorized_env.vec_env import VecEnv

__all__ = ['DummyVecEnv']


class DummyVecEnv(VecEnv):
    """Sequential vectorized environment."""

    def __init__(self, env_fns):
        self.envs = [fn() for fn in env_fns]
        env = self.envs[0]
        super().__init__(len(env_fns), env.observation_space, env.action_space)
        self.actions = None

    def reset(self):
        return np.stack([env.reset()[0] for env in self.envs])

    def step_async(self, actions):
        self.actions = actions

    def step_wait(self):
        obs_list, rew_list, done_list, info_list = [], [], [], []
        for env, action in zip(self.envs, self.actions):
            obs, rew, done, info = env.step(action)
            if done:
                info['terminal_observation'] = obs
                info['terminal_info'] = dict(info)
                obs, _ = env.reset()
            obs_list.append(obs)
            rew_list.append(rew)
            done_list.append(done)
            info_list.append(info)
        return np.stack(obs_list), np.asarray(rew_list), np.asarray(done_list), info_list

    def close_extras(self):
        for env in self.envs:
            env.close()

    def get_images(self):
        return [env.render() for env in self.envs]

    def get_attr(self, attr_name, indices=None):
        return [getattr(self.envs[i], attr_name) for i in self._get_indices(indices)]

    def set_attr(self, attr_name, values, indices=None):
        indices = self._get_indices(indices)
        if not isinstance(values, (list, tuple)):
            values = [values] * len(list(indices))
            indices = self._get_indices(None)
        for i, v in zip(indices, values):
            setattr(self.envs[i], attr_name, v)

    def env_method(self, method_name, method_args=None, method_kwargs=None, indices=None):
        method_args = method_args or []
        method_kwargs = method_kwargs or {}
        return [getattr(self.envs[i], method_name)(*method_args, **method_kwargs)
                for i in self._get_indices(indices)]

    def get_env_random_state(self):
        """Each env's generator states: torch's and numpy's."""
        return [_random_state(env) for env in self.envs]

    def set_env_random_state(self, worker_random_states):
        for env, s in zip(self.envs, worker_random_states):
            _set_random_state(env, s)


def _random_state(env):
    return {'torch': env.generator.get_state(), 'numpy': env.np_random.bit_generator.state}


def _set_random_state(env, state):
    env.generator.set_state(state['torch'])
    env.np_random.bit_generator.state = state['numpy']
