"""Episode statistics: returns, lengths and tracked info keys, for one env or a vec env.

Port of ``safe_control_gym_tpu/envs/env_wrappers/record_episode_statistics.py``.
``RecordEpisodeStatistics`` wraps one env and ``VecRecordEpisodeStatistics`` a
``VecEnv``; both keep deques of episode returns and lengths and, through
``add_tracker``, any info key in 'accumulate' (summed over the episode) or
'queue' (its last value) mode. At an episode's end the info gains
``episode = {'r', 'l', ...}`` (and ``'t'``, seconds since the wrapper was
made, for one env). The single-env wrapper sits on ``Wrapper``, a small base
of the port's own: the machines the port runs on need not have gymnasium.
"""

from __future__ import annotations

import time
from collections import deque
from copy import deepcopy

import numpy as np

from safe_control_gym_tpu_torch.envs.env_wrappers.vectorized_env.vec_env import VecEnvWrapper

__all__ = ['Wrapper', 'RecordEpisodeStatistics', 'VecRecordEpisodeStatistics']


class Wrapper:
    """Forwards ``reset``, ``step``, ``close`` and every public attribute to ``env``."""

    def __init__(self, env):
        self.env = env

    def reset(self, **kwargs):
        return self.env.reset(**kwargs)

    def step(self, action):
        return self.env.step(action)

    def close(self):
        return self.env.close()

    def __getattr__(self, name):
        if name.startswith('_'):
            raise AttributeError(name)
        return getattr(self.env, name)


class RecordEpisodeStatistics(Wrapper):
    """Episode length and return of one env."""

    def __init__(self, env, deque_size=None):
        super().__init__(env)
        self.deque_size = deque_size
        self.t0 = time.time()
        self.episode_return = 0.0
        self.episode_length = 0
        self.return_queue = deque(maxlen=deque_size)
        self.length_queue = deque(maxlen=deque_size)
        self.episode_stats = {}

    def add_tracker(self, name, init_value, mode='accumulate'):
        """Track the info key ``name`` over each episode."""
        assert mode in ('accumulate', 'queue')
        self.episode_stats[name] = {'mode': mode, 'init': init_value,
                                    'stat': deepcopy(init_value),
                                    'queue': deque(maxlen=self.deque_size)}

    def reset(self, **kwargs):
        self.episode_return = 0.0
        self.episode_length = 0
        for v in self.episode_stats.values():
            v['stat'] = deepcopy(v['init'])
        return self.env.reset(**kwargs)

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        self.episode_return += reward
        self.episode_length += 1
        for name, v in self.episode_stats.items():
            if name in info:
                if v['mode'] == 'accumulate':
                    v['stat'] += info[name]
                else:
                    v['stat'] = info[name]
        if done:
            episode_info = {'r': self.episode_return, 'l': self.episode_length,
                            't': round(time.time() - self.t0, 6)}
            for name, v in self.episode_stats.items():
                episode_info[name] = deepcopy(v['stat'])
                v['queue'].append(deepcopy(v['stat']))
                v['stat'] = deepcopy(v['init'])
            info['episode'] = episode_info
            self.return_queue.append(self.episode_return)
            self.length_queue.append(self.episode_length)
            self.episode_return = 0.0
            self.episode_length = 0
        return obs, reward, done, info


class VecRecordEpisodeStatistics(VecEnvWrapper):
    """Episode lengths and returns of every env of a ``VecEnv``."""

    def __init__(self, venv, deque_size=None, **kwargs):
        super().__init__(venv, **kwargs)
        self.deque_size = deque_size
        self.episode_return = np.zeros(self.num_envs)
        self.episode_length = np.zeros(self.num_envs, dtype=int)
        self.return_queue = deque(maxlen=deque_size)
        self.length_queue = deque(maxlen=deque_size)
        self.episode_stats = {}

    def add_tracker(self, name, init_value, mode='accumulate'):
        assert mode in ('accumulate', 'queue')
        self.episode_stats[name] = {
            'mode': mode, 'init': init_value,
            'stat': [deepcopy(init_value) for _ in range(self.num_envs)],
            'queue': deque(maxlen=self.deque_size)}

    def reset(self, **kwargs):
        obs = self.venv.reset(**kwargs)
        self.episode_return = np.zeros(self.num_envs)
        self.episode_length = np.zeros(self.num_envs, dtype=int)
        for v in self.episode_stats.values():
            v['stat'] = [deepcopy(v['init']) for _ in range(self.num_envs)]
        return obs

    def step_wait(self):
        obs, reward, done, info = self.venv.step_wait()
        self.episode_return += np.asarray(reward)
        self.episode_length += 1
        for i, inf in enumerate(info):
            for name, v in self.episode_stats.items():
                if name in inf:
                    if v['mode'] == 'accumulate':
                        v['stat'][i] += inf[name]
                    else:
                        v['stat'][i] = inf[name]
            if done[i]:
                episode_info = {'r': self.episode_return[i], 'l': self.episode_length[i]}
                for name, v in self.episode_stats.items():
                    episode_info[name] = deepcopy(v['stat'][i])
                    v['queue'].append(deepcopy(v['stat'][i]))
                    v['stat'][i] = deepcopy(v['init'])
                inf['episode'] = episode_info
                self.return_queue.append(self.episode_return[i])
                self.length_queue.append(self.episode_length[i])
                self.episode_return[i] = 0.0
                self.episode_length[i] = 0
        return obs, reward, done, info
