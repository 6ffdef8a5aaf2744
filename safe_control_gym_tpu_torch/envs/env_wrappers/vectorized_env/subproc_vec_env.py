"""Subprocess vec env: the envs split over worker processes that answer over pipes.

Port of ``safe_control_gym_tpu/envs/env_wrappers/vectorized_env/subproc_vec_env.py``.
``n_workers`` spawn-context processes each own ``num_envs / n_workers`` envs
and serve the commands step, reset, get_attr, set_attr, env_method and the
random states; a finished env is reset in its worker with the terminal
stash. Two departures from the JAX package:

* the workers receive plain-pickled env thunks (``make_env_fn`` gives a
  picklable one over a ``functools.partial`` of ``make``): the machines the
  port runs on need not have cloudpickle;
* each worker builds its envs on the CPU (``device='cpu'``), as the JAX
  package's workers force JAX onto the CPU: a worker is a host-bound path
  and must not take the card. The batched path on the card is
  ``TorchVecEnv``.
"""

from __future__ import annotations

import multiprocessing as mp

import numpy as np

from safe_control_gym_tpu_torch.envs.env_wrappers.vectorized_env.dummy_vec_env import (
    _random_state, _set_random_state)
from safe_control_gym_tpu_torch.envs.env_wrappers.vectorized_env.vec_env import VecEnv

__all__ = ['SubprocVecEnv']


def _worker(remote, parent_remote, env_fns):
    parent_remote.close()
    envs = [fn(device='cpu') for fn in env_fns]
    try:
        while True:
            cmd, data = remote.recv()
            if cmd == 'step':
                results = []
                for env, action in zip(envs, data):
                    obs, rew, done, info = env.step(action)
                    if done:
                        info['terminal_observation'] = obs
                        info['terminal_info'] = dict(info)
                        obs, _ = env.reset()
                    results.append((obs, rew, done, info))
                remote.send(results)
            elif cmd == 'reset':
                remote.send([env.reset()[0] for env in envs])
            elif cmd == 'close':
                remote.close()
                break
            elif cmd == 'get_spaces_spec':
                remote.send((envs[0].observation_space, envs[0].action_space))
            elif cmd == 'get_attr':
                remote.send([getattr(env, data) for env in envs])
            elif cmd == 'set_attr':
                name, value = data
                for env in envs:
                    setattr(env, name, value)
                remote.send(None)
            elif cmd == 'env_method':
                name, args, kwargs = data
                remote.send([getattr(env, name)(*args, **kwargs) for env in envs])
            elif cmd == 'get_random_state':
                remote.send([_random_state(env) for env in envs])
            elif cmd == 'set_random_state':
                for env, s in zip(envs, data):
                    _set_random_state(env, s)
                remote.send(None)
            else:
                raise NotImplementedError(f'Unknown command {cmd}')
    except KeyboardInterrupt:
        pass
    finally:
        for env in envs:
            env.close()


class SubprocVecEnv(VecEnv):
    """Multiprocess vectorized environment."""

    def __init__(self, env_fns, n_workers: int = 2, context: str = 'spawn'):
        self.waiting = False
        self.closed = False
        n_envs = len(env_fns)
        if n_envs % n_workers != 0:
            raise ValueError('Number of envs must be divisible by number of workers.')
        per = n_envs // n_workers
        chunks = [list(env_fns[i * per:(i + 1) * per]) for i in range(n_workers)]
        ctx = mp.get_context(context)
        self.remotes, self.work_remotes = zip(*[ctx.Pipe() for _ in range(n_workers)])
        self.ps = []
        for work_remote, remote, fns in zip(self.work_remotes, self.remotes, chunks):
            p = ctx.Process(target=_worker, args=(work_remote, remote, fns), daemon=True)
            p.start()
            self.ps.append(p)
        for remote in self.work_remotes:
            remote.close()
        self.n_workers = n_workers
        self.envs_per_worker = per
        self.remotes[0].send(('get_spaces_spec', None))
        observation_space, action_space = self.remotes[0].recv()
        super().__init__(n_envs, observation_space, action_space)

    def step_async(self, actions):
        assert not self.waiting
        actions = np.asarray(actions)
        for i, remote in enumerate(self.remotes):
            remote.send(('step', actions[i * self.envs_per_worker:
                                         (i + 1) * self.envs_per_worker]))
        self.waiting = True

    def step_wait(self):
        assert self.waiting
        results = []
        for remote in self.remotes:
            results.extend(remote.recv())
        self.waiting = False
        obs, rews, dones, infos = zip(*results)
        return np.stack(obs), np.asarray(rews), np.asarray(dones), list(infos)

    def reset(self):
        for remote in self.remotes:
            remote.send(('reset', None))
        obs = []
        for remote in self.remotes:
            obs.extend(remote.recv())
        return np.stack(obs)

    def close_extras(self):
        if self.waiting:
            for remote in self.remotes:
                remote.recv()
        for remote in self.remotes:
            remote.send(('close', None))
        for p in self.ps:
            p.join()

    def _dispatch(self, cmd, data=None):
        for remote in self.remotes:
            remote.send((cmd, data))
        out = []
        for remote in self.remotes:
            r = remote.recv()
            if isinstance(r, list):
                out.extend(r)
            else:
                out.append(r)
        return out

    def get_attr(self, attr_name, indices=None):
        return self._dispatch('get_attr', attr_name)

    def set_attr(self, attr_name, values, indices=None):
        return self._dispatch('set_attr', (attr_name, values))

    def env_method(self, method_name, method_args=None, method_kwargs=None, indices=None):
        return self._dispatch('env_method', (method_name, method_args or [],
                                             method_kwargs or {}))

    def get_images(self):
        return self._dispatch('env_method', ('render', [], {}))

    def get_env_random_state(self):
        return self._dispatch('get_random_state')

    def set_env_random_state(self, worker_random_states):
        per = self.envs_per_worker
        for i, remote in enumerate(self.remotes):
            remote.send(('set_random_state', list(worker_random_states[i * per:(i + 1) * per])))
        for remote in self.remotes:
            remote.recv()
