"""TorchVecEnv: N envs as one batch on the device, a step one batched call.

The port's counterpart of ``JaxVecEnv``
(``safe_control_gym_tpu/envs/env_wrappers/vectorized_env/jax_vec_env.py``).
Where the JAX package vmaps the one-env step, the port's ``FuncEnv`` takes the
batch: ``reset`` is one ``reset_batch`` and ``step`` one ``step_autoreset``,
so the physics of all N envs is one K1, K2 or K3 launch a step on the card.
A finished env starts afresh in the same call, and its info carries the
terminal stash (``terminal_observation``, ``terminal_info``) and
``TimeLimit.truncated`` where the time limit ended it. The numpy results and
the infos of a step are built from one host copy of its outputs.

Randomness comes from one ``torch.Generator`` on the env's device, seeded
with ``seed``, in place of the JAX package's split PRNG keys.

    venv = TorchVecEnv(partial(make, 'cartpole', device='cuda'), 4096, seed=0)
    obs = venv.reset()
    obs, rew, done, infos = venv.step(actions)
"""

from __future__ import annotations

import torch

from safe_control_gym_tpu_torch.envs.env_wrappers.vectorized_env.vec_env import VecEnv

__all__ = ['TorchVecEnv']


class TorchVecEnv(VecEnv):
    """N functional envs as one device-resident batch."""

    def __init__(self, env_fn, n_envs: int, seed: int = 0):
        self.template = env_fn()
        self.func = self.template.func
        super().__init__(int(n_envs), self.template.observation_space,
                         self.template.action_space)
        self.device = self.template.device
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self._states = None
        self.actions = None

    def reset(self):
        self._states, obs = self.func.reset_batch(self.gen, self.num_envs)
        return obs.cpu().numpy()

    def step_async(self, actions):
        self.actions = torch.as_tensor(actions, dtype=torch.float32, device=self.device)

    def step_wait(self):
        counter = self._states.ctrl_step + 1
        self._states, out, obs = self.func.step_autoreset(self._states, self.actions, self.gen)
        n, d = self.num_envs, obs.shape[1]
        cols = [obs, out.obs, out.reward[:, None], out.done[:, None], out.truncated[:, None],
                out.mse[:, None], out.constraint_violation[:, None], counter[:, None],
                out.constraint_values]
        host = torch.cat([c.to(torch.float32).reshape(n, -1) for c in cols], 1).cpu().numpy()
        next_obs, last_obs = host[:, :d], host[:, d:2 * d]
        reward = host[:, 2 * d]
        done = host[:, 2 * d + 1] > 0
        truncated = host[:, 2 * d + 2] > 0
        mse, violation, step = host[:, 2 * d + 3], host[:, 2 * d + 4], host[:, 2 * d + 5]
        c_values = host[:, 2 * d + 6:]
        with_constraints = bool(self.func.n_constraints)
        infos = []
        for i in range(n):
            info = {'current_step': int(step[i]), 'mse': float(mse[i]),
                    'constraint_violation': int(violation[i])}
            if with_constraints:
                info['constraint_values'] = c_values[i]
            if truncated[i]:
                info['TimeLimit.truncated'] = True
            if done[i]:
                info['terminal_observation'] = last_obs[i]
                info['terminal_info'] = dict(info)
            infos.append(info)
        return next_obs, reward, done, infos

    def get_attr(self, attr_name, indices=None):
        return [getattr(self.template, attr_name) for _ in self._get_indices(indices)]

    def set_attr(self, attr_name, values, indices=None):
        setattr(self.template, attr_name, values)

    def env_method(self, method_name, method_args=None, method_kwargs=None, indices=None):
        fn = getattr(self.template, method_name)
        return [fn(*(method_args or []), **(method_kwargs or {}))
                for _ in self._get_indices(indices)]

    def get_images(self):
        """Each env's frame, drawn by the template env from the batch's states
        (read to the host in one copy)."""
        saved = self.template.state
        frames = []
        for state in self._states.state.cpu().numpy():
            self.template.state = state
            frames.append(self.template.render())
        self.template.state = saved
        return frames

    def close_extras(self):
        self.template.close()

    def get_env_random_state(self):
        return [self.gen.get_state()]

    def set_env_random_state(self, states):
        self.gen.set_state(states[0])
