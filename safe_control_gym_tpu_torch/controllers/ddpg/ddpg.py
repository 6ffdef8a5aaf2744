"""Deep deterministic policy gradient: on-device collects with OU noise, the update, resume.

Port of ``safe_control_gym_tpu/controllers/ddpg/ddpg.py``. The training loop,
ring, evaluation, ``save`` and ``load`` are SAC's
(``off_policy_utils.OffPolicyController``); DDPG explores with its
deterministic tanh actor plus an Ornstein-Uhlenbeck state per env, (N,
act_dim) on the device: each collect step moves it by ``theta (0 - x) dt +
std sqrt(dt) w``, adds it to the action scaled by half the action range,
clips to the box, and zeroes it where an env is done. The step runs in the
warm-up too, where the action is uniform instead. ``std`` comes from the
``random_process`` schedule, advanced by one iteration's env steps at the
start of each iteration (of each K with ``fused_iterations``). The OU state is
saved and restored with the env states.

    ctrl = make('ddpg', partial(make, 'cartpole', device='cuda', **task_config),
                training=True, output_dir='temp/ddpg', seed=0, **algo_config)
    ctrl.reset(); ctrl.learn(); ctrl.run(n_episodes=10)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from safe_control_gym_tpu_torch.controllers.ddpg.ddpg_utils import (DDPGAgent,
                                                                    ddpg_actor_forward,
                                                                    noise_schedule)
from safe_control_gym_tpu_torch.controllers.off_policy_utils import OffPolicyController

__all__ = ['DDPG']


class DDPG(OffPolicyController):
    """Deep deterministic policy gradient."""

    ALGO = 'DDPG'

    def __init__(self, env_func, training=True, checkpoint_path='model_latest.pt',
                 output_dir='temp', seed: int = 0, **kwargs):
        super().__init__(env_func, training=training, checkpoint_path=checkpoint_path,
                         output_dir=output_dir, seed=seed, **kwargs)
        self.agent = DDPGAgent(self.env.observation_space, self.env.action_space,
                               hidden_dim=self.hidden_dim, gamma=self.gamma, tau=self.tau,
                               actor_lr=self.actor_lr, critic_lr=self.critic_lr,
                               activation=getattr(self, 'activation', 'relu'), seed=self.seed,
                               device=self.device)
        self._std_schedule, _, rp = noise_schedule(getattr(self, 'random_process', None))
        self._ou_theta = float(rp.get('theta', 0.15))
        self._ou_dt = float(rp.get('dt', 1e-2))
        # The std of a collect; learn() advances the schedule each iteration.
        self.noise_std = float(self._std_schedule(0))
        self._setup_training()
        self._ou_state = torch.zeros((self.N, self.env.action_space.shape[0]),
                                     device=self.device)

    def _reset_noise(self):
        self._ou_state = torch.zeros_like(self._ou_state)

    def _advance_schedule(self, steps):
        self.noise_std = float(self._std_schedule(steps))

    def _explore(self, obs, random_phase, draws):
        """One OU step (``draws``: ``(uniforms, normals)``, each (N, act_dim)
        or None), then the uniform action in the random phase, else the
        actor's action plus the scaled OU state, clipped to the box."""
        u, w = draws if draws is not None else (None, None)
        shape = self._ou_state.shape
        if w is None:
            w = torch.randn(shape, generator=self.gen, device=self.device)
        ou = self._ou_state
        self._ou_next = (ou + self._ou_theta * (-ou) * self._ou_dt
                         + self.noise_std * math.sqrt(self._ou_dt) * w)
        if random_phase:
            if u is None:
                u = torch.rand(shape, generator=self.gen, device=self.device)
            return self._random_action(u)
        pol = ddpg_actor_forward(self.agent.params['actor'], obs, self.act_low, self.act_high,
                                 self.agent.activation)
        return torch.clamp(pol + self._ou_next * 0.5 * (self.act_high - self.act_low),
                           self.act_low, self.act_high)

    def _after_step(self, out):
        # A finished env's OU state starts from 0.
        self._ou_state = torch.where(out.done[:, None], 0.0, self._ou_next)

    def _deterministic_action(self, obs):
        return ddpg_actor_forward(self.agent.params['actor'], obs, self.act_low, self.act_high,
                                  self.agent.activation)

    def _extra_state(self):
        return {'ou_state': self._ou_state.cpu().numpy()}

    def _restore_extra(self, state):
        if 'ou_state' in state:
            self._ou_state = torch.tensor(np.asarray(state['ou_state'], np.float32),
                                          device=self.device)
