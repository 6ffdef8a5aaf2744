"""LQR: the static gain of the prior model linearized at its equilibrium.

Port of ``safe_control_gym_tpu/controllers/lqr/lqr.py``: linearize
``env.symbolic`` at (X_EQ, U_EQ), discretize, solve the DARE (or the CARE)
on the env's device, and act with ``u = -K (obs - x_goal) + u_eq`` on the
host, as the JAX package does with the numpy observations the env returns.

    ctrl = make('lqr', partial(make, 'cartpole', device='cuda', **task_config),
                **algo_config)
"""

from __future__ import annotations

import numpy as np

from safe_control_gym_tpu_torch.controllers.base_controller import BaseController
from safe_control_gym_tpu_torch.controllers.lqr.lqr_utils import (compute_lqr_gain,
                                                                  get_cost_weight_matrix)
from safe_control_gym_tpu_torch.envs.benchmark_env import Task

__all__ = ['LQR']


class LQR(BaseController):
    """Linear quadratic regulator."""

    def __init__(self, env_func, q_lqr: list = None, r_lqr: list = None,
                 discrete_dynamics: bool = True, **kwargs):
        super().__init__(env_func, **kwargs)
        self.env = env_func()
        self.model = self.get_prior(self.env)
        self.discrete_dynamics = discrete_dynamics
        self.Q = get_cost_weight_matrix(q_lqr, self.model.nx)
        self.R = get_cost_weight_matrix(r_lqr, self.model.nu)
        self.gain = compute_lqr_gain(self.model, self.model.X_EQ, self.model.U_EQ,
                                     self.Q, self.R, self.discrete_dynamics)

    def reset(self):
        self.env.reset()

    def select_action(self, obs, info=None):
        step = self.extract_step(info)
        goal = self.env.X_GOAL if self.env.TASK == Task.STABILIZATION else self.env.X_GOAL[step]
        return -self.gain @ (obs - goal) + np.atleast_1d(self.model.U_EQ)
