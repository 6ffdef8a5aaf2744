"""Model predictive safety certification (MPSC), the abstract filter.

Port of ``safe_control_gym_tpu/safety_filters/mpsc/mpsc.py``. A tube MPC
(Wabersich and Zeilinger) keeps a nominal trajectory z and inputs v;
``certify_action`` clips the proposed input and solves the tube problem. If
it is infeasible, the filter replays step ``kinf`` of the last feasible plan
with the LQR tube feedback, and after ``horizon - 1`` such steps falls back to
clipped LQR, flagging ``success=False``. The ladder and the per-episode
bookkeeping (``z_prev``, ``v_prev``, ``kinf``, ``results_dict``) run on the
host; the subclass solves on the env's device.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np

from safe_control_gym_tpu_torch.controllers.lqr.lqr_utils import (compute_lqr_gain,
                                                                  get_cost_weight_matrix)
from safe_control_gym_tpu_torch.controllers.mpc.mpc_utils import reset_constraints
from safe_control_gym_tpu_torch.safety_filters.base_safety_filter import BaseSafetyFilter
from safe_control_gym_tpu_torch.safety_filters.mpsc.mpsc_cost_function.one_step_cost import \
    ONE_STEP_COST
from safe_control_gym_tpu_torch.safety_filters.mpsc.mpsc_utils import Cost_Function

__all__ = ['MPSC']


class MPSC(BaseSafetyFilter, ABC):
    """Abstract model predictive safety certification."""

    def __init__(self,
                 env_func,
                 horizon: int = 10,
                 q_lin: list = None,
                 r_lin: list = None,
                 integration_algo: str = 'rk4',
                 warmstart: bool = True,
                 additional_constraints: list = None,
                 use_terminal_set: bool = True,
                 cost_function: Cost_Function = Cost_Function.ONE_STEP_COST,
                 **kwargs):
        self.horizon = int(horizon)
        self.integration_algo = integration_algo
        self.warmstart = warmstart
        self.use_terminal_set = use_terminal_set
        super().__init__(env_func, **kwargs)
        # The JAX package seeds numpy's global stream here and draws the
        # terminal set's samples from it; the port keeps that stream as its
        # own generator.
        self._np_random = np.random.RandomState(self.seed)
        self.env = env_func(normalized_rl_action_space=False)
        self.training_env = env_func(randomized_init=True, init_state=None, cost='quadratic',
                                     normalized_rl_action_space=False)
        self.device = self.env.device
        self.reset()
        self.dt = self.model.dt
        self.Q = get_cost_weight_matrix(q_lin, self.model.nx)
        self.R = get_cost_weight_matrix(r_lin, self.model.nu)
        self.X_EQ = np.zeros(self.model.nx)
        self.U_EQ = np.atleast_1d(np.asarray(self.model.U_EQ))
        self.set_dynamics()
        # Negative feedback: u = K x.
        self.lqr_gain = -compute_lqr_gain(self.model, self.X_EQ, self.U_EQ, self.Q, self.R,
                                          discrete_dynamics=True)
        self.terminal_set = None
        self.additional_constraints = additional_constraints or []
        (self.constraints, self.state_constraints_sym,
         self.input_constraints_sym) = reset_constraints(
            (self.env.constraints.constraints if self.env.constraints else [])
            + self.additional_constraints)
        if cost_function == Cost_Function.ONE_STEP_COST:
            self.cost_function = ONE_STEP_COST()
        else:
            raise NotImplementedError(
                f'The MPSC cost function {cost_function} has not been implemented')

    @abstractmethod
    def set_dynamics(self):
        raise NotImplementedError

    @abstractmethod
    def setup_optimizer(self):
        raise NotImplementedError

    def before_optimization(self, obs):
        return

    @abstractmethod
    def solve_optimization(self, obs, uncertified_action, iteration=None):
        raise NotImplementedError

    def certify_action(self, current_state, uncertified_action, info=None):
        """Algorithm 1 of Wabersich 2019: the tube solve, else the ladder."""
        uncertified_action = np.clip(uncertified_action, self.env.physical_action_bounds[0],
                                     self.env.physical_action_bounds[1])
        self.results_dict['uncertified_action'].append(uncertified_action)
        success = True
        self.before_optimization(current_state)
        iteration = self.extract_step(info)
        action, feasible = self.solve_optimization(current_state, uncertified_action, iteration)
        self.results_dict['feasible'].append(feasible)
        nx = self.model.nx
        in_con = self.constraints.input_constraints[0]
        if feasible:
            self.kinf = 0
            certified_action = action
        else:
            self.kinf += 1
            # U_EQ is added in both integration modes, as in the JAX
            # package: v is a delta input everywhere in the optimizer (the
            # reference adds it in its fallback for LTI only, which commands
            # near-zero thrust on the quadrotors).
            if (self.kinf <= self.horizon - 1 and self.z_prev is not None
                    and self.v_prev is not None):
                action = np.squeeze(
                    np.squeeze(self.v_prev[:, self.kinf]) + np.squeeze(self.U_EQ)
                    + np.squeeze(self.lqr_gain @ (current_state.reshape(nx, 1)
                                                  - self.z_prev[:, self.kinf].reshape(nx, 1))))
                clipped_action = np.clip(action, in_con.lower_bounds, in_con.upper_bounds)
                if np.linalg.norm(clipped_action - action) >= 0.01:
                    success = False
                certified_action = clipped_action
            else:
                action = np.squeeze(self.lqr_gain @ (current_state - self.X_EQ))
                action = action + np.squeeze(self.U_EQ)
                certified_action = np.clip(action, in_con.lower_bounds, in_con.upper_bounds)
                success = False
        certified_action = np.squeeze(np.array(certified_action))
        self.results_dict['kinf'].append(self.kinf)
        self.results_dict['certified_action'].append(certified_action)
        self.results_dict['correction'].append(
            np.linalg.norm(certified_action - uncertified_action))
        return certified_action, success

    def setup_results_dict(self):
        self.results_dict = {'feasible': [], 'kinf': [], 'uncertified_action': [],
                             'certified_action': [], 'correction': []}

    def close(self):
        self.env.close()
        self.training_env.close()

    def reset(self):
        self.model = self.get_prior(self.env, self.prior_info)
        self.env.reset()
        self.training_env.reset()
        self.reset_before_run()

    def reset_before_run(self, obs=None, info=None, env=None):
        self.z_prev = None
        self.v_prev = None
        self.kinf = self.horizon - 1
        self.setup_results_dict()
