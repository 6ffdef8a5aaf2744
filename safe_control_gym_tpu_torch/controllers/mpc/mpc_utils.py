"""MPC helpers: the discrete LQR gain, RK4 discretization, state RMSE and the
split of a constraint list.

Port of ``safe_control_gym_tpu/controllers/mpc/mpc_utils.py``.
``rk_discrete`` returns a function of one (x, u) of tensors, composable under
``torch.func``; the Riccati solution is ``math/linalg.py``'s SDA on the
inputs' device, the gain's last solve float64 numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np

from safe_control_gym_tpu_torch.envs.constraints import ConstraintList
from safe_control_gym_tpu_torch.math.linalg import discretize_linear_system, solve_dare

__all__ = ['compute_discrete_lqr_gain_from_cont_linear_system', 'rk_discrete',
           'compute_state_rmse', 'reset_constraints']


def compute_discrete_lqr_gain_from_cont_linear_system(dfdx, dfdu, Q_lqr, R_lqr, dt):
    """The LQR gain, the Euler-discretized system and the DARE's solution
    (numpy: float64 gain, float32 A, B and P). The gain is NEGATIVE
    feedback (u = K x), as the reference's."""
    A, B = discretize_linear_system(dfdx, dfdu, dt)
    P = solve_dare(A, B, Q_lqr, R_lqr)
    A, B, P = (t.cpu().numpy() for t in (A, B, P))
    btp = B.T @ P
    lqr_gain = -np.linalg.solve(np.asarray(R_lqr) + btp @ B, btp @ A)
    return lqr_gain, A, B, P


def rk_discrete(fc: Callable, n: int, m: int, dt: float) -> Callable:
    """RK4 discretization of ``fc(x, u) -> x_dot`` over ``dt``."""
    def rk_dyn(x, u):
        k1 = fc(x, u)
        k2 = fc(x + dt / 2 * k1, u)
        k3 = fc(x + dt / 2 * k2, u)
        k4 = fc(x + dt * k3, u)
        return x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    return rk_dyn


def compute_state_rmse(state_error):
    """Per-state and total RMSE of the rows of ``state_error``."""
    mse = np.mean(np.asarray(state_error) ** 2, axis=0)
    return np.sqrt(mse), np.sqrt(np.sum(mse))


def reset_constraints(constraints) -> Tuple[ConstraintList, List, List]:
    """The list, and its state and input constraints' batched functions;
    combined state-input constraints raise."""
    constraints_list = ConstraintList(constraints)
    if len(constraints_list.input_state_constraints) > 0:
        raise NotImplementedError(
            '[Error] Cannot handle combined state input constraints yet.')
    return (constraints_list, constraints_list.get_state_constraint_symbolic_models(),
            constraints_list.get_input_constraint_symbolic_models())
